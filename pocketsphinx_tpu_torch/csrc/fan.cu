// Word-final right-context fan step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// pocketsphinx_tpu/ops/pallas_fan.py (called through `fan_step`), the
// finals block of the fused n-gram scan (search/ngram_fused.py).
//
// For every batch element b and multi-phone word w < Wm, over every
// right-context plane rc:
//   sen_j   = -pre[b, j, rc, lp[w]]           (per-final-diphone costs)
//   s_j     = (S[b, j, rc, w] - mprev[b]) + sen_j
//             (the previous frame's renormalization, deferred by the scan
//             to this load, then the emission on the source)
//   exit    = max(s1 + tp[1->3], s2 + tp[2->3]) with ties to state 1
//   state 2 = best of from(1) > self > skip(0); state 1 = from(0) > self;
//   state 0 = self loop, then the chain-last entry pred[b, w] merged in
//             on a strict '>' (ops/hmm.py hmm_step_sm tie rules)
// and writes the exit plane out_f[b, rc, w] (a strided view: the scan
// hands it the first Wm columns of its [B, NRC, W] exit planes), the
// per-word exit (the first maximal rc with its TF/CX payload), and per
// block the max of the new S over its real words (the scan's
// renormalization folds these partial maxima into its max).
//
// Layout: the fan carry S/TF/CX [B, 3, NRC, Wp] is padded to Wp, a
// multiple of 4 columns, as are lp [Wp] and tp [12, Wp]; pred/ptf/pcx
// and the exits are [B, Wm].  The pads of the new carry are written as
// NEG_INF scores and 0 payloads and reach no other output.
//
// What bounds it on an H100: bytes.  Each launch reads and writes the
// S/TF/CX planes (9 planes of [NRC, Wm] words per batch element) and
// writes out_f: 19 words per (b, rc, w), about 500 MB at B = 8, NRC = 41,
// Wm = 20,035, so at least about 0.15 ms at 3.35 TB/s.  The arithmetic is
// a dozen adds and compares per element, far below the float32 rate.
//
// What the design does about it:
//   * 16-byte accesses: a thread owns 4 adjacent words and moves S/TF/CX
//     in and out as float4/int4 (the padding makes every plane row
//     16-byte aligned), and reads its tp and lp columns the same way;
//   * more bytes in flight: the NRC planes are split among G groups of
//     threads of a block, each walking a contiguous range of rc, so a
//     grid of (Wp / (4 * 256 / G)) x B blocks of 256 threads has G times
//     the threads of one walker per word; the groups' exits are combined
//     in shared memory in rc order, so the first maximal rc still wins;
//     the wrapper picks G (1, 2 or 4) so that the grid fills the card;
//   * the diphone costs in shared memory: for each step, every group's
//     rows pre[b, 0:3, rc, 0:LP] are copied into shared memory with
//     cp.async, double-buffered, while the step's planes are in flight;
//     each word then reads its cost there (a scattered gather through
//     L1 otherwise);
//   * registers: a thread keeps its words' tp columns, chain-last
//     entries and running exits in registers (about 165: one block of
//     256 threads per SM); capped at 128 for two blocks per SM it spilled
//     and ran slower;
//   * no passes around the kernel: the exit plane is written into the
//     scan's exit buffer, the renormalization's max is reduced here, and
//     its subtraction is applied here on the next frame's load (mprev),
//     one add per loaded score instead of a pass over the carry.
//
// Exactness: only adds, negations, compares and selects, in the order of
// the reference; built with --fmad=false.  Max is exact in any order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;            // threads per block
constexpr float NEG_INF = -1e30f;   // a dead score (ops/hmm.py NEG_INF)
// tp rows read per word: tp[j * 4 + k] = tp[j -> k]
constexpr int TP00 = 0, TP01 = 1, TP02 = 2, TP11 = 3, TP12 = 4, TP13 = 5,
              TP22 = 6, TP23 = 7;
__constant__ int TP_ROW[8] = {0, 1, 2, 5, 6, 7, 10, 11};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group but the newest one has landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void unpack(const float4 v, float* x) {
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void unpack(const int4 v, int32_t* x) {
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

template <int G>
__global__ void __launch_bounds__(TPB)
fan_kernel(const float* __restrict__ S, const int32_t* __restrict__ TF,
           const int32_t* __restrict__ CX, const float* __restrict__ mprev,
           const float* __restrict__ pred,
           const int32_t* __restrict__ ptf, const int32_t* __restrict__ pcx,
           const float* __restrict__ pre, const int32_t* __restrict__ lp,
           const float* __restrict__ tp, float* __restrict__ nS,
           int32_t* __restrict__ nTF, int32_t* __restrict__ nCX,
           float* __restrict__ outf, long long ob, long long orc,
           float* __restrict__ esc, int32_t* __restrict__ etf,
           int32_t* __restrict__ ecx, float* __restrict__ mx, int NRC,
           int Wm, int Wp, int LP) {
  constexpr int TW = TPB / G;      // threads across a block's words
  constexpr int WB = 4 * TW;       // words per block
  // [2][G][3][LP] diphone costs; after the walk, the groups' exits
  extern __shared__ __align__(16) float smem[];
  __shared__ float wmax[TPB / 32];

  const int tx = threadIdx.x % TW, g = threadIdx.x / TW;
  const int b = blockIdx.y;
  const float mp = mprev[b];
  const int w0 = blockIdx.x * WB + 4 * tx;     // this thread's 4 words
  const bool live = w0 < Wp;
  const int r0 = g * NRC / G, r1 = (g + 1) * NRC / G;   // group's planes
  const int steps = (NRC + G - 1) / G;

  float tq[8][4];
  int32_t lpw[4];
  float pw[4];
  int32_t ptfw[4], pcxw[4];
  bool real[4];
  if (live) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
      unpack(*reinterpret_cast<const float4*>(tp + (size_t)TP_ROW[r] * Wp
                                              + w0), tq[r]);
    unpack(*reinterpret_cast<const int4*>(lp + w0), lpw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      real[k] = w0 + k < Wm;
      lpw[k] = real[k] ? lpw[k] : 0;            // a pad's lp is not read
      const size_t i = (size_t)b * Wm + w0 + k;
      pw[k] = real[k] ? pred[i] : NEG_INF;
      ptfw[k] = real[k] ? ptf[i] : 0;
      pcxw[k] = real[k] ? pcx[i] : 0;
    }
  }

  const size_t plane = (size_t)NRC * Wp;            // one state's [NRC, Wp]
  const size_t base = (size_t)b * 3 * plane + w0;
  const float* preb = pre + (size_t)b * 3 * NRC * LP;
  // copy step i's rows of this group into buffer s; one commit group
  auto stage = [&](int i, int s) {
    const int rc = r0 + i;
    if (rc < r1) {
      float* dst = smem + (size_t)(s * G + g) * 3 * LP;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float* src = preb + ((size_t)j * NRC + rc) * LP;
        for (int l = tx; l < LP; l += TW)
          cp_async4(dst + j * LP + l, src + l);
      }
    }
    cp_async_commit();
  };

  float best[4] = {0.f, 0.f, 0.f, 0.f};
  int32_t btf[4] = {0, 0, 0, 0}, bcx[4] = {0, 0, 0, 0};
  float m = -INFINITY;                              // max of the new S
  stage(0, 0);
  for (int i = 0; i < steps; ++i) {
    const int rc = r0 + i;
    const bool on = live && rc < r1;
    const size_t i0 = base + (size_t)rc * Wp, i1 = i0 + plane,
                 i2 = i1 + plane;
    float4 s4[3];
    int4 f4[3], c4[3];
    if (on) {                   // the step's planes go out before the wait
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        s4[j] = *reinterpret_cast<const float4*>(S + i0 + j * plane);
        f4[j] = *reinterpret_cast<const int4*>(TF + i0 + j * plane);
        c4[j] = *reinterpret_cast<const int4*>(CX + i0 + j * plane);
      }
    }
    if (i + 1 < steps)
      stage(i + 1, (i + 1) & 1);
    else
      cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (on) {
      const float* cost = smem + (size_t)((i & 1) * G + g) * 3 * LP;
      float S0[4], S1[4], S2[4];
      int32_t m0tf[4], m1tf[4], m2tf[4], m0cx[4], m1cx[4], m2cx[4];
      unpack(s4[0], S0); unpack(s4[1], S1); unpack(s4[2], S2);
#pragma unroll
      for (int k = 0; k < 4; ++k) {       // the deferred renormalization
        S0[k] = S0[k] - mp;
        S1[k] = S1[k] - mp;
        S2[k] = S2[k] - mp;
      }
      unpack(f4[0], m0tf); unpack(f4[1], m1tf); unpack(f4[2], m2tf);
      unpack(c4[0], m0cx); unpack(c4[1], m1cx); unpack(c4[2], m2cx);
      float o0[4], o1[4], o2[4];
      int32_t t0[4], t1[4], t2[4], x0[4], x1[4], x2[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = lpw[k];
        const float s0 = S0[k] + (-cost[l]);
        const float s1 = S1[k] + (-cost[LP + l]);
        const float s2 = S2[k] + (-cost[2 * LP + l]);

        // non-emitting exit from pre-update values (priority 1 over 2)
        const float lo = s1 + tq[TP13][k];
        const float hi = s2 + tq[TP23][k];
        const bool hi_wins = hi > lo;
        const float out = hi_wins ? hi : lo;
        const int32_t otf = hi_wins ? m2tf[k] : m1tf[k];
        const int32_t ocx = hi_wins ? m2cx[k] : m1cx[k];

        // state 2: from(1) > self > skip(0)
        const float prev2 = s1 + tq[TP12][k];
        const float self2 = s2 + tq[TP22][k];
        const float skip2 = s0 + tq[TP02][k];
        const bool take_self2 = self2 > prev2;
        const float best2 = take_self2 ? self2 : prev2;
        const bool take_skip2 = skip2 > best2;
        const float n2 = take_skip2 ? skip2 : best2;
        const int32_t n2tf = take_skip2 ? m0tf[k]
                                        : (take_self2 ? m2tf[k] : m1tf[k]);
        const int32_t n2cx = take_skip2 ? m0cx[k]
                                        : (take_self2 ? m2cx[k] : m1cx[k]);

        // state 1: from(0) > self
        const float prev1 = s0 + tq[TP01][k];
        const float self1 = s1 + tq[TP11][k];
        const bool take_self1 = self1 > prev1;
        const float n1 = take_self1 ? self1 : prev1;
        const int32_t n1tf = take_self1 ? m1tf[k] : m0tf[k];
        const int32_t n1cx = take_self1 ? m1cx[k] : m0cx[k];

        // state 0: self loop, then the chain-last entry (strict >)
        float n0 = s0 + tq[TP00][k];
        const bool win = pw[k] > n0;
        n0 = win ? pw[k] : n0;
        const int32_t n0tf = win ? ptfw[k] : m0tf[k];
        const int32_t n0cx = win ? pcxw[k] : m0cx[k];

        if (real[k]) {
          outf[(size_t)b * ob + (size_t)rc * orc + w0 + k] = out;
          m = n0 > m ? n0 : m;
          m = n1 > m ? n1 : m;
          m = n2 > m ? n2 : m;
          if (i == 0 || out > best[k]) {   // first maximal rc
            best[k] = out;
            btf[k] = otf;
            bcx[k] = ocx;
          }
        }
        o0[k] = real[k] ? n0 : NEG_INF;
        o1[k] = real[k] ? n1 : NEG_INF;
        o2[k] = real[k] ? n2 : NEG_INF;
        t0[k] = real[k] ? n0tf : 0;
        t1[k] = real[k] ? n1tf : 0;
        t2[k] = real[k] ? n2tf : 0;
        x0[k] = real[k] ? n0cx : 0;
        x1[k] = real[k] ? n1cx : 0;
        x2[k] = real[k] ? n2cx : 0;
      }
      *reinterpret_cast<float4*>(nS + i0) =
          make_float4(o0[0], o0[1], o0[2], o0[3]);
      *reinterpret_cast<float4*>(nS + i1) =
          make_float4(o1[0], o1[1], o1[2], o1[3]);
      *reinterpret_cast<float4*>(nS + i2) =
          make_float4(o2[0], o2[1], o2[2], o2[3]);
      *reinterpret_cast<int4*>(nTF + i0) =
          make_int4(t0[0], t0[1], t0[2], t0[3]);
      *reinterpret_cast<int4*>(nTF + i1) =
          make_int4(t1[0], t1[1], t1[2], t1[3]);
      *reinterpret_cast<int4*>(nTF + i2) =
          make_int4(t2[0], t2[1], t2[2], t2[3]);
      *reinterpret_cast<int4*>(nCX + i0) =
          make_int4(x0[0], x0[1], x0[2], x0[3]);
      *reinterpret_cast<int4*>(nCX + i1) =
          make_int4(x1[0], x1[1], x1[2], x1[3]);
      *reinterpret_cast<int4*>(nCX + i2) =
          make_int4(x2[0], x2[1], x2[2], x2[3]);
    }
    __syncthreads();            // buffer i & 1 is refilled at step i + 2
  }

  // the groups' exits side by side, then combined in rc order
  float* xs = smem;                                       // [G][WB]
  int32_t* xt = reinterpret_cast<int32_t*>(smem + G * WB);
  int32_t* xc = xt + G * WB;
  if (live) {
    const int c = g * WB + 4 * tx;
    *reinterpret_cast<float4*>(xs + c) =
        make_float4(best[0], best[1], best[2], best[3]);
    *reinterpret_cast<int4*>(xt + c) =
        make_int4(btf[0], btf[1], btf[2], btf[3]);
    *reinterpret_cast<int4*>(xc + c) =
        make_int4(bcx[0], bcx[1], bcx[2], bcx[3]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, m, o);
    m = v > m ? v : m;
  }
  if (threadIdx.x % 32 == 0) wmax[threadIdx.x / 32] = m;
  __syncthreads();
  for (int i = threadIdx.x; i < WB; i += TPB) {
    const int w = blockIdx.x * WB + i;
    if (w >= Wm) break;
    bool have = false;
    float bs = 0.f;
    int32_t bt = 0, bc = 0;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      if ((gg + 1) * NRC / G == gg * NRC / G) continue;   // no planes
      const float v = xs[gg * WB + i];
      if (!have || v > bs) {
        bs = v;
        bt = xt[gg * WB + i];
        bc = xc[gg * WB + i];
        have = true;
      }
    }
    const size_t o = (size_t)b * Wm + w;
    esc[o] = bs;
    etf[o] = bt;
    ecx[o] = bc;
  }
  if (threadIdx.x == 0) {
    float v = wmax[0];
#pragma unroll
    for (int k = 1; k < TPB / 32; ++k) v = wmax[k] > v ? wmax[k] : v;
    mx[(size_t)b * gridDim.x + blockIdx.x] = v;
  }
}

// the dynamic shared memory a block of kernel<G> takes
size_t smem_bytes(int G, int LP) {
  const size_t stage = (size_t)2 * G * 3 * LP * sizeof(float);
  const size_t exits = (size_t)3 * 4 * TPB * sizeof(float);
  return stage > exits ? stage : exits;
}

template <int G>
int launch(const void* S, const void* TF, const void* CX, const void* mprev,
           const void* pred, const void* ptf, const void* pcx,
           const void* pre, const void* lp, const void* tp, void* nS,
           void* nTF, void* nCX, void* outf,
           long long ob, long long orc, void* esc, void* etf, void* ecx,
           void* mx, int B, int NRC, int Wm, int Wp, int LP,
           cudaStream_t stream) {
  // shared memory above 48 KB is an opt-in, once per card
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !opted[dev]) {
    int most = 0;
    cudaFuncAttributes fa;
    cudaError_t err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fan_kernel<G>);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fan_kernel<G>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most - (int)fa.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = true;
  }
  constexpr int WB = 4 * (TPB / G);
  dim3 grid((Wp + WB - 1) / WB, B);
  fan_kernel<G><<<grid, TPB, smem_bytes(G, LP), stream>>>(
      (const float*)S, (const int32_t*)TF, (const int32_t*)CX,
      (const float*)mprev, (const float*)pred, (const int32_t*)ptf,
      (const int32_t*)pcx, (const float*)pre, (const int32_t*)lp,
      (const float*)tp, (float*)nS,
      (int32_t*)nTF, (int32_t*)nCX, (float*)outf, ob, orc, (float*)esc,
      (int32_t*)etf, (int32_t*)ecx, (float*)mx, NRC, Wm, Wp, LP);
  return (int)cudaGetLastError();
}

}  // namespace

// One fan step on `stream`.  `groups` (1, 2 or 4) splits the planes
// of a block; mx receives [B, ceil(Wp / (1024 / groups))] partial maxima.
// mprev: [B] offsets to subtract from S as it is loaded (zeros for none).
extern "C" int fan_step_launch(const void* S, const void* TF, const void* CX,
                               const void* mprev, const void* pred,
                               const void* ptf, const void* pcx,
                               const void* pre, const void* lp,
                               const void* tp, void* nS,
                               void* nTF, void* nCX, void* outf, void* esc,
                               void* etf, void* ecx, void* mx, long long ob,
                               long long orc, int B, int NRC, int Wm, int Wp,
                               int LP, int groups, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define FAN_LAUNCH(G)                                                       \
  return launch<G>(S, TF, CX, mprev, pred, ptf, pcx, pre, lp, tp, nS, nTF, \
                   nCX, outf, ob, orc, esc, etf, ecx, mx, B, NRC, Wm, Wp,  \
                   LP, st)
  switch (groups) {
    case 1: FAN_LAUNCH(1);
    case 2: FAN_LAUNCH(2);
    case 4: FAN_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FAN_LAUNCH
}

extern "C" const char* fan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
