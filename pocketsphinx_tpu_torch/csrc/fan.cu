// Word-final right-context fan step for Hopper (sm_90a), for HMMs of
// NST = 3 or 5 emitting states.
//
// Replaces the Pallas TPU kernel `_kernel` of
// pocketsphinx_tpu/ops/pallas_fan.py (called through `fan_step`), the
// finals block of the fused n-gram scan (search/ngram_fused.py); the JAX
// package runs its Pallas kernel at 3 states and the same block as XLA
// ops at 5, which this kernel also takes.
//
// For every batch element b and multi-phone word w < Wm, over every
// right-context plane rc:
//   sen_j   = -pre[b, j, rc, lp[w]]           (per-final-diphone costs)
//   s_j     = (S[b, j, rc, w] - mprev[b]) + sen_j
//             (the previous frame's renormalization, deferred by the scan
//             to this load, then the emission on the source)
//   exit    = max(s_{N-2} + tp[N-2->N], s_{N-1} + tp[N-1->N]) with ties
//             to state N-2 (N = NST)
//   state j >= 2 = best of from(j-1) > self > skip(j-2);
//   state 1 = from(0) > self;
//   state 0 = self loop, then the chain-last entry pred[b, w] merged in
//             on a strict '>' (ops/hmm.py hmm_step_sm tie rules)
// and writes the exit plane out_f[b, rc, w] (a strided view: the scan
// hands it the first Wm columns of its [B, NRC, W] exit planes), the
// per-word exit (the first maximal rc with its TF/CX payload), and per
// block the max of the new S over its real words (the scan's
// renormalization folds these partial maxima into its max).
//
// Layout: the fan carry S/TF/CX [B, NST, NRC, Wp] is padded to Wp, a
// multiple of 4 columns, as are lp [Wp] and tp [NST (NST + 1), Wp] (row
// j (NST + 1) + k: j -> k); pred/ptf/pcx and the exits are [B, Wm].  The
// pads of the new carry are written as NEG_INF scores and 0 payloads and
// reach no other output.
//
// What bounds it on an H100: bytes.  Each launch reads and writes the
// S/TF/CX planes (3 NST planes of [NRC, Wm] words per batch element) and
// writes out_f: 6 NST + 1 words per (b, rc, w), about 3.2 GB at 3 states
// and 5.2 GB at 5 with B = 8, NRC = 41, Wm = 125,973, so at least about
// 0.95 and 1.54 ms at 3.35 TB/s.  The arithmetic is a few adds and
// compares per element, far below the float32 rate.
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
//     rows pre[b, 0:NST, rc, 0:LP] are copied into shared memory with
//     cp.async, double-buffered, while the step's planes are in flight;
//     each word then reads its cost there (a scattered gather through
//     L1 otherwise);
//   * the transition rows: a word reads 3 NST - 1 of its NST (NST + 1)
//     rows (8 at 3 states, 14 at 5).  At 3 states a thread keeps its
//     words' 8 rows in registers (about 157 in all: one block of 256
//     threads per SM; capped at 128 for two blocks per SM it spilled and
//     ran slower).  At 5 states 14 rows x 4 words would add 24 registers
//     to a thread that also holds 15 vector loads in flight, so the block
//     stages its words' 14 rows in shared memory once and each state
//     reads its three rows there as float4 when it is updated (about 184
//     registers, no spills);
//   * the states are updated top down, one at a time over the thread's 4
//     words, and each state's new planes are stored as soon as they are
//     made, so the pre-update scores and payloads a state no longer
//     needs die early;
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

// The transition rows a word reads, numbered 0 .. 3 NST - 2: 0 -> 0,
// 0 -> 1, 1 -> 1, then for each state j >= 2 (j-1 -> j, j -> j,
// j-2 -> j), then the exits NST-2 -> NST, NST-1 -> NST.
template <int NST>
__host__ __device__ constexpr int n_rows() { return 3 * NST - 1; }

template <int NST>
__host__ __device__ constexpr int slot(int from, int to) {
  if (to == NST) return 3 * NST - 3 + (from - (NST - 2));
  if (to <= 1) return from + to;                   // 0->0: 0, 0->1: 1, 1->1: 2
  return 3 + 3 * (to - 2) + (from == to - 1 ? 0 : from == to ? 1 : 2);
}

// tp's row of the r-th transition a word reads
template <int NST>
__host__ __device__ constexpr int tp_row(int r) {
  for (int to = 0; to <= NST; ++to)
    for (int from = 0; from < NST; ++from) {
      const bool arc = to == NST ? from >= NST - 2
                       : to <= 1 ? from <= to
                                 : from >= to - 2 && from <= to;
      if (arc && slot<NST>(from, to) == r) return from * (NST + 1) + to;
    }
  return -1;
}

// the floats of dynamic shared memory before the transition rows: the
// double-buffered diphone costs, or after the walk the groups' exits
__host__ __device__ constexpr size_t stage_floats(int NST, int G, int LP) {
  const size_t stage = (size_t)2 * G * NST * LP;
  const size_t exits = (size_t)3 * 4 * TPB;
  return ((stage > exits ? stage : exits) + 3) / 4 * 4;   // 16-byte end
}

// whether a block keeps its words' transition rows in shared memory
template <int NST>
__host__ __device__ constexpr bool tp_shared() { return NST > 3; }

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

template <int NST, int G>
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
  constexpr int NT = n_rows<NST>();
  constexpr bool TP_SHARED = tp_shared<NST>();
  // [2][G][NST][LP] diphone costs (after the walk, the groups' exits),
  // then with TP_SHARED the block's transition rows [NT][WB]
  extern __shared__ __align__(16) float smem[];
  __shared__ float wmax[TPB / 32];

  const int tx = threadIdx.x % TW, g = threadIdx.x / TW;
  const int b = blockIdx.y;
  const float mp = mprev[b];
  const int w0 = blockIdx.x * WB + 4 * tx;     // this thread's 4 words
  const bool live = w0 < Wp;
  const int r0 = g * NRC / G, r1 = (g + 1) * NRC / G;   // group's planes
  const int steps = (NRC + G - 1) / G;
  float* const tps = smem + stage_floats(NST, G, LP);

  float tq[TP_SHARED ? 1 : NT][4];
  int32_t lpw[4];
  float pw[4];
  int32_t ptfw[4], pcxw[4];
  bool real[4];
  if (live) {
#pragma unroll
    for (int r = 0; r < NT; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(
          tp + (size_t)tp_row<NST>(r) * Wp + w0);
      if constexpr (TP_SHARED) {
        if (g == 0)     // the groups share the block's words
          *reinterpret_cast<float4*>(tps + r * WB + 4 * tx) = v;
      } else {
        unpack(v, tq[r]);
      }
    }
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
  // row r of the thread's 4 words (the first step's barrier orders the
  // staging before any read)
  auto row = [&](int r, float* x) {
    if constexpr (TP_SHARED) {
      unpack(*reinterpret_cast<const float4*>(tps + r * WB + 4 * tx), x);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = tq[r][k];
    }
  };

  const size_t plane = (size_t)NRC * Wp;            // one state's [NRC, Wp]
  const size_t base = (size_t)b * NST * plane + w0;
  const float* preb = pre + (size_t)b * NST * NRC * LP;
  // copy step i's rows of this group into buffer s; one commit group
  auto stage = [&](int i, int s) {
    const int rc = r0 + i;
    if (rc < r1) {
      float* dst = smem + (size_t)(s * G + g) * NST * LP;
#pragma unroll
      for (int j = 0; j < NST; ++j) {
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
    const size_t i0 = base + (size_t)rc * Wp;
    float4 s4[NST];
    int4 f4[NST], c4[NST];
    if (on) {                   // the step's planes go out before the wait
#pragma unroll
      for (int j = 0; j < NST; ++j) {
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
      const float* cost = smem + (size_t)((i & 1) * G + g) * NST * LP;
      float s[NST][4];
      int32_t tf[NST][4], cx[NST][4];
#pragma unroll
      for (int j = 0; j < NST; ++j) {
        unpack(s4[j], s[j]);
        unpack(f4[j], tf[j]);
        unpack(c4[j], cx[j]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s[j][k] = s[j][k] - mp;           // the deferred renormalization
          s[j][k] = s[j][k] + (-cost[j * LP + lpw[k]]);
        }
      }

      // non-emitting exit from pre-update values (priority NST-2)
      float tlo[4], thi[4];
      row(slot<NST>(NST - 2, NST), tlo);
      row(slot<NST>(NST - 1, NST), thi);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float lo = s[NST - 2][k] + tlo[k];
        const float hi = s[NST - 1][k] + thi[k];
        const bool hi_wins = hi > lo;
        const float out = hi_wins ? hi : lo;
        if (real[k]) {
          outf[(size_t)b * ob + (size_t)rc * orc + w0 + k] = out;
          if (i == 0 || out > best[k]) {   // first maximal rc
            best[k] = out;
            btf[k] = hi_wins ? tf[NST - 1][k] : tf[NST - 2][k];
            bcx[k] = hi_wins ? cx[NST - 1][k] : cx[NST - 2][k];
          }
        }
      }

      // the states top down, each stored as soon as it is made
#pragma unroll
      for (int j = NST - 1; j >= 0; --j) {
        float o[4];
        int32_t t[4], x[4];
        if (j >= 1) {                       // from(j-1) > self > skip(j-2)
          float tprev[4], tself[4], tskip[4];
          row(slot<NST>(j - 1, j), tprev);
          row(slot<NST>(j, j), tself);
          if (j >= 2) row(slot<NST>(j - 2, j), tskip);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float prev = s[j - 1][k] + tprev[k];
            const float self = s[j][k] + tself[k];
            const bool take_self = self > prev;
            float n = take_self ? self : prev;
            int32_t nt = take_self ? tf[j][k] : tf[j - 1][k];
            int32_t nc = take_self ? cx[j][k] : cx[j - 1][k];
            if (j >= 2) {
              const float skip = s[j - 2][k] + tskip[k];
              const bool take_skip = skip > n;
              n = take_skip ? skip : n;
              nt = take_skip ? tf[j - 2][k] : nt;
              nc = take_skip ? cx[j - 2][k] : nc;
            }
            o[k] = n; t[k] = nt; x[k] = nc;
          }
        } else {                            // self loop, then the entry
          float tself[4];
          row(slot<NST>(0, 0), tself);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float n = s[0][k] + tself[k];
            const bool win = pw[k] > n;
            o[k] = win ? pw[k] : n;
            t[k] = win ? ptfw[k] : tf[0][k];
            x[k] = win ? pcxw[k] : cx[0][k];
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (real[k]) m = o[k] > m ? o[k] : m;
          o[k] = real[k] ? o[k] : NEG_INF;
          t[k] = real[k] ? t[k] : 0;
          x[k] = real[k] ? x[k] : 0;
        }
        const size_t ij = i0 + j * plane;
        *reinterpret_cast<float4*>(nS + ij) = make_float4(o[0], o[1], o[2],
                                                          o[3]);
        *reinterpret_cast<int4*>(nTF + ij) = make_int4(t[0], t[1], t[2],
                                                       t[3]);
        *reinterpret_cast<int4*>(nCX + ij) = make_int4(x[0], x[1], x[2],
                                                       x[3]);
      }
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

// the dynamic shared memory a block of fan_kernel<NST, G> takes
template <int NST, int G>
size_t smem_bytes(int LP) {
  const size_t rows =
      tp_shared<NST>() ? (size_t)n_rows<NST>() * 4 * (TPB / G) : 0;
  return (stage_floats(NST, G, LP) + rows) * sizeof(float);
}

template <int NST, int G>
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
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&fa, fan_kernel<NST, G>);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fan_kernel<NST, G>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most - (int)fa.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = true;
  }
  constexpr int WB = 4 * (TPB / G);
  dim3 grid((Wp + WB - 1) / WB, B);
  fan_kernel<NST, G><<<grid, TPB, smem_bytes<NST, G>(LP), stream>>>(
      (const float*)S, (const int32_t*)TF, (const int32_t*)CX,
      (const float*)mprev, (const float*)pred, (const int32_t*)ptf,
      (const int32_t*)pcx, (const float*)pre, (const int32_t*)lp,
      (const float*)tp, (float*)nS,
      (int32_t*)nTF, (int32_t*)nCX, (float*)outf, ob, orc, (float*)esc,
      (int32_t*)etf, (int32_t*)ecx, (float*)mx, NRC, Wm, Wp, LP);
  return (int)cudaGetLastError();
}

}  // namespace

// One fan step on `stream` for NST (3 or 5) states.  `groups` (1, 2 or 4)
// splits the planes of a block; mx receives [B, ceil(Wp / (1024 /
// groups))] partial maxima.  mprev: [B] offsets to subtract from S as it
// is loaded (zeros for none).
extern "C" int fan_step_launch(const void* S, const void* TF, const void* CX,
                               const void* mprev, const void* pred,
                               const void* ptf, const void* pcx,
                               const void* pre, const void* lp,
                               const void* tp, void* nS,
                               void* nTF, void* nCX, void* outf, void* esc,
                               void* etf, void* ecx, void* mx, long long ob,
                               long long orc, int B, int NRC, int Wm, int Wp,
                               int LP, int nst, int groups, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define FAN_LAUNCH(N, G)                                                    \
  return launch<N, G>(S, TF, CX, mprev, pred, ptf, pcx, pre, lp, tp, nS,   \
                      nTF, nCX, outf, ob, orc, esc, etf, ecx, mx, B, NRC,  \
                      Wm, Wp, LP, st)
#define FAN_GROUPS(N)                     \
  switch (groups) {                       \
    case 1: FAN_LAUNCH(N, 1);             \
    case 2: FAN_LAUNCH(N, 2);             \
    case 4: FAN_LAUNCH(N, 4);             \
    default: return (int)cudaErrorInvalidValue; \
  }
  switch (nst) {
    case 3: FAN_GROUPS(3);
    case 5: FAN_GROUPS(5);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FAN_GROUPS
#undef FAN_LAUNCH
}

extern "C" const char* fan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
