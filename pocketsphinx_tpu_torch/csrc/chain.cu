// Chain-bucket step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// pocketsphinx_tpu/ops/pallas_chain.py (called through `chain_step`).
// The JAX scan computes the same block with XLA ops
// (search/ngram_fused.py, the chain-bucket loop of the step); the port
// runs this kernel there, for the multi-phone chains (HAS_VAR) and the
// CI/filler chains (!HAS_VAR).
//
// For every batch element b and word w of a bucket of depth D:
//   * senone goodness -pre[b, j, d, w]; on the word's first node (fm)
//     the per-variant cost -prevd[b, j, v, fd_idx[w]] with
//     v = min(VAR[b, j, w], nv[w] - 1) (mpx first phones; the gather by
//     fd_idx folds the per-diphone -> word expansion into the kernel);
//   * the NST-state Viterbi update with TF/CTX/VAR metadata
//     (ops/hmm.py hmm_step_sm tie rules);
//   * the intra-word shift: state 0 of node d > 0 takes out[d-1] + pip
//     on a strict '>', except on the first node;
//   * VAR carried per word from the first node; exit row at depth D-1.
//
// What bounds it on an H100: bytes.  A launch reads and writes the
// S/TF/CTX planes [B, NST, D, W] and reads pre [B, NST, D, W] and the
// tp planes [NST*(NST+1), D, W]; the arithmetic is a few adds and
// compares per element.
//
// What the design does about it: one thread per (b, w) walks d and the
// states in registers, so the shift out[d-1] is a register carry, and
// each plane element is read once and written once with neighbouring
// threads on neighbouring words (coalesced).
//
// Exactness: only adds, negations, compares and selects, in the order of
// the reference; built with --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

template <int NST, bool HAS_VAR>
__global__ void chain_kernel(const float* __restrict__ S,
                             const int32_t* __restrict__ TF,
                             const int32_t* __restrict__ CX,
                             const int32_t* __restrict__ VAR,
                             const float* __restrict__ pre,
                             const float* __restrict__ prevd,
                             const int32_t* __restrict__ fd_idx,
                             const float* __restrict__ tp,
                             const uint8_t* __restrict__ fm,
                             const int32_t* __restrict__ nv,
                             float pip,
                             float* __restrict__ nS,
                             int32_t* __restrict__ nTF,
                             int32_t* __restrict__ nCX,
                             int32_t* __restrict__ nVAR,
                             float* __restrict__ es,
                             int32_t* __restrict__ etf,
                             int32_t* __restrict__ ecx,
                             int D, int W, int RF, int NFD) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;

  const size_t DW = (size_t)D * W;
  const size_t base = (size_t)b * NST * DW + w;    // [b, 0, 0, w]
  int32_t var[NST];
  int32_t var_sum[NST];
  int vsel = 0, fdw = 0;
  if (HAS_VAR) {
    for (int j = 0; j < NST; ++j) {
      var[j] = VAR[((size_t)b * NST + j) * W + w];
      var_sum[j] = 0;
    }
    fdw = fd_idx[w];
    vsel = nv[w] - 1;
  }

  float prev_out = 0.0f;
  int32_t prev_otf = 0, prev_ocx = 0;
  for (int d = 0; d < D; ++d) {
    const size_t off = base + (size_t)d * W;
    const bool first = fm[(size_t)d * W + w] != 0;
    float s[NST];
    int32_t tf[NST], cx[NST];
    for (int j = 0; j < NST; ++j) {
      float sen = -pre[off + j * DW];
      if (HAS_VAR && first) {
        const int v = var[j] < vsel ? var[j] : vsel;
        sen = (v >= 0 && v < RF)
                  ? -prevd[(((size_t)b * NST + j) * RF + v) * NFD + fdw]
                  : 0.0f;
      }
      s[j] = S[off + j * DW] + sen;
      tf[j] = TF[off + j * DW];
      cx[j] = CX[off + j * DW];
    }
    auto TP = [&](int a, int c) {
      return tp[(size_t)(a * (NST + 1) + c) * DW + (size_t)d * W + w];
    };

    // non-emitting exit from pre-update values (priority NST-2)
    const float lo = s[NST - 2] + TP(NST - 2, NST);
    const float hi = s[NST - 1] + TP(NST - 1, NST);
    const bool hw = hi > lo;
    const float out = hw ? hi : lo;
    const int32_t otf = hw ? tf[NST - 1] : tf[NST - 2];
    const int32_t ocx = hw ? cx[NST - 1] : cx[NST - 2];

    float ns[NST];
    int32_t ntf[NST], ncx[NST];
    for (int j = NST - 1; j > 0; --j) {
      const float prev = s[j - 1] + TP(j - 1, j);
      const float self = s[j] + TP(j, j);
      const bool take_self = self > prev;
      float best = take_self ? self : prev;
      int32_t tfv = take_self ? tf[j] : tf[j - 1];
      int32_t cxv = take_self ? cx[j] : cx[j - 1];
      int32_t vrv = 0;
      if (HAS_VAR) vrv = take_self ? var[j] : var[j - 1];
      if (j >= 2) {
        const float skip = s[j - 2] + TP(j - 2, j);
        const bool take_skip = skip > best;
        best = take_skip ? skip : best;
        tfv = take_skip ? tf[j - 2] : tfv;
        cxv = take_skip ? cx[j - 2] : cxv;
        if (HAS_VAR) vrv = take_skip ? var[j - 2] : vrv;
      }
      ns[j] = best;
      ntf[j] = tfv;
      ncx[j] = cxv;
      if (HAS_VAR && first) var_sum[j] += vrv;
    }
    ns[0] = s[0] + TP(0, 0);
    ntf[0] = tf[0];
    ncx[0] = cx[0];

    // intra-word shift into state 0 (the first node takes word entries)
    float sh = (d == 0 ? NEG_INF : prev_out) + pip;
    if (first) sh = NEG_INF;
    const int32_t shtf = d == 0 ? otf : prev_otf;
    const int32_t shcx = d == 0 ? ocx : prev_ocx;
    const bool win = sh > ns[0];
    ns[0] = win ? sh : ns[0];
    ntf[0] = win ? shtf : ntf[0];
    ncx[0] = win ? shcx : ncx[0];

    for (int j = 0; j < NST; ++j) {
      nS[off + j * DW] = ns[j];
      nTF[off + j * DW] = ntf[j];
      nCX[off + j * DW] = ncx[j];
    }
    prev_out = out;
    prev_otf = otf;
    prev_ocx = ocx;
  }

  for (int j = 0; j < NST; ++j) {
    int32_t v = 0;
    if (HAS_VAR) v = j == 0 ? var[0] : var_sum[j];
    nVAR[((size_t)b * NST + j) * W + w] = v;
  }
  es[(size_t)b * W + w] = prev_out;
  etf[(size_t)b * W + w] = prev_otf;
  ecx[(size_t)b * W + w] = prev_ocx;
}

template <int NST, bool HAS_VAR>
void launch(const void* S, const void* TF, const void* CX, const void* VAR,
            const void* pre, const void* prevd, const void* fd_idx,
            const void* tp, const void* fm, const void* nv, float pip,
            void* nS, void* nTF, void* nCX, void* nVAR, void* es, void* etf,
            void* ecx, int B, int D, int W, int RF, int NFD,
            cudaStream_t stream) {
  const int threads = 256;
  dim3 grid((W + threads - 1) / threads, B);
  chain_kernel<NST, HAS_VAR><<<grid, threads, 0, stream>>>(
      (const float*)S, (const int32_t*)TF, (const int32_t*)CX,
      (const int32_t*)VAR, (const float*)pre, (const float*)prevd,
      (const int32_t*)fd_idx, (const float*)tp, (const uint8_t*)fm,
      (const int32_t*)nv, pip, (float*)nS, (int32_t*)nTF, (int32_t*)nCX,
      (int32_t*)nVAR, (float*)es, (int32_t*)etf, (int32_t*)ecx, D, W, RF,
      NFD);
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for
// an NST the kernel is not instantiated for.
extern "C" int chain_step_launch(const void* S, const void* TF,
                                 const void* CX, const void* VAR,
                                 const void* pre, const void* prevd,
                                 const void* fd_idx, const void* tp,
                                 const void* fm, const void* nv, float pip,
                                 void* nS, void* nTF, void* nCX, void* nVAR,
                                 void* es, void* etf, void* ecx, int B,
                                 int NST, int D, int W, int RF, int NFD,
                                 int has_var, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CHAIN_ARGS S, TF, CX, VAR, pre, prevd, fd_idx, tp, fm, nv, pip, nS, \
                   nTF, nCX, nVAR, es, etf, ecx, B, D, W, RF, NFD, st
  if (NST == 3 && has_var) launch<3, true>(CHAIN_ARGS);
  else if (NST == 3) launch<3, false>(CHAIN_ARGS);
  else if (NST == 5 && has_var) launch<5, true>(CHAIN_ARGS);
  else if (NST == 5) launch<5, false>(CHAIN_ARGS);
  else return (int)cudaErrorInvalidValue;
#undef CHAIN_ARGS
  return (int)cudaGetLastError();
}

extern "C" const char* chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
