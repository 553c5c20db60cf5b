// Word-final right-context fan step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// pocketsphinx_tpu/ops/pallas_fan.py (called through `fan_step`), the
// finals block of the fused n-gram scan (search/ngram_fused.py).
//
// For every batch element b and multi-phone word w, over every right-
// context plane rc:
//   sen_j   = -pre[b, j, rc, lp[w]]           (per-final-diphone costs)
//   s_j     = S[b, j, rc, w] + sen_j          (emission on the source)
//   exit    = max(s1 + tp[1->3], s2 + tp[2->3]) with ties to state 1
//   state 2 = best of from(1) > self > skip(0); state 1 = from(0) > self;
//   state 0 = self loop, then the chain-last entry pred[b, w] merged in
//             on a strict '>' (ops/hmm.py hmm_step_sm tie rules)
// and the per-word exit is the first maximal rc with its TF/CX payload.
//
// What bounds it on an H100: bytes.  Each launch reads and writes the
// S/TF/CX planes [B, 3, NRC, W] (4-byte words) and writes out_f
// [B, NRC, W]: about 6.3 planes of 3 x NRC x W words per utterance,
// roughly 64 MB at NRC = 41, W = 20480, so at least about 19 us at
// 3.35 TB/s, and 8 times that at B = 8.  The arithmetic is a dozen adds
// and compares per element, far below the card's float32 rate.
//
// What the design does about it: one thread per (b, w) walks the NRC
// planes in registers, so every plane element is read once and written
// once, and neighbouring threads touch neighbouring words (coalesced).
// The diphone -> word expansion is a plain gather from `pre`, which is
// small (~[3, 41, 640] per element) and stays in L1/L2.  The bf16 x 3
// one-hot matmul of the TPU kernel was a device for its matrix unit and
// is not carried over, nor is its tile padding of W.
//
// Exactness: only adds, negations, compares and selects, in the order of
// the reference; built with --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void fan_kernel(const float* __restrict__ S,
                           const int32_t* __restrict__ TF,
                           const int32_t* __restrict__ CX,
                           const float* __restrict__ pred,
                           const int32_t* __restrict__ ptf,
                           const int32_t* __restrict__ pcx,
                           const float* __restrict__ pre,
                           const int32_t* __restrict__ lp,
                           const float* __restrict__ tp,
                           float* __restrict__ nS,
                           int32_t* __restrict__ nTF,
                           int32_t* __restrict__ nCX,
                           float* __restrict__ outf,
                           float* __restrict__ esc,
                           int32_t* __restrict__ etf,
                           int32_t* __restrict__ ecx,
                           int NRC, int W, int LP) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;

  // transition goodness rows: tp[j * 4 + k] = tp[j -> k]
  const float tp00 = tp[0 * W + w], tp01 = tp[1 * W + w];
  const float tp02 = tp[2 * W + w], tp11 = tp[5 * W + w];
  const float tp12 = tp[6 * W + w], tp13 = tp[7 * W + w];
  const float tp22 = tp[10 * W + w], tp23 = tp[11 * W + w];
  const int lpw = lp[w];
  const float pw = pred[(size_t)b * W + w];
  const int32_t ptfw = ptf[(size_t)b * W + w];
  const int32_t pcxw = pcx[(size_t)b * W + w];

  const size_t plane = (size_t)NRC * W;            // one state's [NRC, W]
  const size_t base = (size_t)b * 3 * plane;       // S/TF/CX of element b
  const size_t pbase = (size_t)b * 3 * NRC * LP;   // pre of element b
  float best = 0.0f;
  int32_t best_tf = 0, best_cx = 0;

  for (int rc = 0; rc < NRC; ++rc) {
    const size_t i0 = base + (size_t)rc * W + w;
    const size_t i1 = i0 + plane, i2 = i1 + plane;
    const size_t p0 = pbase + (size_t)rc * LP + lpw;
    const float s0 = S[i0] + (-pre[p0]);
    const float s1 = S[i1] + (-pre[p0 + (size_t)NRC * LP]);
    const float s2 = S[i2] + (-pre[p0 + (size_t)2 * NRC * LP]);
    const int32_t m0tf = TF[i0], m1tf = TF[i1], m2tf = TF[i2];
    const int32_t m0cx = CX[i0], m1cx = CX[i1], m2cx = CX[i2];

    // non-emitting exit from pre-update values (priority 1 over 2)
    const float lo = s1 + tp13;
    const float hi = s2 + tp23;
    const bool hi_wins = hi > lo;
    const float out = hi_wins ? hi : lo;
    const int32_t otf = hi_wins ? m2tf : m1tf;
    const int32_t ocx = hi_wins ? m2cx : m1cx;

    // state 2: from(1) > self > skip(0)
    const float prev2 = s1 + tp12;
    const float self2 = s2 + tp22;
    const float skip2 = s0 + tp02;
    const bool take_self2 = self2 > prev2;
    const float best2 = take_self2 ? self2 : prev2;
    const bool take_skip2 = skip2 > best2;
    const float n2 = take_skip2 ? skip2 : best2;
    const int32_t n2tf = take_skip2 ? m0tf : (take_self2 ? m2tf : m1tf);
    const int32_t n2cx = take_skip2 ? m0cx : (take_self2 ? m2cx : m1cx);

    // state 1: from(0) > self
    const float prev1 = s0 + tp01;
    const float self1 = s1 + tp11;
    const bool take_self1 = self1 > prev1;
    const float n1 = take_self1 ? self1 : prev1;
    const int32_t n1tf = take_self1 ? m1tf : m0tf;
    const int32_t n1cx = take_self1 ? m1cx : m0cx;

    // state 0: self loop, then the chain-last entry (strict >)
    float n0 = s0 + tp00;
    const bool win = pw > n0;
    n0 = win ? pw : n0;
    const int32_t n0tf = win ? ptfw : m0tf;
    const int32_t n0cx = win ? pcxw : m0cx;

    nS[i0] = n0;   nS[i1] = n1;   nS[i2] = n2;
    nTF[i0] = n0tf; nTF[i1] = n1tf; nTF[i2] = n2tf;
    nCX[i0] = n0cx; nCX[i1] = n1cx; nCX[i2] = n2cx;
    outf[(size_t)b * plane + (size_t)rc * W + w] = out;

    // per-word exit: first maximal rc
    if (rc == 0 || out > best) {
      best = out;
      best_tf = otf;
      best_cx = ocx;
    }
  }
  esc[(size_t)b * W + w] = best;
  etf[(size_t)b * W + w] = best_tf;
  ecx[(size_t)b * W + w] = best_cx;
}

}  // namespace

extern "C" int fan_step_launch(const void* S, const void* TF, const void* CX,
                               const void* pred, const void* ptf,
                               const void* pcx, const void* pre,
                               const void* lp, const void* tp, void* nS,
                               void* nTF, void* nCX, void* outf, void* esc,
                               void* etf, void* ecx, int B, int NRC, int W,
                               int LP, void* stream) {
  const int threads = 256;
  dim3 grid((W + threads - 1) / threads, B);
  fan_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)S, (const int32_t*)TF, (const int32_t*)CX,
      (const float*)pred, (const int32_t*)ptf, (const int32_t*)pcx,
      (const float*)pre, (const int32_t*)lp, (const float*)tp, (float*)nS,
      (int32_t*)nTF, (int32_t*)nCX, (float*)outf, (float*)esc,
      (int32_t*)etf, (int32_t*)ecx, NRC, W, LP);
  return (int)cudaGetLastError();
}

extern "C" const char* fan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
