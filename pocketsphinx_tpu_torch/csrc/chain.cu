// Chain block step for Hopper (sm_90a): every chain bucket of a frame in
// one launch.
//
// Replaces the Pallas TPU kernel `_kernel` of
// pocketsphinx_tpu/ops/pallas_chain.py (called through `chain_step`).
// The JAX scan computes the same block with XLA ops
// (search/ngram_fused.py, the chain-bucket loop of the step and the CI
// loop after the single-phone block); the port runs this kernel there,
// once per frame, over the multi-phone chains (with variants) and the
// CI/filler chains (without) together.
//
// For every bucket k of depth D and width W, batch element b and word w:
//   * the carry's scores less mprev[b], the previous frame's
//     renormalization, which the scan defers to this load (zeros for
//     none);
//   * senone goodness -costs[b, senid[j, d, w]]; on the word's first
//     node (fm) of a variant bucket the per-variant cost
//     -costs[b, senid_first_d[j, v, fd_idx[w]]] with
//     v = min(VAR[b, j, w], nv[w] - 1) (mpx first phones);
//   * the NST-state Viterbi update with TF/CTX/VAR metadata
//     (ops/hmm.py hmm_step_sm tie rules);
//   * the intra-word shift: state 0 of node d > 0 takes out[d-1] + pip
//     on a strict '>', except on the first node;
//   * VAR carried per word from the first node; exit row at depth D-1.
//
// Layout (ops/chain.py ChainGroup builds the bucket table `tab`):
//   * carry S/TF/CX and their outputs: one flat buffer each, the buckets'
//     [B, NST, D, W] blocks end to end (bucket k at B * tab[k][CARRY]);
//     VAR likewise with [B, NST, W] blocks of the variant buckets;
//   * costs [B, n_sen] with row stride cld: this frame's senone costs
//     (frame i of the scan's [B, CH, n_sen] chunk, read in place);
//   * sid: the senone ids, one flat unbatched int32 table, senid
//     [NST, D, W] of every bucket at tab[k][SID] and senid_first_d
//     [NST, RF, NFD] of a variant bucket at tab[k][SFD];
//   * tp [NK, D, W], fm [D, W], nv/fd_idx [W]: flat unbatched tables;
//   * exits: per group (0: variant buckets, 1: the others) one int32
//     buffer [3, B, ld] holding score bits, TF and CX, word w of bucket k
//     at column tab[k][XCOL] + w.
//
// What bounds it on an H100: bytes.  A frame reads and writes the S/TF/CX
// planes and reads the unbatched tp planes and senone ids; the arithmetic
// is a few adds and compares per element.
//
// What the design does about it:
//   * one launch per frame: every block belongs to one bucket (a row of
//     the table, found by its first block), so has_var is uniform in a
//     block and each block runs the body compiled for its value; the rows
//     are ordered deepest bucket first, so the long serial walks of the
//     deep buckets start first and overlap the wide shallow bucket's
//     streaming (measured faster than layout order, PERF.md);
//   * the batch inside the block: a block is WT = 32 words (x) by up to 8
//     batch elements (y), so the unbatched tables (tp, fm, nv, fd_idx and
//     the senone ids) of a word tile are fetched from device memory once
//     for all B and read through L1 by the block's warps (measured faster
//     than staging tp in shared memory behind a barrier, PERF.md);
//   * the costs by id: a node's cost is read from the frame's cost row
//     through its senone id, not from a row gathered for it beforehand;
//     the rows (B x n_sen floats, some 160 KB at B=8) stay in L2, so the
//     scan writes, copies and reads no per-node cost planes;
//   * one thread per (b, w) walks d with the states in registers, so the
//     shift out[d-1] is a register carry; a node's carry, senone ids and
//     transition words are loaded together before its arithmetic, so each
//     thread keeps many loads in flight; neighbouring threads read and
//     write neighbouring words (coalesced), each element once; the costs
//     (scattered, from L2) are read by id where the arithmetic takes them,
//     so a node holds its ids, not its costs, in registers: 116 at 3
//     states and 166 at 5, within the 116 and 168 of the kernel that read
//     pre-gathered costs (loading the costs with the node took 120 and
//     170, for 1-2% less time, PERF.md);
//   * no pass over the carry between frames: the renormalization's
//     subtraction is one add per score as the node is loaded.
//
// Exactness: only adds, negations, compares and selects, in the order of
// the reference; built with --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WT = 32;        // words per block
constexpr int BY = 8;         // batch elements per block (more loop)

// Columns of a row of the bucket table (ops/chain.py TAB_COLUMNS).
enum : int {
  C_D, C_W, C_VAR, C_RF, C_NFD, C_BLK0, C_CARRY, C_VOFF, C_SID, C_SFD,
  C_TP, C_FM, C_WOFF, C_XCOL, N_COL = 16
};

// One node's inputs for one (b, w): carry, senone ids, transition row,
// mask.
template <int NST>
struct Node {
  float s[NST], tp[NST * (NST + 1)];
  int32_t id[NST], tf[NST], cx[NST];
  bool first;
};

// The steps of bucket `row` for word w and batch rows b = b0, b0 + by...
// HAS_VAR is uniform in a block (one bucket per block).
template <int NST, bool HAS_VAR>
__device__ __forceinline__ void bucket_steps(
    const int32_t* __restrict__ row, int B, int b0, int by, int w,
    const float* __restrict__ S, const int32_t* __restrict__ TF,
    const int32_t* __restrict__ CX, const int32_t* __restrict__ VAR,
    const float* __restrict__ mprev, const float* __restrict__ costs,
    long long cld, const int32_t* __restrict__ sid_all,
    const float* __restrict__ tp,
    const uint8_t* __restrict__ fm, const int32_t* __restrict__ nv_all,
    const int32_t* __restrict__ fdi_all, float pip,
    float* __restrict__ nS, int32_t* __restrict__ nTF,
    int32_t* __restrict__ nCX, int32_t* __restrict__ nVAR,
    int32_t* __restrict__ xb, int xld) {
  constexpr int NK = NST * (NST + 1);
  const int D = __ldg(row + C_D), W = __ldg(row + C_W);
  const size_t DW = (size_t)D * W;
  int RF = 0, NFD = 0, fdw = 0, vsel = 0;
  if (HAS_VAR) {
    RF = __ldg(row + C_RF);
    NFD = __ldg(row + C_NFD);
    fdw = fdi_all[__ldg(row + C_WOFF) + w];
    vsel = nv_all[__ldg(row + C_WOFF) + w] - 1;
  }
  const size_t xplane = (size_t)B * xld;
  const int xcol = __ldg(row + C_XCOL) + w;
  const int32_t* sid = sid_all + __ldg(row + C_SID) + w;   // [NST, D, W]
  const int32_t* sfd = sid_all + __ldg(row + C_SFD);       // [NST, RF, NFD]

  for (int b = b0; b < B; b += by) {
    const size_t base =
        (size_t)B * __ldg(row + C_CARRY) + (size_t)b * NST * DW + w;
    const float* cost = costs + (size_t)b * cld;
    const size_t vbase =
        (size_t)B * __ldg(row + C_VOFF) + (size_t)b * NST * W + w;
    // read unconditionally: a test of the pointer here cost the
    // compiler's schedule a third of its registers and 11% (PERF.md)
    const float mp = mprev[b];
    int32_t var[NST], var_sum[NST];
    for (int j = 0; j < NST; ++j) {
      var[j] = HAS_VAR ? VAR[vbase + j * W] : 0;
      var_sum[j] = 0;
    }

    auto load = [&](Node<NST>& n, int d) {
      const size_t off = base + (size_t)d * W;
      for (int j = 0; j < NST; ++j) {
        n.s[j] = S[off + j * DW] - mp;
        n.id[j] = __ldg(sid + (size_t)j * DW + (size_t)d * W);
        n.tf[j] = TF[off + j * DW];
        n.cx[j] = CX[off + j * DW];
      }
      for (int a = 0; a < NK; ++a)
        n.tp[a] = __ldg(tp + (a * (size_t)D + d) * W + w);
      n.first = __ldg(fm + (size_t)d * W + w) != 0;
    };

    float prev_out = 0.0f;
    int32_t prev_otf = 0, prev_ocx = 0;
    Node<NST> cur;
    load(cur, 0);
    for (int d = 0; d < D; ++d) {
      const size_t off = base + (size_t)d * W;
      const bool first = cur.first;
      auto TP = [&](int a, int c) { return cur.tp[a * (NST + 1) + c]; };
      float s[NST];
      const int32_t* tf = cur.tf;
      const int32_t* cx = cur.cx;
      for (int j = 0; j < NST; ++j) {
        float sen = -__ldg(cost + cur.id[j]);
        if (HAS_VAR && first) {
          const int v = var[j] < vsel ? var[j] : vsel;
          sen = (v >= 0 && v < RF)
                    ? -__ldg(cost + __ldg(sfd + ((size_t)j * RF + v) * NFD
                                          + fdw))
                    : 0.0f;
        }
        s[j] = cur.s[j] + sen;
      }

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
        int32_t vrv = take_self ? var[j] : var[j - 1];
        if (j >= 2) {
          const float skip = s[j - 2] + TP(j - 2, j);
          const bool take_skip = skip > best;
          best = take_skip ? skip : best;
          tfv = take_skip ? tf[j - 2] : tfv;
          cxv = take_skip ? cx[j - 2] : cxv;
          vrv = take_skip ? var[j - 2] : vrv;
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
      if (d + 1 < D) load(cur, d + 1);
    }

    if (HAS_VAR)
      for (int j = 0; j < NST; ++j)
        nVAR[vbase + j * W] = j == 0 ? var[0] : var_sum[j];
    const size_t xo = (size_t)b * xld + xcol;
    xb[xo] = __float_as_int(prev_out);
    xb[xplane + xo] = prev_otf;
    xb[2 * xplane + xo] = prev_ocx;
  }
}

template <int NST>
__global__ void __launch_bounds__(WT * BY)
chain_group_kernel(const int32_t* __restrict__ tab, int nb, int B,
                   const float* __restrict__ S,
                   const int32_t* __restrict__ TF,
                   const int32_t* __restrict__ CX,
                   const int32_t* __restrict__ VAR,
                   const float* __restrict__ mprev,
                   const float* __restrict__ costs, long long cld,
                   const int32_t* __restrict__ sid_all,
                   const float* __restrict__ tp_all,
                   const uint8_t* __restrict__ fm_all,
                   const int32_t* __restrict__ nv_all,
                   const int32_t* __restrict__ fdi_all, float pip,
                   float* __restrict__ nS, int32_t* __restrict__ nTF,
                   int32_t* __restrict__ nCX, int32_t* __restrict__ nVAR,
                   int32_t* __restrict__ x0, int ld0,
                   int32_t* __restrict__ x1, int ld1) {
  // the block's bucket: rows in launch order, first blocks ascending
  int k = 0;
  while (k + 1 < nb &&
         (int)blockIdx.x >= __ldg(tab + (k + 1) * N_COL + C_BLK0))
    ++k;
  const int32_t* row = tab + k * N_COL;
  const int w = ((int)blockIdx.x - __ldg(row + C_BLK0)) * WT + threadIdx.x;
  if (w >= __ldg(row + C_W)) return;
  const float* tp = tp_all + __ldg(row + C_TP);      // [NK, D, W]
  const uint8_t* fm = fm_all + __ldg(row + C_FM);    // [D, W]

#define BUCKET_ARGS row, B, threadIdx.y, blockDim.y, w, S, TF, CX, VAR, \
    mprev, costs, cld, sid_all, tp, fm, nv_all, fdi_all, pip, nS, nTF, \
    nCX, nVAR
  if (__ldg(row + C_VAR))
    bucket_steps<NST, true>(BUCKET_ARGS, x0, ld0);
  else
    bucket_steps<NST, false>(BUCKET_ARGS, x1, ld1);
#undef BUCKET_ARGS
}

template <int NST>
int launch(const int32_t* tab, int nb, int nblk, int B,
           const float* S, const int32_t* TF, const int32_t* CX,
           const int32_t* VAR, const float* mprev, const float* costs,
           long long cld, const int32_t* sid, const float* tp,
           const uint8_t* fm,
           const int32_t* nv, const int32_t* fdi, float pip, float* nS,
           int32_t* nTF, int32_t* nCX, int32_t* nVAR, int32_t* x0, int ld0,
           int32_t* x1, int ld1, cudaStream_t stream) {
  const dim3 block(WT, B < BY ? B : BY);
  chain_group_kernel<NST><<<nblk, block, 0, stream>>>(
      tab, nb, B, S, TF, CX, VAR, mprev, costs, cld, sid, tp, fm, nv, fdi,
      pip, nS, nTF, nCX, nVAR, x0, ld0, x1, ld1);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch over the nb buckets of `tab` (nblk blocks in all); mprev:
// [B] offsets to subtract from S as it is loaded (zeros for none); costs:
// [B, n_sen] at row stride cld, read through the ids of sid.  Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for an NST the
// kernel is not instantiated for.
extern "C" int chain_group_launch(
    const void* tab, int nb, int nblk, int NST, int B, const void* S,
    const void* TF, const void* CX, const void* VAR, const void* mprev,
    const void* costs, long long cld, const void* sid, const void* tp,
    const void* fm,
    const void* nv, const void* fdi, float pip, void* nS, void* nTF,
    void* nCX, void* nVAR, void* x0, int ld0, void* x1, int ld1,
    void* stream) {
#define CHAIN_ARGS (const int32_t*)tab, nb, nblk, B, (const float*)S,        \
    (const int32_t*)TF, (const int32_t*)CX, (const int32_t*)VAR,             \
    (const float*)mprev, (const float*)costs, cld, (const int32_t*)sid,      \
    (const float*)tp, (const uint8_t*)fm,                                    \
    (const int32_t*)nv, (const int32_t*)fdi, pip, (float*)nS,                \
    (int32_t*)nTF, (int32_t*)nCX, (int32_t*)nVAR, (int32_t*)x0, ld0,         \
    (int32_t*)x1, ld1, (cudaStream_t)stream
  if (NST == 3) return launch<3>(CHAIN_ARGS);
  if (NST == 5) return launch<5>(CHAIN_ARGS);
#undef CHAIN_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
