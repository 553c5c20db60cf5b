// Word-transition block of the fused n-gram scan for Hopper (sm_90a): one
// launch per frame over every entry column of the decoder's (or of one
// tensor-parallel part's) block tables.
//
// Replaces the XLA block of pocketsphinx_tpu/search/ngram_fused.py
// (`_make_scan`, "word transitions", lines 1297-1453), for which the JAX
// package has no Pallas kernel; the port's plain version is
// `transitions_ref` in ops/transitions.py.  Per utterance b and entry
// column e, over this frame's top-K exits k (in ascending order):
//   * the LM score lm of column e under exit k's context: mode rows
//     rows[ctx, e]; mode B bg[h1, e] + bo2w; mode C (uni_row[e] + bo1w[h1]
//     with the history's CSR bigram in place, or its fat row) + bo2w; in
//     modes B and C the context's trigram correction for e replaces it;
//   * cand = ((svk[f0p[e], k] + (isfill ? fillpen : lm + wpen))
//            + (accept[fb_k, e] - 1) * 1e30) + (kv live ? 0 : NEG_INF);
//   * entry = the largest cand, am = its first k (a strict '>' in
//     ascending k), and the winner's payloads: prw_e = ki[am],
//     ctx_new (the winner's successor-context row at e: ctx_next[rw1] in
//     modes rows/B, ctx_base / CSR bg_ctx / fat_ctx in mode C, as an int;
//     a filler keeps the source's context), erw1, erw2 and fb_e.
//
// What bounds it on an H100: in bytes, about 0.014 ms at the 126k shapes
// (the seven [B, E] outputs, 40 bytes per (b, e), and the inputs once);
// in instructions, the B * K * E candidates (98.5M per 126k frame, about
// 13 instructions each at the least).  The first kernel (PR 10) spent
// about 35 per (b, k, e) on stamp reads, scattered exit-plane reads and a
// barrier per exit.
//
// The design: a block owns a tile of columns of one utterance, each thread
// CPT consecutive columns (16-byte loads), and the block's threads may be
// split KS ways over the exits (`ks`, to fill the card at small E; the
// splits' winners merge at the end).  The exits are staged KC at a time;
// per chunk:
//   S0  each exit's metadata in shared memory as [KC] vectors (the live
//       add, the accept word's masks, the backoffs, the dense row, the
//       payloads), and its overlay entries inside the tile, found by
//       binary search in the kernel's copies of the overlay lists sorted
//       by column (`convert.kernel_overlays`): O(log) reads per exit, not
//       a scan; the exit planes as [NRC][KC + 4] (a thread reads 4 exits
//       of its column's plane in one 16-byte load; rows 4 banks apart);
//   S1  the overlaid (k, e) pairs marked in bit masks per column
//       ([KC / 32][tile] words; trigram and, in mode C, bigram);
//   S2  the dense sweep: for each column, every (k, e) not marked, from
//       registers and one shared-memory load per 4 exits (mode C: the
//       short register expression (uni + bo1) + bo; modes rows and B: the
//       dense row, loaded one group of 4 exits ahead), keeping the first
//       maximum in registers; mode C's few fat exits after it, each a
//       dense row; and the marked pairs' candidates (one thread per exit
//       over its few hits), merged per column by a 64-bit atomicMax over
//       (orderable cand, ~k): the greater cand, else the smaller k, is a
//       total order, so the merge is exact whatever order the pairs
//       arrive in;
//   S3  (mode C) the overlay winner's successor context: the bigram's
//       bg_ctx, or the fat/ctx_base row when only a trigram hit.
// At the end the dense winners of the splits and the overlay winner merge
// in the same order, and each column's payloads are written once (the
// last chunk's exits read from shared memory).  Mode C keeps no dense
// rows in registers, so it runs three blocks per SM.
//
// Exactness: the float operations of the plain version in its order
// (base + bo1w is formed even where an overlay replaces it; + 0.0f stays
// an add); built with --fmad=false.  Columns are unique within one
// history's CSR row and one context's trigram row, so a sorted row gives
// the same overlay; an id outside the column range (a split part's spare
// column) sorts last and is never in a tile.  cand is never -0.0 (its
// last operation adds +0.0 or -1e30), so the orderable key compares as
// '>' does.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// ops/transitions.py `_Args`, field for field (outside the unnamed
// namespace: the exported launcher takes it).
struct Args {
  const float* kv;
  const int64_t* ki;
  const int32_t* ctx;
  const int64_t* fb;
  const float* svk;
  const int64_t* f0p;
  const uint8_t* isfill;
  const float* fillpen;
  const uint8_t* isreal;
  const int32_t* lmwid;
  const int64_t* acc;          // [nw, nE] packed accept words
  const float* rows;
  const float* rows_h;
  const float* bg;
  const float* ctx_next;
  const int32_t* bgmeta;
  const float* uni_row;
  const float* ctx_base;
  const int32_t* umeta;
  const int32_t* bg_cols;      // the sorted copies (tr_bg_*)
  const float* bg_vals;
  const float* bg_ctx;
  const float* fat_rows;
  const float* fat_ctx;
  const int32_t* tg_cols;      // the sorted copies (tr_tg_*)
  const float* tg_vals;
  float* entry;
  int64_t* am;
  int64_t* prw;
  int32_t* ctx_new;
  int32_t* erw1;
  int32_t* erw2;
  int64_t* fb_e;
  int64_t kv_ld, ki_ld, ctx_ld, fb_ld;
  int32_t B, K, NRC, nE, V, n_bg, s_tri, sb, n_fat, tg2d, kc, nw, ks, vec;
  float wpen;
};

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TPB = 256;               // threads per block
constexpr int NONE = 0x7fffffff;       // no winner yet
constexpr int N_EX = 16;               // 4-byte [KC] vectors per staged exit

enum { ROWS = 0, SPARSE = 1, CSR = 2 };

__host__ __device__ constexpr int n_masks(int mode) {
  return mode == CSR ? 2 : (mode == SPARSE ? 1 : 0);
}

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// One block's shared memory (ops/transitions.py `_smem_bytes`): offsets
// of each region.  `accw` is the number of accept words staged per column
// (0: they stay in registers).
struct Layout {
  int tile, svs, mw;
  size_t ex, sv, u, key, cctx, fatw, acc, total;
};

__host__ __device__ inline Layout layout(int mode, int cpt, int ks, int kc,
                                         int nrc, int accw) {
  Layout L;
  L.tile = TPB / ks * cpt;
  L.svs = kc + 4;
  L.mw = kc / 32;
  L.ex = 0;
  L.sv = up16((size_t)4 * N_EX * kc);
  L.u = L.sv + up16((size_t)4 * nrc * L.svs);
  const size_t masks = (size_t)4 * n_masks(mode) * L.mw * L.tile;
  const size_t parts = (size_t)8 * ks * L.tile;     // the splits' winners
  L.key = L.u + up16(masks > parts ? masks : parts);
  L.cctx = L.key + (mode == ROWS ? 0 : (size_t)8 * L.tile);
  L.fatw = L.cctx + (mode == CSR ? (size_t)4 * L.tile : 0);
  L.acc = L.fatw + (mode == CSR ? 16 : 0);
  L.total = L.acc + (size_t)8 * accw * L.tile;
  return L;
}

struct Smem {
  float *add, *bo, *bo1;        // [kc] per staged exit
  uint32_t *m0, *m1;            // accept: (lo, hi) masks, or (word, mask)
  int32_t *rix, *fbk;           // dense row (-1: none), final phone
  int32_t *blo, *bhi, *tlo, *thi;  // overlay entries inside the tile
  int32_t *pc, *rw1, *rw2;      // payloads: context, history words
  int64_t* ki;                  //   and word id
  float* sv;                    // [NRC][svs] exit planes
  uint32_t *tm, *bm;            // [mw][tile] overlaid-pair masks
  float* pbest;                 // [ks][tile] the splits' winners (aliases
  int32_t* pk;                  //  the masks after the last chunk)
  unsigned long long* key;      // [tile] the overlay winner
  float* cctx;                  // [tile] its successor context (mode C)
  uint32_t* fatw;               // [kc / 32] mode C's fat exits, one bit each
  uint32_t* acc;                // [2 * nw][tile] accept words (staged)
};

__device__ inline Smem carve(unsigned char* p, const Layout& L, int kc,
                             int ks) {
  Smem s;
  float* f = (float*)(p + L.ex);
  s.add = f;
  s.bo = f + kc;
  s.bo1 = f + 2 * kc;
  s.m0 = (uint32_t*)(f + 3 * kc);
  s.m1 = (uint32_t*)(f + 4 * kc);
  s.rix = (int32_t*)(f + 5 * kc);
  s.fbk = (int32_t*)(f + 6 * kc);
  s.blo = (int32_t*)(f + 7 * kc);
  s.bhi = (int32_t*)(f + 8 * kc);
  s.tlo = (int32_t*)(f + 9 * kc);
  s.thi = (int32_t*)(f + 10 * kc);
  s.pc = (int32_t*)(f + 11 * kc);
  s.rw1 = (int32_t*)(f + 12 * kc);
  s.rw2 = (int32_t*)(f + 13 * kc);
  s.ki = (int64_t*)(f + 14 * kc);
  s.sv = (float*)(p + L.sv);
  s.tm = (uint32_t*)(p + L.u);
  s.bm = s.tm + (size_t)L.mw * L.tile;
  s.pbest = (float*)(p + L.u);
  s.pk = (int32_t*)(s.pbest + (size_t)ks * L.tile);
  s.key = (unsigned long long*)(p + L.key);
  s.cctx = (float*)(p + L.cctx);
  s.fatw = (uint32_t*)(p + L.fatw);
  s.acc = (uint32_t*)(p + L.acc);
  return s;
}

// An LM context's history words (rw1, rw2): mode rows from the context
// row's (h1, h2) columns, modes B and C from the bigram-context metadata
// (a unigram context c > 0 is word c - 1; 0 is the empty history V).
template <int MODE>
__device__ __forceinline__ void history(const Args& a, int c, int& rw1,
                                        int& rw2, int& bidx) {
  if (MODE == ROWS) {
    rw1 = (int)a.rows_h[(int64_t)c * 2];
    rw2 = (int)a.rows_h[(int64_t)c * 2 + 1];
    bidx = 0;
  } else {
    const bool tri = c > a.V;
    bidx = min(max(c - 1 - a.V, 0), max(a.n_bg - 1, 0));
    const int32_t* m = a.bgmeta + (int64_t)bidx * 8;
    rw1 = tri ? m[0] : (c > 0 ? c - 1 : a.V);
    rw2 = tri ? m[1] : a.V;
  }
}

// Mode C: the fat row of history h1c, or -1.
__device__ __forceinline__ int fat_row(const Args& a, int h1c) {
  const int f = a.umeta[(int64_t)h1c * 4 + 3];
  return a.n_fat > 0 && f >= 0 ? min(f, a.n_fat - 1) : -1;
}

// Lower bounds of x0 and x1 in the sorted c[off, off + n), together (a
// binary search whose steps do not depend on the data, so both loads are
// in flight at once; an 8-way search with 7 probes a step was slower).
__device__ __forceinline__ void bounds(const int32_t* __restrict__ c,
                                       int off, int n, int x0, int x1,
                                       int& lo, int& hi) {
  lo = hi = off;
  if (n <= 0) return;
  while (n > 1) {
    const int half = n >> 1;
    const int v0 = c[lo + half], v1 = c[hi + half];
    lo = v0 < x0 ? lo + half : lo;
    hi = v1 < x1 ? hi + half : hi;
    n -= half;
  }
  const int v0 = c[lo], v1 = c[hi];
  lo += v0 < x0;
  hi += v1 < x1;
}

// Stage exit kk of the chunk at k0 (kk in [n, n4): a pad, never read as a
// candidate, with safe row indices).
template <int MODE, bool ACCR>
__device__ void stage_exit(const Args& a, const Smem& s, int b, int k0,
                           int kk, int n, int t0, int t1) {
  const bool pad = kk >= n;
  const int k = k0 + (pad ? n - 1 : kk);
  const float kv = a.kv[b * a.kv_ld + k];
  s.add[kk] = kv > NEG_INF / 2 ? 0.0f : NEG_INF;
  const int fb = (int)a.fb[b * a.fb_ld + k];
  s.fbk[kk] = fb;
  if (ACCR) {                    // one word per column, in registers
    s.m0[kk] = fb >= 0 && fb < 32 ? 1u << fb : 0u;
    s.m1[kk] = fb >= 32 && fb < 64 ? 1u << (fb - 32) : 0u;
  } else {                       // (32-bit word, mask) of the staged words
    s.m0[kk] = (uint32_t)min(max(fb >> 5, 0), 2 * a.nw - 1);
    s.m1[kk] = 1u << (fb & 31);
  }
  const int c = a.ctx[b * a.ctx_ld + k];
  s.pc[kk] = c;
  s.ki[kk] = a.ki[b * a.ki_ld + k];
  s.bo[kk] = 0.0f;
  s.bo1[kk] = 0.0f;
  int rw1, rw2, bidx;
  history<MODE>(a, c, rw1, rw2, bidx);
  s.rw1[kk] = rw1;
  s.rw2[kk] = rw2;
  int blo = 0, bhi = 0, tlo = 0, thi = 0;
  if (MODE == ROWS) {
    s.rix[kk] = c;
  } else {
    const bool tri = c > a.V;
    const int32_t* m = a.bgmeta + (int64_t)bidx * 8;
    s.bo[kk] = tri ? __int_as_float(m[2]) : 0.0f;
    const int h1c = min(rw1, a.V);
    int bn = 0, boff = 0, tn = 0, toff = 0;
    if (MODE == SPARSE) {
      s.rix[kk] = h1c;
    } else {
      const int32_t* u = a.umeta + (int64_t)h1c * 4;
      const int fr = fat_row(a, h1c);
      s.rix[kk] = fr;
      s.bo1[kk] = __int_as_float(u[2]);
      bn = fr >= 0 || pad ? 0 : min(u[1], a.sb);
      boff = u[0];
      if (fr >= 0 && !pad) atomicOr(&s.fatw[kk >> 5], 1u << (kk & 31));
    }
    if (a.s_tri > 0 && tri && !pad) {
      tn = min(m[4], a.s_tri);
      toff = a.tg2d ? bidx * a.s_tri : m[3];
    }
    bounds(a.bg_cols, boff, bn, t0, t1, blo, bhi);
    bounds(a.tg_cols, toff, tn, t0, t1, tlo, thi);
  }
  s.blo[kk] = blo;
  s.bhi[kk] = bhi;
  s.tlo[kk] = tlo;
  s.thi[kk] = thi;
}

// (orderable cand, ~k): a larger key is a larger cand, else a smaller k.
__device__ __forceinline__ unsigned long long pack(float c, int k) {
  uint32_t u = __float_as_uint(c);
  if (u == 0x80000000u) u = 0u;                  // -0.0 orders as +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (uint32_t)(0xffffffffu - (uint32_t)k);
}

__device__ __forceinline__ float key_cand(unsigned long long key) {
  const uint32_t u = (uint32_t)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_k(unsigned long long key) {
  return (int)(0xffffffffu - (uint32_t)key);
}

// (c, k) after (best, bk) in the order of the result: the greater cand,
// else the smaller k (bk NONE: no candidate yet).
__device__ __forceinline__ bool before(float c, int k, float best, int bk) {
  return bk == NONE || c > best || (c == best && k < bk);
}

// cand of exit kk (k0 + kk) at column e (local l) with LM score lm: the
// overlaid pairs' path, from the column's tables in device memory.
__device__ __forceinline__ float pair_cand(const Args& a, const Smem& s,
                                           int svs, int kk, int e, float lm) {
  const float sel = a.isfill[e] ? a.fillpen[e] : lm + a.wpen;
  const int fb = s.fbk[kk];
  const uint64_t w = (uint64_t)a.acc[(int64_t)(fb >> 6) * a.nE + e];
  const bool ok = (w >> (fb & 63)) & 1u;
  const float sv = s.sv[(int)a.f0p[e] * svs + kk];
  return ((sv + sel) + (ok ? 0.0f : -1e30f)) + s.add[kk];
}

// N consecutive floats / words at p (16-, 8- or 4-byte aligned).
template <int N>
__device__ __forceinline__ void load_n(const float* __restrict__ p,
                                       float* v) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void load_n(const uint32_t* p, uint32_t* v) {
  if constexpr (N == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (N == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

// Mode C holds no dense rows in registers: three blocks per SM.
template <int MODE, int CPT, bool ACCR>
__global__ void __launch_bounds__(TPB, MODE == CSR ? 3 : 2)
transitions_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KS = a.ks, KC = a.kc;
  const Layout L = layout(MODE, CPT, KS, KC, a.NRC, ACCR ? 0 : a.nw);
  const Smem s = carve(smem, L, KC, KS);
  const int TILE = L.tile, SVS = L.svs;
  const int tid = threadIdx.x;
  const int TPS = TPB / KS;
  const int sp = tid / TPS;                 // this thread's split
  const int l0 = (tid - sp * TPS) * CPT;    // its first column in the tile
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int t1 = min(t0 + TILE, a.nE);
  const int e0 = t0 + l0;
  const int nlive = max(min(CPT, t1 - e0), 0);
  const float* lmtab = MODE == ROWS ? a.rows
                                    : (MODE == SPARSE ? a.bg : a.fat_rows);

  // this thread's columns: tables and running best in registers
  int svo[CPT], bk[CPT];
  bool fill[CPT];
  float pen[CPT], uni[CPT], best[CPT];
  uint32_t alo[CPT], ahi[CPT];
  bool anyfill = false;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const bool live = j < nlive;
    const int e = live ? e0 + j : t0;
    svo[j] = live ? (int)a.f0p[e] * SVS : 0;
    fill[j] = live && a.isfill[e];
    anyfill |= fill[j];
    pen[j] = live ? a.fillpen[e] : 0.0f;
    uni[j] = MODE == CSR && live ? a.uni_row[e] : 0.0f;
    const uint64_t w = ACCR && live ? (uint64_t)a.acc[e] : 0;
    alo[j] = (uint32_t)w;
    ahi[j] = (uint32_t)(w >> 32);
    best[j] = -__int_as_float(0x7f800000);   // -inf
    bk[j] = NONE;
  }
  if (MODE != ROWS)
    for (int i = tid; i < TILE; i += TPB) s.key[i] = 0ull;
  if (MODE == CSR && tid < 4) s.fatw[tid] = 0u;
  if (!ACCR)
    for (int i = tid; i < 2 * a.nw * TILE; i += TPB) {
      const int w = i / TILE, l = i - w * TILE;
      const uint64_t x = t0 + l < t1
          ? (uint64_t)a.acc[(int64_t)(w >> 1) * a.nE + t0 + l] : 0;
      s.acc[i] = (w & 1) ? (uint32_t)(x >> 32) : (uint32_t)x;
    }

  // cand of exit kk at this thread's column j with LM score lm (FILL:
  // the thread has a filler column)
  auto cand_of = [&](auto fillc, int j, int kk, float sv, float lm,
                     uint32_t m0, uint32_t m1, float add) {
    float sel = lm + a.wpen;
    if constexpr (decltype(fillc)::value) sel = fill[j] ? pen[j] : sel;
    bool ok;
    if (ACCR)
      ok = ((alo[j] & m0) | (ahi[j] & m1)) != 0u;
    else
      ok = (s.acc[m0 * TILE + l0 + j] & m1) != 0u;
    return ((sv + sel) + (ok ? 0.0f : -1e30f)) + add;
  };

  int klast = 0;
  for (int k0 = 0; k0 < a.K; k0 += KC) {
    klast = k0;
    const int n = min(KC, a.K - k0);
    const int n4 = (n + 3) & ~3;
    __syncthreads();            // the previous chunk's readers are done
    // S0: the exits' metadata, their exit planes; the masks cleared
    for (int kk = tid; kk < n4; kk += TPB)
      stage_exit<MODE, ACCR>(a, s, b, k0, kk, n, t0, t1);
    for (int i = tid; i < a.NRC * n; i += TPB) {
      const int r = i / n, kk = i - r * n;
      s.sv[r * SVS + kk] = a.svk[((int64_t)b * a.NRC + r) * a.K + k0 + kk];
    }
    if (MODE != ROWS)
      for (int i = tid; i < n_masks(MODE) * L.mw * TILE; i += TPB)
        s.tm[i] = 0u;
    __syncthreads();
    if (MODE != ROWS) {
      // S1: mark the overlaid pairs
      for (int kk = tid; kk < n; kk += TPB) {
        const uint32_t bit = 1u << (kk & 31);
        const int w = (kk >> 5) * TILE;
        for (int i = s.tlo[kk]; i < s.thi[kk]; ++i)
          atomicOr(&s.tm[w + a.tg_cols[i] - t0], bit);
        if (MODE == CSR)
          for (int i = s.blo[kk]; i < s.bhi[kk]; ++i)
            atomicOr(&s.bm[w + a.bg_cols[i] - t0], bit);
      }
      __syncthreads();
      // S2a: the overlaid pairs' candidates into the per-column key
      for (int kk = tid; kk < n; kk += TPB) {
        const uint32_t bit = 1u << (kk & 31);
        const int w = (kk >> 5) * TILE;
        const int k = k0 + kk;
        for (int i = s.tlo[kk]; i < s.thi[kk]; ++i) {
          const int l = a.tg_cols[i] - t0;
          const float c = pair_cand(a, s, SVS, kk, t0 + l, a.tg_vals[i]);
          atomicMax(&s.key[l], pack(c, k));
        }
        if (MODE == CSR)
          for (int i = s.blo[kk]; i < s.bhi[kk]; ++i) {
            const int l = a.bg_cols[i] - t0;
            if (s.tm[w + l] & bit) continue;       // the trigram's value
            const float c = pair_cand(a, s, SVS, kk, t0 + l,
                                      a.bg_vals[i] + s.bo[kk]);
            atomicMax(&s.key[l], pack(c, k));
          }
      }
    }

    // S2b: the dense sweep over this split's exits of the chunk, 4 at a
    // time; mode C's fat exits after it
    const int per = ((n + KS - 1) / KS + 3) & ~3;
    const int gs = sp * per, ge = min(gs + per, n);
    if (nlive > 0 && gs < ge) {
      auto sweep = [&](auto fillc) {
        float cur[4][CPT], nxt[4][CPT];
        // the dense rows of exits g..g+3 at this thread's columns
        auto fetch = [&](int g, float (&v)[4][CPT]) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* p = lmtab + (int64_t)s.rix[g + q] * a.nE + e0;
            if (a.vec) {
              load_n<CPT>(p, v[q]);
            } else {
#pragma unroll
              for (int j = 0; j < CPT; ++j) v[q][j] = j < nlive ? p[j] : 0.0f;
            }
          }
        };
        if (MODE != CSR) fetch(gs, cur);
        uint32_t xw[CPT], fw = 0u;       // this 32-exit word's masks
        for (int g = gs; g < ge; g += 4) {
          if (MODE != CSR && g + 4 < ge)
            fetch(g + 4, nxt);           // in flight during this group
          const int sh = g & 31;
          if (MODE != ROWS && (sh == 0 || g == gs)) {
            const int w = (g >> 5) * TILE + l0;
            load_n<CPT>(s.tm + w, xw);
            if (MODE == CSR) {
              uint32_t u[CPT];
              load_n<CPT>(s.bm + w, u);
#pragma unroll
              for (int j = 0; j < CPT; ++j) xw[j] |= u[j];
              fw = s.fatw[g >> 5];
            }
          }
          const float4 add = *reinterpret_cast<const float4*>(s.add + g);
          const float4 bo = *reinterpret_cast<const float4*>(s.bo + g);
          const float4 bo1 = *reinterpret_cast<const float4*>(s.bo1 + g);
          const uint4 m0 = *reinterpret_cast<const uint4*>(s.m0 + g);
          const uint4 m1 = *reinterpret_cast<const uint4*>(s.m1 + g);
          const float addq[4] = {add.x, add.y, add.z, add.w};
          const float boq[4] = {bo.x, bo.y, bo.z, bo.w};
          const float bo1q[4] = {bo1.x, bo1.y, bo1.z, bo1.w};
          const uint32_t m0q[4] = {m0.x, m0.y, m0.z, m0.w};
          const uint32_t m1q[4] = {m1.x, m1.y, m1.z, m1.w};
          // exits past this split's range, and mode C's fat exits, are
          // not swept
          uint32_t out = ge - g >= 4 ? 0u : (0xfu << (ge - g)) & 0xfu;
          if (MODE == CSR) out |= (fw >> sh) & 0xfu;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const uint32_t ex = MODE == ROWS ? out
                                             : out | ((xw[j] >> sh) & 0xfu);
            const float4 sv4 = *reinterpret_cast<const float4*>(
                s.sv + svo[j] + g);
            const float svq[4] = {sv4.x, sv4.y, sv4.z, sv4.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float lm;
              if (MODE == ROWS)
                lm = cur[q][j];
              else if (MODE == SPARSE)
                lm = cur[q][j] + boq[q];
              else
                lm = (uni[j] + bo1q[q]) + boq[q];
              const float c = cand_of(fillc, j, g + q, svq[q], lm, m0q[q],
                                      m1q[q], addq[q]);
              if (!((ex >> q) & 1u) && c > best[j]) {
                best[j] = c;
                bk[j] = k0 + g + q;
              }
            }
          }
          if (MODE != CSR && g + 4 < ge) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int j = 0; j < CPT; ++j) cur[q][j] = nxt[q][j];
          }
        }
        if (MODE == CSR) {
          // the fat exits: their dense rows, merged in the result's order
          for (int w = gs >> 5; w <= (ge - 1) >> 5; ++w) {
            const int lo = max(gs - 32 * w, 0), hi = min(ge - 32 * w, 32);
            uint32_t bits = s.fatw[w] & (hi >= 32 ? ~0u : (1u << hi) - 1u)
                            & ~((1u << lo) - 1u);
            uint32_t xm[CPT];
            load_n<CPT>(s.tm + w * TILE + l0, xm);
            while (bits) {
              const int kk = 32 * w + __ffs(bits) - 1;
              bits &= bits - 1u;
              const float* p = lmtab + (int64_t)s.rix[kk] * a.nE + e0;
              float v[CPT];
              if (a.vec) {
                load_n<CPT>(p, v);
              } else {
#pragma unroll
                for (int j = 0; j < CPT; ++j) v[j] = j < nlive ? p[j] : 0.0f;
              }
#pragma unroll
              for (int j = 0; j < CPT; ++j) {
                const float c = cand_of(
                    fillc, j, kk, s.sv[svo[j] + kk], v[j] + s.bo[kk],
                    s.m0[kk], s.m1[kk], s.add[kk]);
                if (!((xm[j] >> (kk & 31)) & 1u)
                    && before(c, k0 + kk, best[j], bk[j])) {
                  best[j] = c;
                  bk[j] = k0 + kk;
                }
              }
            }
          }
        }
      };
      // mode C: a thread with no filler column skips the filler select
      // (in modes rows and B the second copy of the loop was slower)
      if (MODE == CSR && !anyfill)
        sweep(std::false_type{});
      else
        sweep(std::true_type{});
    }

    if (MODE == CSR) {
      __syncthreads();
      // S3: the overlay winner's successor context, where this chunk
      // holds the winner
      if (tid < 4) s.fatw[tid] = 0u;
      for (int kk = tid; kk < n; kk += TPB) {
        const uint32_t bit = 1u << (kk & 31);
        const int w = (kk >> 5) * TILE;
        const int k = k0 + kk;
        for (int i = s.blo[kk]; i < s.bhi[kk]; ++i) {
          const int l = a.bg_cols[i] - t0;
          if (key_k(s.key[l]) == k) s.cctx[l] = a.bg_ctx[i];
        }
        const int r = s.rix[kk];
        for (int i = s.tlo[kk]; i < s.thi[kk]; ++i) {
          const int l = a.tg_cols[i] - t0;
          if (!(s.bm[w + l] & bit) && key_k(s.key[l]) == k)
            s.cctx[l] = r >= 0 ? a.fat_ctx[(int64_t)r * a.nE + t0 + l]
                               : a.ctx_base[t0 + l];
        }
      }
    }
  }

  // the splits' winners, then each column's merge and payloads (the last
  // chunk's exits from shared memory)
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    s.pbest[sp * TILE + l0 + j] = best[j];
    s.pk[sp * TILE + l0 + j] = bk[j];
  }
  __syncthreads();
  for (int l = tid; l < t1 - t0; l += TPB) {
    float bv = s.pbest[l];
    int k = s.pk[l];
    for (int q = 1; q < KS; ++q) {
      const float c = s.pbest[q * TILE + l];
      const int kq = s.pk[q * TILE + l];
      if (kq != NONE && before(c, kq, bv, k)) {
        bv = c;
        k = kq;
      }
    }
    bool ov = false;
    if (MODE != ROWS) {
      const unsigned long long key = s.key[l];
      if (key && before(key_cand(key), key_k(key), bv, k)) {
        bv = key_cand(key);
        k = key_k(key);
        ov = true;
      }
    }
    if (k == NONE) k = 0;                 // every cand -inf
    const int e = t0 + l;
    int c, rw1, rw2, fr = -1;
    int64_t wid, fb;
    if (k >= klast) {
      const int kk = k - klast;
      c = s.pc[kk];
      rw1 = s.rw1[kk];
      rw2 = s.rw2[kk];
      wid = s.ki[kk];
      fb = s.fbk[kk];
      if (MODE == CSR) fr = s.rix[kk];
    } else {
      int bidx;
      c = a.ctx[b * a.ctx_ld + k];
      history<MODE>(a, c, rw1, rw2, bidx);
      wid = a.ki[b * a.ki_ld + k];
      fb = a.fb[b * a.fb_ld + k];
      if (MODE == CSR) fr = fat_row(a, min(rw1, a.V));
    }
    float cs;
    if (MODE == CSR)
      cs = ov ? s.cctx[l]
              : (fr >= 0 ? a.fat_ctx[(int64_t)fr * a.nE + e] : a.ctx_base[e]);
    else
      cs = a.ctx_next[(int64_t)max(rw1, 0) * a.nE + e];
    const bool real = a.isreal[e];
    const int64_t o = (int64_t)b * a.nE + e;
    a.entry[o] = bv;
    a.am[o] = k;
    a.prw[o] = wid;
    a.ctx_new[o] = a.isfill[e] ? c : (int32_t)cs;
    a.erw1[o] = real ? a.lmwid[e] : rw1;
    a.erw2[o] = real ? rw1 : rw2;
    a.fb_e[o] = fb;
  }
}

template <int MODE, int CPT, bool ACCR>
int launch(const Args& a, cudaStream_t stream) {
  const Layout L = layout(MODE, CPT, a.ks, a.kc, a.NRC, ACCR ? 0 : a.nw);
  // shared memory above 48 KB is an opt-in, once per card
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (L.total > 48 * 1024 && (dev >= 64 || !opted[dev])) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(transitions_kernel<MODE, CPT, ACCR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = true;
  }
  dim3 grid((a.nE + L.tile - 1) / L.tile, a.B);
  transitions_kernel<MODE, CPT, ACCR><<<grid, TPB, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

// One accept word per column is held in registers; more are staged.
template <int MODE, int CPT>
int launch_words(const Args& a, cudaStream_t st) {
  return a.nw == 1 ? launch<MODE, CPT, true>(a, st)
                   : launch<MODE, CPT, false>(a, st);
}

template <int MODE>
int launch_mode(const Args& a, int cpt, cudaStream_t st) {
  switch (cpt) {
    case 1: return launch_words<MODE, 1>(a, st);
    case 2: return launch_words<MODE, 2>(a, st);
    case 4: return launch_words<MODE, 4>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One frame's block on `stream`: mode 0 rows, 1 B ("sparse"), 2 C
// ("csr"); `cols_per_thread` 1, 2 or 4; `a->ks` 1, 2, 4 or 8 splits of the
// exits; `a->kc` a multiple of 32 (at most 128).  Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for an
// option it does not take.
extern "C" int transitions_launch(const Args* a, int mode,
                                  int cols_per_thread, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((a->ks != 1 && a->ks != 2 && a->ks != 4 && a->ks != 8)
      || a->kc <= 0 || a->kc % 32 || a->kc > 128 || a->nw < 1)
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case ROWS: return launch_mode<ROWS>(*a, cols_per_thread, st);
    case SPARSE: return launch_mode<SPARSE>(*a, cols_per_thread, st);
    case CSR: return launch_mode<CSR>(*a, cols_per_thread, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* transitions_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
