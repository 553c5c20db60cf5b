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
// What bounds it on an H100: bytes.  The outputs are 40 bytes per (b, e);
// the inputs are the [B, K] exits, their [B, NRC, K] exit planes, the
// [E] column tables, and the LM rows the exits' contexts select (mode
// rows and B: a dense [E] row per exit; mode C: the few CSR and trigram
// entries of each exit).  The eager torch block materialises 35-45
// [B, K, E] temporaries instead.
//
// What the design does about it:
//   * grid (column tiles, B): a block of TPB threads owns TPB * CPT
//     columns of one utterance, each thread CPT columns TPB apart
//     (coalesced), and keeps each column's tables (f0p, filler flag and
//     penalty, the accept bits, mode C's unigram and context base) and
//     its running best, first k and winner context in registers across
//     all K exits: one pass over k writes each output once;
//   * the exits are staged in shared memory KC at a time: their metadata
//     (formed in the kernel from kv/ctx/fb and bgmeta/umeta: the LM row,
//     the backoffs, the overlay lists) and their exit planes [KC][NRC],
//     read by every column of the block;
//   * accept[fb, e] is 0 or 1: `accept_bits[e]` packs column e's row of
//     the accept table (one bit per CI phone), so it is read once per
//     column instead of once per (k, e);
//   * the sparse overlays (mode C's CSR bigrams and contexts, the
//     trigram corrections) are scattered per exit into a double-buffered
//     column tile in shared memory, stamped with the exit's k, so nothing
//     is cleared: exit k+1's entries are loaded while exit k's columns
//     are computed, and one barrier per exit separates the two;
//   * modes rows and B read the exit's dense LM row at the thread's
//     columns one exit ahead (coalesced, from L2 when exits share it).
//
// Exactness: the float operations of the plain version in its order
// (base + bo1w is formed even where an overlay replaces it; + 0.0f stays
// an add); built with --fmad=false.  Columns are unique within one
// history's CSR row and one context's trigram row, so the scatter order
// does not matter; an id outside the column range (a split part's spare
// column) is dropped.

#include <cuda_runtime.h>
#include <stdint.h>

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
  const int64_t* acc;
  const float* rows;
  const float* rows_h;
  const float* bg;
  const float* ctx_next;
  const int32_t* bgmeta;
  const float* uni_row;
  const float* ctx_base;
  const int32_t* umeta;
  const int64_t* bg_cols;
  const float* bg_vals;
  const float* bg_ctx;
  const float* fat_rows;
  const float* fat_ctx;
  const int32_t* tg_cols;
  const float* tg_vals;
  float* entry;
  int64_t* am;
  int64_t* prw;
  int32_t* ctx_new;
  int32_t* erw1;
  int32_t* erw2;
  int64_t* fb_e;
  int64_t kv_ld, ki_ld, ctx_ld, fb_ld;
  int32_t B, K, NRC, nE, V, n_bg, s_tri, sb, n_fat, tg2d, kc;
  float wpen;
};

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TPB = 256;               // threads per block

enum { ROWS = 0, SPARSE = 1, CSR = 2 };

// Overlay arrays per column tile and buffer: mode B the trigram value and
// stamp, mode C also the bigram value, context and stamp.
__host__ __device__ constexpr int n_overlay(int mode) {
  return mode == CSR ? 5 : (mode == SPARSE ? 2 : 0);
}

// One block's shared memory (ops/transitions.py `_smem_bytes`).
__host__ __device__ size_t smem_bytes(int mode, int kc, int nrc, int tile) {
  return (size_t)24 * kc + (size_t)4 * kc * (nrc + 6)
         + (size_t)4 * n_overlay(mode) * 2 * tile;
}

struct Smem {
  int64_t *row, *bgoff, *toff;          // [kc]
  float *sv;                            // [kc][NRC]
  float *add, *bo, *bo1;                // [kc]
  int32_t *fbk, *bgn, *tn;              // [kc]
  int32_t *tst, *bst;                   // [2][tile] stamps (k), -1: none
  float *tval, *bval, *bctx;            // [2][tile]
};

__device__ Smem carve(unsigned char* p, int mode, int kc, int nrc,
                      int tile) {
  Smem s;
  s.row = (int64_t*)p;
  s.bgoff = s.row + kc;
  s.toff = s.bgoff + kc;
  s.sv = (float*)(s.toff + kc);
  s.add = s.sv + (size_t)kc * nrc;
  s.bo = s.add + kc;
  s.bo1 = s.bo + kc;
  s.fbk = (int32_t*)(s.bo1 + kc);
  s.bgn = s.fbk + kc;
  s.tn = s.bgn + kc;
  int32_t* o = s.tn + kc;
  s.tst = s.bst = nullptr;
  s.tval = s.bval = s.bctx = nullptr;
  if (mode != ROWS) {
    s.tst = o;
    s.tval = (float*)(o + 2 * tile);
    o += 4 * tile;
  }
  if (mode == CSR) {
    s.bst = o;
    s.bval = (float*)(o + 2 * tile);
    s.bctx = (float*)(o + 4 * tile);
  }
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

// Stage exit k = k0 + kk's metadata.
template <int MODE>
__device__ void stage_exit(const Args& a, const Smem& s, int b, int k0,
                           int kk) {
  const int k = k0 + kk;
  const float kv = a.kv[b * a.kv_ld + k];
  s.add[kk] = kv > NEG_INF / 2 ? 0.0f : NEG_INF;
  s.fbk[kk] = (int32_t)a.fb[b * a.fb_ld + k];
  const int c = a.ctx[b * a.ctx_ld + k];
  s.bgn[kk] = 0;
  s.tn[kk] = 0;
  s.bo[kk] = 0.0f;
  s.bo1[kk] = 0.0f;
  s.bgoff[kk] = 0;
  s.toff[kk] = 0;
  if (MODE == ROWS) {
    s.row[kk] = (int64_t)c * a.nE;
    return;
  }
  int rw1, rw2, bidx;
  history<MODE>(a, c, rw1, rw2, bidx);
  const bool tri = c > a.V;
  const int32_t* m = a.bgmeta + (int64_t)bidx * 8;
  s.bo[kk] = tri ? __int_as_float(m[2]) : 0.0f;
  const int h1c = min(rw1, a.V);
  if (MODE == SPARSE) {
    s.row[kk] = (int64_t)h1c * a.nE;
  } else {
    const int32_t* u = a.umeta + (int64_t)h1c * 4;
    const bool fat = a.n_fat > 0 && u[3] >= 0;
    s.row[kk] = fat ? (int64_t)min(max(u[3], 0), a.n_fat - 1) * a.nE : -1;
    s.bo1[kk] = __int_as_float(u[2]);
    s.bgn[kk] = fat ? 0 : min(u[1], a.sb);
    s.bgoff[kk] = u[0];
  }
  if (a.s_tri > 0 && tri) {
    s.tn[kk] = min(m[4], a.s_tri);
    s.toff[kk] = a.tg2d ? (int64_t)bidx * a.s_tri : (int64_t)m[3];
  }
}

// One overlay entry on its way from device memory to the column tile.
struct Entry {
  int64_t c;
  float v, x;
  bool live;
};

// Entry i of exit kk's CSR bigram row (mode C) / trigram row.
__device__ __forceinline__ Entry bigram(const Args& a, const Smem& s,
                                        int kk, int i) {
  Entry en{0, 0.0f, 0.0f, i < s.bgn[kk]};
  if (en.live) {
    const int64_t j = s.bgoff[kk] + i;
    en.c = a.bg_cols[j];
    en.v = a.bg_vals[j];
    en.x = a.bg_ctx[j];
  }
  return en;
}

__device__ __forceinline__ Entry trigram(const Args& a, const Smem& s,
                                         int kk, int i) {
  Entry en{0, 0.0f, 0.0f, i < s.tn[kk]};
  if (en.live) {
    const int64_t j = s.toff[kk] + i;
    en.c = a.tg_cols[j];
    en.v = a.tg_vals[j];
  }
  return en;
}

// Scatter an entry of exit k into buffer p of the tile [t0, t1).
__device__ __forceinline__ void put_bigram(const Smem& s, const Entry& en,
                                           int k, int p, int t0, int t1,
                                           int tile) {
  if (en.live && en.c >= t0 && en.c < t1) {
    const int l = p * tile + (int)(en.c - t0);
    s.bval[l] = en.v;
    s.bctx[l] = en.x;
    s.bst[l] = k;
  }
}

__device__ __forceinline__ void put_trigram(const Smem& s, const Entry& en,
                                            int k, int p, int t0, int t1,
                                            int tile) {
  if (en.live && en.c >= t0 && en.c < t1) {
    const int l = p * tile + (int)(en.c - t0);
    s.tval[l] = en.v;
    s.tst[l] = k;
  }
}

// Every overlay entry of exit kk (k = k0 + kk) past the first TPB of
// each list, or all of them (from = 0).
template <int MODE>
__device__ void scatter_exit(const Args& a, const Smem& s, int kk, int k,
                             int from, int t0, int t1, int tile) {
  const int p = k & 1;
  if (MODE == CSR)
    for (int i = from + threadIdx.x; i < s.bgn[kk]; i += TPB)
      put_bigram(s, bigram(a, s, kk, i), k, p, t0, t1, tile);
  for (int i = from + threadIdx.x; i < s.tn[kk]; i += TPB)
    put_trigram(s, trigram(a, s, kk, i), k, p, t0, t1, tile);
}

template <int MODE, int CPT>
__global__ void __launch_bounds__(TPB)
transitions_kernel(const Args a) {
  constexpr int TILE = TPB * CPT;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(smem, MODE, a.kc, a.NRC, TILE);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int t1 = min(t0 + TILE, a.nE);
  const int NRC = a.NRC;
  const float* lmtab = MODE == ROWS ? a.rows : a.bg;

  // this thread's columns: tables and running best in registers
  bool live[CPT], fill[CPT];
  int f0p[CPT], bk[CPT];
  float pen[CPT], uni[CPT], cbase[CPT], best[CPT], bctx[CPT], cur[CPT];
  uint64_t acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int e = t0 + tid + j * TPB;
    live[j] = e < t1;
    const int ec = live[j] ? e : t0;
    f0p[j] = live[j] ? (int)a.f0p[ec] : 0;
    fill[j] = live[j] && a.isfill[ec];
    pen[j] = live[j] ? a.fillpen[ec] : 0.0f;
    acc[j] = live[j] ? (uint64_t)a.acc[ec] : 0;
    uni[j] = MODE == CSR && live[j] ? a.uni_row[ec] : 0.0f;
    cbase[j] = MODE == CSR && live[j] ? a.ctx_base[ec] : 0.0f;
    best[j] = NEG_INF;
    bk[j] = 0;
    bctx[j] = 0.0f;
    cur[j] = 0.0f;
  }
  if (MODE != ROWS)
    for (int i = tid; i < 2 * TILE; i += TPB) {
      s.tst[i] = -1;
      if (MODE == CSR) s.bst[i] = -1;
    }

  for (int k0 = 0; k0 < a.K; k0 += a.kc) {
    const int n = min(a.kc, a.K - k0);
    __syncthreads();            // the previous chunk's readers are done
    for (int kk = tid; kk < n; kk += TPB) stage_exit<MODE>(a, s, b, k0, kk);
    for (int i = tid; i < n * NRC; i += TPB) {
      const int r = i / n, kk = i - r * n;
      s.sv[kk * NRC + r] = a.svk[((int64_t)b * NRC + r) * a.K + k0 + kk];
    }
    __syncthreads();
    if (MODE != ROWS) {
      scatter_exit<MODE>(a, s, 0, k0, 0, t0, t1, TILE);
      __syncthreads();
    }
    if (MODE != CSR) {
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        if (live[j]) cur[j] = lmtab[s.row[0] + t0 + tid + j * TPB];
    }
    for (int kk = 0; kk < n; ++kk) {
      const int k = k0 + kk;
      const int p = k & 1;
      const bool more = kk + 1 < n;
      // the next exit's loads, in flight while this exit is computed
      float nxt[CPT];
      if (MODE != CSR) {
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          nxt[j] = more && live[j]
                       ? lmtab[s.row[kk + 1] + t0 + tid + j * TPB] : 0.0f;
      }
      Entry nb{0, 0.0f, 0.0f, false}, nt{0, 0.0f, 0.0f, false};
      if (MODE == CSR && more) nb = bigram(a, s, kk + 1, tid);
      if (MODE != ROWS && more) nt = trigram(a, s, kk + 1, tid);

      const float add = s.add[kk];
      const uint32_t fb = (uint32_t)s.fbk[kk] & 63u;
      const float bo = s.bo[kk];
      const float bo1 = s.bo1[kk];
      const int64_t row = s.row[kk];
      const float* sv = s.sv + kk * NRC;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if (!live[j]) continue;
        const int l = tid + j * TPB;
        const int e = t0 + l;
        float lm;
        bool hit = false;              // mode C: a CSR bigram at (k, e)
        if (MODE == ROWS) {
          lm = cur[j];
        } else {
          float base;
          if (MODE == SPARSE) {
            base = cur[j];
          } else if (row >= 0) {           // a fat history's dense row
            base = a.fat_rows[row + e];
          } else {
            base = uni[j] + bo1;
            hit = s.bst[p * TILE + l] == k;
            if (hit) base = s.bval[p * TILE + l];
          }
          lm = base + bo;
          if (s.tst[p * TILE + l] == k) lm = s.tval[p * TILE + l];
        }
        const float sel = fill[j] ? pen[j] : lm + a.wpen;
        const float accm = ((acc[j] >> fb) & 1u) ? 1.0f : 0.0f;
        const float cand = ((sv[f0p[j]] + sel) + (accm - 1.0f) * 1e30f)
                           + add;
        if (k == 0 || cand > best[j]) {
          best[j] = cand;
          bk[j] = k;
          if (MODE == CSR)             // the winner's successor context
            bctx[j] = row >= 0 ? a.fat_ctx[row + e]
                               : (hit ? s.bctx[p * TILE + l] : cbase[j]);
        }
      }
      if (MODE != CSR) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) cur[j] = nxt[j];
      }
      if (MODE != ROWS && more) {
        if (MODE == CSR) put_bigram(s, nb, k + 1, p ^ 1, t0, t1, TILE);
        put_trigram(s, nt, k + 1, p ^ 1, t0, t1, TILE);
        scatter_exit<MODE>(a, s, kk + 1, k + 1, TPB, t0, t1, TILE);
      }
      if (MODE != ROWS) __syncthreads();
    }
  }

  // the winners' payloads
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    if (!live[j]) continue;
    const int e = t0 + tid + j * TPB;
    const int k = bk[j];
    const int c = a.ctx[b * a.ctx_ld + k];
    int rw1, rw2, bidx;
    history<MODE>(a, c, rw1, rw2, bidx);
    const float cs = MODE == CSR
                         ? bctx[j]
                         : a.ctx_next[(int64_t)max(rw1, 0) * a.nE + e];
    const bool real = a.isreal[e];
    const int64_t o = (int64_t)b * a.nE + e;
    a.entry[o] = best[j];
    a.am[o] = k;
    a.prw[o] = a.ki[b * a.ki_ld + k];
    a.ctx_new[o] = fill[j] ? c : (int32_t)cs;
    a.erw1[o] = real ? a.lmwid[e] : rw1;
    a.erw2[o] = real ? rw1 : rw2;
    a.fb_e[o] = a.fb[b * a.fb_ld + k];
  }
}

template <int MODE, int CPT>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int TILE = TPB * CPT;
  const size_t bytes = smem_bytes(MODE, a.kc, a.NRC, TILE);
  // shared memory above 48 KB is an opt-in, once per card
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > 48 * 1024 && (dev >= 64 || !opted[dev])) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(transitions_kernel<MODE, CPT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = true;
  }
  dim3 grid((a.nE + TILE - 1) / TILE, a.B);
  transitions_kernel<MODE, CPT><<<grid, TPB, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One frame's block on `stream`: mode 0 rows, 1 B ("sparse"), 2 C
// ("csr"); `cols_per_thread` 1, 2 or 4.  Returns cudaGetLastError() after
// the launch; cudaErrorInvalidValue for a mode or column count it does
// not take.
extern "C" int transitions_launch(const Args* a, int mode,
                                  int cols_per_thread, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define TR_LAUNCH(M)                                   \
  switch (cols_per_thread) {                           \
    case 1: return launch<M, 1>(*a, st);               \
    case 2: return launch<M, 2>(*a, st);               \
    case 4: return launch<M, 4>(*a, st);               \
    default: return (int)cudaErrorInvalidValue;        \
  }
  switch (mode) {
    case ROWS: TR_LAUNCH(ROWS)
    case SPARSE: TR_LAUNCH(SPARSE)
    case CSR: TR_LAUNCH(CSR)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TR_LAUNCH
}

extern "C" const char* transitions_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
