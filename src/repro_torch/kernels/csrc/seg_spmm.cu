// Per-tile segmented multi-RHS (SpMM) kernels K10a, K10b and K11 for
// Hopper (sm_90a).
//
// Replace the Pallas TPU kernels in src/repro/kernels/seg_spmv.py:
//   K10a seg_spmm_pallas, mode seg_scan   (_seg_scan_spmm_partial) ->
//        seg_spmm mode 0
//   K10b seg_spmm_pallas, mode onehot_mxu (_onehot_spmm_partial)   ->
//        seg_spmm mode 1
//   K11  seg_spmm_fused_pallas, both modes (_seg_spmm_fused_kernel) ->
//        seg_spmm with fused = 1
//
// Bound on the H100: device-memory bytes. Each nnz slot is read once: vals
// and cols (8 bytes in fp32/int32), plus local_row for one-hot (12 bytes);
// seg_end is M ints a tile. Each tile writes M*B partials (K10), or K11
// reads and writes y once; x is gathered from L1/L2, where it fits. At
// B = 8 a slot costs 8-12 bytes for 2*B = 16 flops, 1.3-2 flops a byte,
// far below the card's ridge.
//
// What each computes (the Pallas kernels' function):
//  * onehot_mxu (K10b): partial[m, b] = sum of vals * x[col, b] over the
//    slots whose local row is m; a local row outside [0, M) adds nothing.
//  * seg_scan (K10a): with S(e) the sum of the tile's first e products,
//    g[m] = S(clamp(end[m], 0, C)) and partial[m] = g[m] - g[m-1].
//  * fused (K11): tile t's partials are added into y[r0[t] + m, :]. The
//    TPU does it on a resident output block in grid order; blocks on the
//    GPU run in any order, so here the wrapper's FusedRows
//    (combine.fused_rows, built once per plan) gives each (tile,
//    segment) its row where no other tile adds into that row, added
//    there by its one writer. A row that several tiles share is added
//    inside this launch, in (tile, segment) order, by the last of its
//    partials to arrive (flush.cuh): a row of two column by column
//    through 64-bit exchange cells, as the flush writes them; a longer
//    row, or any row at more than flush::kCellCols columns, through side
//    slots (a slot's columns may be written over several windows) and,
//    after a window's last columns, one arrival a pair on the row's
//    counter, the rows whose last slot the block wrote listed in shared
//    memory and added a thread a column. That order is the ordered
//    combine's (rowmap_combine.cu), so the bits are those of the unfused
//    partials combined by it. One plan's fused step runs on one stream
//    at a time (the cells and counters are the plan's). Empty segments
//    and rows outside [0, n_rows) map to nothing (the TPU clamps an
//    out-of-range slice write, the GPU would corrupt memory).
//
// Design: the blocked run reduction of runs.cuh, for B columns. A block
// takes the ceil(2048 / C) tiles of one pass of 2048 slots, so that a pass
// spans several small tiles (the searched serving plan has C = 512), and
// walks them in windows of whole tiles whose (tile, segment) keys and
// columns fit its shared accumulator acc[key][column] (above 48 KB
// through the opt-in for dynamic shared memory; where one tile's M x B
// does not fit, fewer columns per window, and where M alone does not fit,
// part of a tile's keys: those windows read the tile again). In each pass
// a thread loads its 8 slots' indices once (16-byte loads when C % 8 == 0
// and the arrays are 16-byte aligned, checked on the host) and keeps them
// in registers while it loops over the window's columns; with vector
// loads, 4 columns per x gather when B % 4 == 0 and x is aligned
// (spmm::load_cols), and in one-hot mode at B % 8 == 0 two lanes hold the
// same 8 slots, 4 columns each; otherwise 1 column per gather.
// Runs of equal key are summed in registers and over the warp; the thread
// that ends a run adds it into acc with one shared atomicAdd per column,
// and the runs at a warp's two ends go through its boundary slots, folded
// in a fixed order when kRing passes are done and at the window's end
// (runs.cuh).
// The window then writes out[t, m, :] (K10) or adds into y (K11). The
// kernel is held to 85 registers, so that three blocks share an SM.
//  * The key of a one-hot slot is its local row.
//  * A seg_scan slot's segment is read from seg_end, so no local row is
//    stored or loaded: in a tile whose clamped ends ascend (the packer's
//    tiles: each tile's ends in order, end = C for unused segments), slot
//    c lies in segment m = #{m' : end[m'] <= c}, an upper bound over the
//    tile's ends. A slot at or past the last end is in no segment and adds
//    nothing (unused slots, padding tiles whose ends are all 0), and an
//    empty segment gets an exact zero.
//  * Where a tile's clamped ends descend anywhere (never packed, but
//    accepted by the plain version and the Pallas kernel), g[m] - g[m-1]
//    is a signed range sum. The block finds such tiles with one
//    __syncthreads_or over the window's M comparisons, keys their slots
//    kNone, and sums each of their segments with a warp over
//    [min, max) of its two ends (spmm::range_dot), negated when they
//    descend. That path is slow and exact.
// No tensor cores: the TPU's one-hot product does C*M*B multiply-adds for
// C*B useful ones, and with fp32 operands mma/wgmma would round the
// products to TF32 (10-bit mantissa), near the search's 1e-3 * max|y|
// tolerance. The gains here come from fewer and wider loads of the format
// (16-byte, evict-first), gathers of x that stay in L1/L2, no chain of
// dependent loads, and few atomics. Staging the next pass's slots in
// shared memory (cp.async / TMA) is not done.
// The sums are taken in another order than the plain version's scan, so
// results agree with it to a tolerance; from call to call they are
// bit-identical for sorted keys (the packers' tiles).
#include <climits>

#include "flush.cuh"
#include "runs.cuh"
#include "spmm.cuh"

namespace {

using runs::kNone;
using runs::kPass;
using runs::kPer;
using runs::load_run;
using spmm::kThreads;
using spmm::kWarps;

constexpr int kSegScan = 0, kOnehot = 1;  // the host's modes
constexpr int kMaxWinTiles = 64;          // tiles of one window
// at most 85 registers a thread, so that three blocks share an SM: two
// blocks at the 101-107 registers the kernel takes unbounded were slower
// on the card
constexpr int kMinBlocks = 3;

__device__ __forceinline__ int clamp_end(int e, int Cn) {
  return e < 0 ? 0 : (e > Cn ? Cn : e);
}

// #{m : clamp(end[m]) <= c} over a tile's M ends that ascend once clamped
__device__ __forceinline__ int seg_of(const int* __restrict__ end, int M,
                                      int Cn, int c) {
  int lo = 0, hi = M;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (clamp_end(end[mid], Cn) <= c) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One window of a block's tile group: keys [k0, k0 + nk) of the group
// (key = group tile * M + segment) over the slots of its tiles.
struct Window {
  long long t0;    // the group's first tile
  long long k0;    // the window's first key
  int nk;          // its keys
  int ta;          // its first tile, in the group
  long long base;  // the global slot of tile t0 + ta
  int n;           // the slots of its tiles
};

// The window key of segment m of the window's tile tr, or kNone when m is
// not a segment or the key lies outside the window.
__device__ __forceinline__ int window_key(const Window& w, int M, int tr,
                                          int m) {
  if ((unsigned)m >= (unsigned)M) return kNone;
  const long long key = (long long)(w.ta + tr) * M + m - w.k0;
  return (unsigned long long)key < (unsigned long long)w.nk ? (int)key
                                                            : kNone;
}

// This thread's kPer slots from slot s of the window: keys, cols, vals.
// desc[tr] marks the window's tiles whose ends descend (seg_scan).
template <int kMode, bool kVec, typename V, typename C>
__device__ __forceinline__ void load_slots(
    const V* __restrict__ vals, const C* __restrict__ cols,
    const int* __restrict__ aux, const Window& w, int s, int Cn, int M,
    const int* desc, int (&key)[kPer], int (&col)[kPer], float (&v)[kPer]) {
  if constexpr (kVec) {  // Cn % kPer == 0: the slots are in one tile
    if (s >= w.n) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) key[k] = kNone, col[k] = -1, v[k] = 0.f;
      return;
    }
    const long long i = w.base + s;
    load_run(cols + i, col);
    load_run(vals + i, v);
    const int tr = s / Cn, c = s - tr * Cn;
    if constexpr (kMode == kOnehot) {
      int l[kPer];
      load_run(aux + i, l);
#pragma unroll
      for (int k = 0; k < kPer; ++k) key[k] = window_key(w, M, tr, l[k]);
    } else if (desc[tr]) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) key[k] = kNone;
    } else {
      const int* end = aux + (w.t0 + w.ta + tr) * M;
      int m = seg_of(end, M, Cn, c);
      int next = m < M ? clamp_end(end[m], Cn) : INT_MAX;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        while (next <= c + k) {
          ++m;
          next = m < M ? clamp_end(end[m], Cn) : INT_MAX;
        }
        key[k] = window_key(w, M, tr, m);
      }
    }
  } else {
    int tr_prev = -1, m = 0;
    const int* end = aux;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      key[k] = kNone, col[k] = -1, v[k] = 0.f;
      const int sk = s + k;
      if (sk >= w.n) continue;
      const long long i = w.base + sk;
      col[k] = to_i32(cols[i]);
      v[k] = to_f32(vals[i]);
      const int tr = sk / Cn, c = sk - tr * Cn;
      if constexpr (kMode == kOnehot) {
        key[k] = window_key(w, M, tr, aux[i]);
      } else if (!desc[tr]) {
        if (tr != tr_prev) {
          end = aux + (w.t0 + w.ta + tr) * M;
          m = seg_of(end, M, Cn, c);
          tr_prev = tr;
        }
        while (m < M && clamp_end(end[m], Cn) <= c) ++m;
        key[k] = window_key(w, M, tr, m);
      }
    }
  }
}

// p[k][j] = v[k] * x[col[k], cc + j] for the slots that add something
template <int CW, typename X>
__device__ __forceinline__ void gather(const X* __restrict__ x, int n_cols,
                                       int B, int cc, const int (&key)[kPer],
                                       const int (&col)[kPer],
                                       const float (&v)[kPer],
                                       float (&p)[kPer][CW]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const bool in = key[k] != kNone && (unsigned)col[k] < (unsigned)n_cols;
    float xv[CW];
    spmm::load_cols<CW>(x + (long long)(in ? col[k] : 0) * B + cc, in, xv);
#pragma unroll
    for (int j = 0; j < CW; ++j) p[k][j] = v[k] * xv[j];
  }
}

// K10a / K10b / K11: a block per group of K tiles, walked in windows of
// nk keys (whole tiles when nk is a multiple of M) and cb columns; acc is
// the window's (nk, cb) accumulator. In a pass the G lanes of a group hold
// the same kPer slots, and each lane takes CW of every G * CW columns;
// bval (after acc) holds the boundary slots' sums. fused = 0: out[t, m,
// b]; fused = 1: y (out), an exchange cell or a side slot as f.dst[t * M
// + m] says, column b, for m below f.n_used[t]; after a window's last
// columns its counted pairs count in on their listed rows, and the block
// adds the rows whose last slot it wrote (flush.cuh), a thread a column.
template <int kMode, bool kVec, int CW, int G, typename V, typename C,
          typename X>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_runs_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                const int* __restrict__ aux, const X* __restrict__ x,
                int n_cols, int B, long long T, int Cn, int M, int K, int nk,
                int cb, int fused, float* __restrict__ out,
                const flush::Rows f) {
  extern __shared__ float acc[];  // nk * cb, then kRing * kSlots * cb
  __shared__ int desc[kMaxWinTiles];
  __shared__ int bkey[runs::kRing * runs::kSlots];
  __shared__ int n_last;  // listed rows the window's pairs completed
  float* bval = acc + (long long)nk * cb;  // the ring's boundary sums
  const int tid = threadIdx.x;
  Window w;
  w.t0 = (long long)blockIdx.x * K;
  const long long keys = (long long)min((long long)K, T - w.t0) * M;
  for (w.k0 = 0; w.k0 < keys; w.k0 += nk) {
    w.nk = (int)min((long long)nk, keys - w.k0);
    w.ta = (int)(w.k0 / M);
    const int tiles = (int)((w.k0 + w.nk - 1) / M) - w.ta + 1;
    w.base = (w.t0 + w.ta) * Cn;
    w.n = tiles * Cn;
    bool counted = false;  // this thread wrote a side slot of the window
    for (int c0 = 0; c0 < B; c0 += cb) {
      const int cend = min(B, c0 + cb);
      for (int i = tid; i < w.nk * cb; i += kThreads) acc[i] = 0.f;
      if (tid < tiles) desc[tid] = 0;
      if (tid == 0) n_last = 0;
      __syncthreads();
      bool any_desc = false;
      if constexpr (kMode == kSegScan) {
        bool found = false;
        for (int i = tid; i < tiles * M; i += kThreads) {
          const int tr = i / M, m = i - tr * M;
          const int* end = aux + (w.t0 + w.ta + tr) * M;
          if (m > 0 && clamp_end(end[m], Cn) < clamp_end(end[m - 1], Cn)) {
            desc[tr] = 1;
            found = true;
          }
        }
        any_desc = __syncthreads_or(found);
      }
      int ring = 0;  // passes in the ring
      for (int s0 = 0; s0 < w.n; s0 += kPass / G) {
        int key[kPer], col[kPer];
        float v[kPer];
        load_slots<kMode, kVec>(vals, cols, aux, w, s0 + tid / G * kPer, Cn,
                                M, desc, key, col, v);
        const runs::Runs r = runs::run_structure<G>(key);
        int* bk = bkey + ring * runs::kSlots;
        float* bv = bval + ring * runs::kSlots * cb;
        for (int cc = c0 + tid % G * CW; cc < cend; cc += G * CW) {
          float p[kPer][CW];
          gather<CW>(x, n_cols, B, cc, key, col, v, p);
          runs::add_runs<CW, G>(r, key, p, acc, cb, cc - c0, bk, bv);
        }
        if (++ring == runs::kRing && s0 + kPass / G < w.n) {
          __syncthreads();
          runs::fold_boundary(bkey, bval, cb, cend - c0,
                              ring * runs::kSlots, acc);
          __syncthreads();
          ring = 0;
        }
      }
      __syncthreads();
      // the fold and the descending tiles' sums write different keys
      runs::fold_boundary(bkey, bval, cb, cend - c0, ring * runs::kSlots,
                          acc);
      if (kMode == kSegScan && any_desc) {
        // a warp per segment of a tile whose ends descend: the signed sum
        // over [min, max) of its two clamped ends
        const int lane = tid & 31, bc = spmm::col_chunk(cend - c0);
        const int g = lane / bc, j = lane % bc, groups = 32 / bc;
        for (int q = tid >> 5; q < w.nk; q += kWarps) {  // warp-uniform
          const long long gk = w.k0 + q;
          const int tr = (int)(gk / M) - w.ta, m = (int)(gk % M);
          if (!desc[tr]) continue;
          const int* end = aux + (w.t0 + w.ta + tr) * M;
          int hi = clamp_end(end[m], Cn);
          int lo = m > 0 ? clamp_end(end[m - 1], Cn) : 0;
          const float sign = hi < lo ? -1.f : 1.f;
          if (hi < lo) {
            const int tmp = hi;
            hi = lo;
            lo = tmp;
          }
          const long long tb = (w.t0 + w.ta + tr) * Cn;
          for (int cc = c0; cc < cend; cc += bc) {
            const int b = cc + j;
            float a = spmm::range_dot(vals, cols, x, n_cols, B, tb + lo,
                                      tb + hi, b, g, groups);
            a = spmm::reduce_groups(a, bc);
            if (g == 0 && b < cend) acc[q * cb + (b - c0)] = sign * a;
          }
        }
      }
      __syncthreads();
      const int cw = cend - c0;
      for (int i = tid; i < w.nk * cw; i += kThreads) {
        const int q = i / cw, b = c0 + (i - q * cw);
        const long long gk = w.k0 + q;
        const long long t = w.t0 + gk / M;
        const int m = (int)(gk % M);
        if (fused && m >= __ldg(f.n_used + t)) continue;  // empty segment
        const float sum = acc[q * cb + (b - c0)];
        if (fused) {
          const int d = __ldg(f.dst + t * M + m);
          const long long row = (long long)__ldg(f.r0 + t) + m;
          if (d >= 0) {  // one writer: the atomic's result is y + sum
            atomicAdd(out + (long long)d * B + b, sum);
          } else if (flush::exchanged(d, B)) {
            flush::exchange(out, f, d, row * B + b, b, sum);
          } else if (d != -1) {
            f.side[flush::slot_of(f, d) * B + b] = sum;
            counted = true;
          }
        } else {
          out[(t * M + m) * B + b] = sum;
        }
      }
      // every column of the window's side slots is written: a thread a
      // counted pair counts in, and the rows whose last slot this was are
      // listed in acc, whose sums are all read
      if (fused && cend == B && __syncthreads_or(counted)) {
        int* last = reinterpret_cast<int*>(acc);
        for (int q = tid; q < w.nk; q += kThreads) {
          const long long gk = w.k0 + q;
          const long long t = w.t0 + gk / M;
          const int m = (int)(gk % M);
          if (m >= __ldg(f.n_used + t)) continue;
          const int d = __ldg(f.dst + t * M + m);
          if (d >= -1 || flush::exchanged(d, B)) continue;
          const int u = __ldg(f.slot_row + flush::slot_of(f, d));
          if (flush::arrive_last(f, u)) last[atomicAdd(&n_last, 1)] = u;
        }
        __syncthreads();
        for (int i = tid; i < n_last * B; i += kThreads) {
          flush::add_row(out, f, last[i / B], B, i % B);
        }
      }
      __syncthreads();  // acc and desc are rewritten by the next window
    }
  }
}

template <int kMode, bool kVec, int CW, int G, typename V, typename C,
          typename X>
int launch(const void* vals, const void* cols, const int* aux,
           const void* x, int n_cols, int B, long long T, int Cn, int M,
           int K, int nk, int cb, int fused, float* out,
           const flush::Rows& f, cudaStream_t s) {
  const size_t smem =
      (size_t)(nk + runs::kRing * runs::kSlots) * cb * sizeof(float);
  const cudaError_t err =
      allow_dynamic_smem(seg_runs_kernel<kMode, kVec, CW, G, V, C, X>, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((T + K - 1) / K);
  seg_runs_kernel<kMode, kVec, CW, G, V, C, X>
      <<<blocks, kThreads, smem, s>>>(
      (const V*)vals, (const C*)cols, aux, (const X*)x, n_cols, B, T, Cn, M,
      K, nk, cb, fused, out, f);
  return (int)cudaGetLastError();
}

// The layouts: on the vector path (slot indices by 16-byte loads), x
// gathered 4 columns at a time (xvec: B and the window's columns multiples
// of 4, x aligned) or 1, and in one-hot mode, where they are multiples of
// 8, two lanes to a slot (pairs), which halves the distinct lines of a
// gather instruction. In seg_scan mode both lanes of a pair would find the
// slot's segment, which cost more than it saved on the card. The scalar
// path (C % 8 != 0 or unaligned arrays, which the packers never emit)
// gathers one column at a time.
template <int kMode, typename V, typename C, typename X>
int launch_layout(bool vec, bool xvec, bool pairs, const void* vals,
                  const void* cols, const int* aux, const void* x,
                  int n_cols, int B, long long T, int Cn, int M, int K,
                  int nk, int cb, int fused, float* out,
                  const flush::Rows& f, cudaStream_t s) {
#define SEG_RUNS_LAUNCH(VEC, CW, G)                                         \
  return launch<kMode, VEC, CW, G, V, C, X>(vals, cols, aux, x, n_cols, B, \
                                            T, Cn, M, K, nk, cb, fused,   \
                                            out, f, s)
  if (vec) {
    if constexpr (kMode == kOnehot) {
      if (pairs) SEG_RUNS_LAUNCH(true, 4, 2);
    }
    if (xvec) SEG_RUNS_LAUNCH(true, 4, 1);
    SEG_RUNS_LAUNCH(true, 1, 1);
  }
  SEG_RUNS_LAUNCH(false, 1, 1);
#undef SEG_RUNS_LAUNCH
}

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

}  // namespace

// mode: 0 seg_scan (aux = seg_end (T, M)), 1 onehot_mxu (aux = local_row
// (T, Cn)). fused = 0: out is (T, M, B) partials and the FusedRows
// pointers (dst .. cells) are unused; fused = 1: out is y (n_rows, B), dst
// (T * M) gives each partial its row of y, its exchange cells or its row
// of side (n_side, B), the kernel adds the shared rows into y
// (flush.cuh), n_used (T) bounds each tile's segments that add anything
// and r0 (T) is each tile's first row. A block takes the ceil(2048 / Cn)
// tiles of one pass, which changes no sum (groups of more tiles left the
// last wave of blocks short on the card).
extern "C" int seg_spmm(const void* vals, int vals_bf16, const void* cols,
                        int cols_i16, const void* x, int x_bf16, int n_cols,
                        int B, const int* aux, long long T, int Cn, int M,
                        int mode, int fused, float* out, const int* dst,
                        const int* n_used, float* side, const int* slot_row,
                        const int* count, unsigned* arrive, const int* perm,
                        const long long* offsets, const int* rows,
                        const int* r0, unsigned long long* cells,
                        void* stream) {
  if (T <= 0 || B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const flush::Rows f{dst,   n_used, r0,      side, slot_row, count,
                      arrive, perm,  offsets, rows, cells};
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  // the window's floats, a column's nk accumulators and its kRing *
  // kSlots boundary sums: the block's shared memory less desc, bkey and a
  // margin
  const long long cap = (optin - 1024) / (long long)sizeof(float);
  const long long bnd = runs::kRing * runs::kSlots;
  const int per_pass = Cn > 0 ? (kPass + Cn - 1) / Cn : 1;
  const long long K = per_pass < T ? per_pass : T;
  // a window: whole tiles (enough for a pass) and all B columns; else one
  // tile and fewer columns (4 at a time on the vector path); else part of
  // a tile's keys and one column
  long long nk;
  int cb;
  const long long tile_floats = (long long)M * B;
  if (tile_floats + bnd * B <= cap) {
    long long nt = per_pass < kMaxWinTiles ? per_pass : kMaxWinTiles;
    if (nt > K) nt = K;
    if (nt > (cap - bnd * B) / tile_floats) {
      nt = (cap - bnd * B) / tile_floats;
    }
    nk = nt * M;
    cb = B;
  } else if (M + bnd <= cap) {
    nk = M;
    cb = (int)(cap / (M + bnd));
    if (cb >= 4) cb -= cb % 4;
  } else {
    nk = cap - bnd;
    cb = 1;
  }
  const bool vec = Cn % kPer == 0 && aligned(vals, 16) && aligned(cols, 16) &&
                   (mode == kSegScan || aligned(aux, 16));
  const bool xvec = B % 4 == 0 && cb % 4 == 0 &&
                    aligned(x, x_bf16 ? 8 : 16);
  const bool pairs = xvec && B % 8 == 0 && cb % 8 == 0;
  const int k = (int)K, n = (int)nk;
  SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16, {
    if (mode == kSegScan) {
      return launch_layout<kSegScan, V, C, X>(
          vec, xvec, pairs, vals, cols, aux, x, n_cols, B, T, Cn, M, k, n,
          cb, fused, out, f, s);
    }
    return launch_layout<kOnehot, V, C, X>(vec, xvec, pairs, vals, cols, aux,
                                           x, n_cols, B, T, Cn, M, k, n, cb,
                                           fused, out, f, s);
  });
  return 0;  // not reached
}
