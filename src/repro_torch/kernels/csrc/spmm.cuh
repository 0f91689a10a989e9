// Shared helpers of the multi-RHS (SpMM) kernels K7-K11, and of the 1-RHS
// ELL kernels K1/K2/K5: their ell_rows_wide_kernel (rows wider than 32
// slots) runs split_rows with B = 1, and both their kernels store through
// RowSink. The grouped K7 and K1 (ell_spmm_grouped, ell_rows_grouped) run
// split_rows over many buckets in one launch (grouped_rows_kernel, below).
//
// x is row-major (n_cols, B): one gathered row x[col] is B contiguous
// values. A warp works on one output row (ELL) or one segment (the seg
// SpMM kernels' tiles whose ends descend) and splits its 32 lanes into groups of `bc` lanes, bc the smallest power
// of two >= min(B, 32): lane j of a group owns column c0 + j of the current
// column chunk, and the 32 / bc groups stride over the row's slots. Lanes of
// one group read the same vals/cols element (a broadcast) and neighbouring
// x values; the groups' sums are combined with xor shuffles. B = 1 gives
// the 1-RHS layout (32 groups of one lane); B > 32 loops over chunks of 32
// columns. range_dot loads scalars, so no B or element size needs
// alignment there. split_rows with CPL = 4 (K7-K9) does not: its load_cols
// reads four columns with one 16-byte (fp32) or 8-byte (bf16) load, which
// needs B % 4 == 0 and x aligned to that size; ell_spmm checks both on the
// host and otherwise runs CPL = 1, one scalar load per column. The seg
// SpMM kernels (seg_spmm.cu) gather x with load_cols too, under the same
// checks.
#pragma once

#include "common.cuh"

namespace spmm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// smallest power of two >= min(B, 32)
__host__ __device__ inline int col_chunk(int B) {
  int bc = 1;
  while (bc < B && bc < 32) bc <<= 1;
  return bc;
}

// This lane's share of sum_{i in [lo, hi)} vals[i] * x[cols[i], b]: slots
// i = lo + g, lo + g + groups, ... A column outside [0, n_cols) and a
// column b >= B contribute 0.
template <typename V, typename C, typename X>
__device__ __forceinline__ float range_dot(const V* __restrict__ vals,
                                           const C* __restrict__ cols,
                                           const X* __restrict__ x,
                                           int n_cols, int B, long long lo,
                                           long long hi, int b, int g,
                                           int groups) {
  float acc = 0.f;
  if (b >= B) return acc;
  for (long long i = lo + g; i < hi; i += groups) {
    const int col = to_i32(cols[i]);
    const float xv = ((unsigned)col < (unsigned)n_cols)
                         ? to_f32(x[(long long)col * B + b])
                         : 0.f;
    acc += to_f32(vals[i]) * xv;
  }
  return acc;
}

// Sum over the 32 / bc lane groups; every lane ends with its column's sum.
// All 32 lanes must call it.
__device__ __forceinline__ float reduce_groups(float acc, int bc) {
  for (int o = bc; o < 32; o <<= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  }
  return acc;
}

// Grid of the warp-per-item kernels: x walks groups of `tiles_per_block`
// tiles, y slices the group's items (rows or segments) over blocks of
// kWarps warps, so the card fills whatever tiles_per_block is.
inline dim3 item_grid(long long T, int items_per_tile, int tiles_per_block) {
  const long long gx = (T + tiles_per_block - 1) / tiles_per_block;
  long long gy =
      ((long long)tiles_per_block * items_per_tile + kWarps - 1) / kWarps;
  if (gy > 65535) gy = 65535;  // the warps then stride over the rest
  if (gy < 1) gy = 1;
  return dim3((unsigned)gx, (unsigned)gy, 1);
}

// ---- Split-row ELL sums (K7-K9, and K1/K2/K5's rows wider than 32) ----
//
// An ELL row is W contiguous slots. Its sum is fixed by its slot values in
// order alone, whatever W (trailing zero slots), the number of rows in
// the launch or the number of warps on the row:
// - the row is cut into chunks of Q = groups * U slots from its start
//   (one pass of a warp's lane groups), whatever W is;
// - in chunk c, lane group g takes slots c*Q + g, c*Q + g + groups, ...
//   and sums them in slot order, each product rounded once (__fmaf_rn),
//   from 0;
// - group g adds its chunk sums in chunk order;
// - reduce_groups adds the groups' totals in a fixed pairwise tree.
// A zero slot adds an exact 0 at each of these steps, so a row padded to
// another width sums to the same bits. ell_rows_kernel (W <= 32, one slot
// a lane) computes the same tree (see ell_spmv.cu), and so K1, K2 and K5
// agree with each other to the bit, as K7, K8 and K9 do at one B.
//
// A row may be split over `wpr` warps of a block (a power of two <=
// kWarps): in each pass warp k of the row sums chunk p*wpr + k, the wpr
// warps store their per-lane chunk sums in shared memory, and the row's
// first warp adds them in chunk order. A block thus covers kWarps / wpr
// rows at a time. warps_per_row picks wpr on the host so that a launch of
// few rows (a serving bucket of one tile is 128 rows) still has some
// thousands of warps in flight; it changes which warp sums a chunk, not
// the order of the sums.
//
// A lane owns CPL consecutive columns of x: CPL = 1 is the layout above
// (bc lanes per group); with CPL = 4 (B a multiple of 4 and x aligned for
// it) one 16-byte (fp32) or 8-byte (bf16) load brings a lane its four x
// values, so a slot at B = 8 takes 2 lanes instead of 8: four times fewer
// instructions for the same bytes. The lane layout (groups) sets the
// order, so one B and one x alignment give one order.

constexpr int kFillWarps = 4096;  // warps a launch should keep in flight

// x[p], x[p + 1], ..., CPL values upcast to float (zeros when !in)
template <int CPL>
__device__ __forceinline__ void load_cols(const float* __restrict__ p,
                                          bool in, float (&xv)[CPL]) {
  if constexpr (CPL == 4) {
    const float4 q = in ? *reinterpret_cast<const float4*>(p)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    xv[0] = q.x, xv[1] = q.y, xv[2] = q.z, xv[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < CPL; ++k) xv[k] = in ? p[k] : 0.f;
  }
}
template <int CPL>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* __restrict__ p,
                                          bool in, float (&xv)[CPL]) {
  if constexpr (CPL == 4) {
    // four bf16 in 8 bytes; a bf16 is the top half of its float
    const uint2 q = in ? *reinterpret_cast<const uint2*>(p) : make_uint2(0, 0);
    xv[0] = __uint_as_float(q.x << 16);
    xv[1] = __uint_as_float(q.x & 0xffff0000u);
    xv[2] = __uint_as_float(q.y << 16);
    xv[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int k = 0; k < CPL; ++k) xv[k] = in ? __bfloat162float(p[k]) : 0.f;
  }
}

// This lane's share of one chunk, sum_{i in [lo, hi)} vals[i] * x[cols[i],
// b + k] for k < CPL over slots i = lo + g + u * groups, u < U (a chunk is
// one pass: hi - lo <= groups * U), added in u order from 0, each product
// rounded once. The U cols/vals loads issue first, then the U x loads,
// then the FMAs, so a lane has U loads in flight instead of one chain of
// dependent loads. cols and vals, read once, are loaded evict-first
// (__ldcs) so that they do not push the gathered x out of L1. A column
// outside [0, n_cols) and a column b >= B contribute 0 (with CPL = 4, B
// is a multiple of 4).
template <int U, int CPL, typename V, typename C, typename X>
__device__ __forceinline__ void chunk_dot(
    const V* __restrict__ vals, const C* __restrict__ cols,
    const X* __restrict__ x, int n_cols, int B, long long lo, long long hi,
    int b, int g, int groups, float (&acc)[CPL]) {
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = 0.f;
  if (b >= B) return;
  int col[U];
  float v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = lo + g + (long long)u * groups;
    col[u] = i < hi ? to_i32(__ldcs(cols + i)) : -1;
    v[u] = i < hi ? to_f32(__ldcs(vals + i)) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = (unsigned)col[u] < (unsigned)n_cols;
    float xv[CPL];
    load_cols<CPL>(x + (long long)(in ? col[u] : 0) * B + b, in, xv);
#pragma unroll
    for (int k = 0; k < CPL; ++k) acc[k] = __fmaf_rn(v[u], xv[k], acc[k]);
  }
}

// Warps per row: doubled from 1 while the launch has fewer than kFillWarps
// warps and each warp still gets a chunk (groups * U slots) of the row.
inline int warps_per_row(long long rows, long long W, int groups, int U) {
  int wpr = 1;
  while (wpr < kWarps && rows * wpr < kFillWarps &&
         W >= (long long)wpr * groups * U) {
    wpr <<= 1;
  }
  return wpr;
}

// Where a row's B sums go: out[row, b] = sum (the (rows, B) slab), or, when
// fused, y[row0 + row, b] += sum, masked at n_rows.
struct RowSink {
  float* out;
  int B;
  int fused;
  long long row0, n_rows;
  __device__ __forceinline__ void operator()(long long row, int b,
                                             float sum) const {
    if (!fused) {
      out[row * B + b] = sum;
      return;
    }
    const long long yrow = row0 + row;
    if (yrow < n_rows) out[yrow * B + b] += sum;
  }
};

// Rows [r_begin, r_end), kWarps / wpr rows per block and pass, the passes
// strided over n_blk blocks, of which this block is blk (the grid's y axis
// in K7-K9 and K1/K2/K5, a bucket's share of the grid in the grouped
// launch below); bc lanes per group, each owning CPL columns, so a column
// chunk is bc * CPL columns. Every row of a block has W slots, so every
// thread of the block runs the same passes, column chunks and slot chunks,
// and the __syncthreads are reached by all of them.
template <int U, int CPL, typename V, typename C, typename X>
__device__ __forceinline__ void split_rows(
    const V* __restrict__ vals, const C* __restrict__ cols,
    const X* __restrict__ x, int n_cols, int B, int bc, long long W, int wpr,
    long long r_begin, long long r_end, RowSink sink, long long blk,
    long long n_blk) {
  __shared__ float part[kWarps][32 * CPL];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / bc, j = lane % bc, groups = 32 / bc;
  const int rows_per_pass = kWarps / wpr, sub = warp % wpr;
  const long long Q = (long long)groups * U;  // slots of a chunk
  const long long n_chunks = (W + Q - 1) / Q;
  for (long long r = r_begin + blk * rows_per_pass; r < r_end;
       r += n_blk * rows_per_pass) {
    const long long row = r + warp / wpr;
    const bool live = row < r_end;
    const long long base = row * W, end = live ? base + W : base;
    for (int c0 = 0; c0 < B; c0 += bc * CPL) {
      const int b = c0 + j * CPL;
      float tot[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) tot[k] = 0.f;
      // chunk c = sub, sub + wpr, ...: slots [lo, lo + Q) of the row
      long long lo = base + sub * Q;
      for (long long c = sub; c - sub < n_chunks; c += wpr, lo += wpr * Q) {
        float acc[CPL];
        chunk_dot<U, CPL>(vals, cols, x, n_cols, B, lo, min(lo + Q, end), b,
                          g, groups, acc);
        if (wpr == 1) {  // grid-uniform
#pragma unroll
          for (int k = 0; k < CPL; ++k) tot[k] += acc[k];
          continue;
        }
#pragma unroll
        for (int k = 0; k < CPL; ++k) part[warp][lane * CPL + k] = acc[k];
        __syncthreads();
        if (sub == 0) {  // the row's chunks c .. c + wpr - 1, in order
          for (int w = 0; w < wpr; ++w) {
#pragma unroll
            for (int k = 0; k < CPL; ++k) tot[k] += part[warp + w][lane * CPL + k];
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < CPL; ++k) tot[k] = reduce_groups(tot[k], bc);
      if (g == 0 && live && b < B && sub == 0) {
#pragma unroll
        for (int k = 0; k < CPL; ++k) sink(row, b + k, tot[k]);
      }
    }
  }
}

// ---- Grouped launches (K7, and K1's rows wider than 32, over buckets) ----
//
// A plan's ELL scatter steps are its width buckets: the serving matrix's
// ELL plan has 26 of 1-5 tiles (128-640 rows) each. Launched one by one,
// a bucket cannot fill the card's 132 SMs whatever wpr does inside it,
// and each launch costs its wrapper call on the host. A grouped launch
// runs every bucket of a group in one grid: the host lays the buckets'
// blocks end to end (block0, n_blk), a block finds its bucket by a binary
// search over block0 and runs split_rows on that bucket's rows, writing
// its sums at the bucket's rows of one (sum T*R, B) output slab (out_row).
// The descriptors travel by value in the kernel's parameter block
// (__grid_constant__, read in place), kMaxGroup at a time: a table in
// device memory would go stale once a plan's tensors are replaced (an
// in-place update uploads new ones), and the host builds the parameters
// anew at each launch from the pointers it is handed. split_rows fixes a
// row's sum whatever wpr and the launch, so each row keeps the bits of
// its bucket's own launch, and wpr is picked from the group's rows.
constexpr int kMaxGroup = 64;

// One bucket as the host hands it over (BucketIn of kernels/ell_spmv.py)
struct BucketIn {
  const void* vals;    // (T, R, W) tiles
  const void* cols;
  long long out_row;   // its first row in the output slab
  long long rows;      // T * R
  long long W;
};

struct Bucket {
  const void* vals;
  const void* cols;
  long long out_row;
  int rows, W, wpr;
  int block0, n_blk;   // its blocks in the grid
};

struct Group {
  Bucket b[kMaxGroup];
  int n;
};

template <int U, int CPL, typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
grouped_rows_kernel(const __grid_constant__ Group g, const X* __restrict__ x,
                    int n_cols, int B, int bc, float* __restrict__ out) {
  const int bid = (int)blockIdx.x;
  int lo = 0, hi = g.n - 1;  // the last bucket whose blocks start <= bid
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (g.b[mid].block0 <= bid) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Bucket& k = g.b[lo];
  split_rows<U, CPL>(static_cast<const V*>(k.vals),
                     static_cast<const C*>(k.cols), x, n_cols, B, bc, k.W,
                     k.wpr, 0, k.rows, RowSink{out + k.out_row * B, B, 0, 0, 0},
                     bid - k.block0, k.n_blk);
}

// One grouped launch of n <= kMaxGroup buckets at CPL columns a lane: each
// bucket's wpr from the group's rows (warps_per_row), its blocks one pass
// of kWarps / wpr rows each (at most 65535, as item_grid).
template <int U, int CPL>
int launch_grouped(const BucketIn* in, int n, int vals_bf16, int cols_i16,
                   const void* x, int x_bf16, int n_cols, int B, float* out,
                   cudaStream_t s) {
  if (n < 1 || n > kMaxGroup || B < 1) return (int)cudaErrorInvalidValue;
  const int bc = col_chunk(B / CPL);
  long long total = 0;
  for (int i = 0; i < n; ++i) total += in[i].rows;
  Group g;
  g.n = n;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    if (in[i].rows < 1 || in[i].rows > INT32_MAX || in[i].W < 1 ||
        in[i].W > INT32_MAX || in[i].out_row < 0) {
      return (int)cudaErrorInvalidValue;
    }
    const int wpr = warps_per_row(total, in[i].W, 32 / bc, U);
    const long long per = kWarps / wpr;
    long long nb = (in[i].rows + per - 1) / per;
    if (nb > 65535) nb = 65535;  // the passes then stride over the rest
    g.b[i] = Bucket{in[i].vals, in[i].cols, in[i].out_row, (int)in[i].rows,
                    (int)in[i].W, wpr, (int)blocks, (int)nb};
    blocks += nb;
  }
  SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16,
                grouped_rows_kernel<U, CPL, V, C, X>
                <<<(unsigned)blocks, kThreads, 0, s>>>(
                    g, (const X*)x, n_cols, B, bc, out));
  return (int)cudaGetLastError();
}

}  // namespace spmm
