// ELL row-dot kernels K1, K2 and K5 for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels in src/repro/kernels/ell_spmv.py:
//   K1 ell_spmv_pallas        (_ell_kernel)        -> ell_rows
//   K2 ell_spmv_direct_pallas (_ell_direct_kernel) -> ell_rows (same sums,
//      read by the caller as the flat (T*R,) slab)
//   K5 ell_spmv_fused_pallas  (_ell_fused_kernel)  -> ell_fused
//
// Bound on the H100: device-memory bytes. Each padded slot is read once
// (4+4 bytes fp32/int32, 2+2 bf16/int16) for 2 flops, far below the
// card's ~20 flops per byte at fp32. x is gathered; it is re-read from L2
// when it fits there (50 MB), otherwise from device memory.
//
// Design (K1, K2 and K5 share one pair of kernels). One warp per row
// would keep 9 of 32 lanes busy at W = 9 (the banded operand) with 72
// bytes in flight, far too little to cover the latency of device memory.
// The (T, R, W) tiles are row-major and contiguous, so the mapping follows
// W over the flat T*R row space, chosen per launch on the host:
// - W <= 32 (ell_rows_kernel): a warp owns a slab of 32 consecutive rows,
//   32*W contiguous slots. Lane l loads slots l, l + 32, ... (neighbouring
//   lanes on neighbouring addresses, every lane busy), kSlabUnroll of them
//   in flight before their x gathers, and writes the products to its
//   warp's shared buffer; then lane r sums row r's W products. The buffer
//   skips one word every 32, so neither the writes nor the row reads of
//   W = 16 or 32 fall into one bank.
// - W > 32 (ell_rows_wide_kernel): spmm.cuh's split_rows with one column:
//   the 32 lanes stride over the row, kWideUnroll slots each per pass, and
//   a row is split over up to 8 warps when the launch has few rows.
// A row's sum depends on its slot values in order only: not on W, on the
// kernel that runs it or on the number of rows in the launch. split_rows
// fixes its order (spmm.cuh), and the slab kernel adds a row's products
// in the tree split_rows' lanes end with: each product rounded once, then
// the pairwise tree over 32 slots (reduce_groups), to which the zero
// slots past W add exact zeros. So a row that moves to another width
// bucket (an in-place update against a fresh compile, repro_torch.dyn)
// keeps its bits.
// Both hand each row sum to a spmm::RowSink: K1/K2 store out[row] = sum
// (the (T, R) partials), K5 adds y[row0 + row] += sum.
//
// K5: the TPU kernel zeroes a resident output block at grid step 0 and
// writes rows in sequential grid order. Blocks on the GPU run in parallel
// and in any order, so the sink adds each row straight into y: the rows
// of one bucket are disjoint (affine slope-1 rowmap) and a plan launches
// its buckets one after another on one stream, so no two threads write
// the same element at once and no atomics are needed. Rows >= n_rows (the
// padding rows of the last tile) are masked, since an out-of-range write
// is not clamped on the GPU. The grid covers the T*R rows whatever
// tiles_per_block (the TPU's tiles_per_step) is: ell_fused accepts it and
// ignores it, and the sums do not depend on it.
#include "spmm.cuh"

namespace {

using spmm::kThreads;
using spmm::kWarps;

constexpr int kSlabRows = 32;   // rows per warp in ell_rows_kernel
constexpr int kSlabUnroll = 8;  // slots in flight per lane there
constexpr int kWideUnroll = 4;  // ... and per lane and pass for W > 32

// a slot's place in the slab buffer: one padding word every 32 slots
__device__ __forceinline__ int slab_at(int s) { return s + (s >> 5); }

// sink(row, sum_w vals[row, w] * x[cols[row, w]]) for every one of the
// n_tile_rows tile rows, for W <= kSlabRows (dynamic shared memory:
// kWarps * 33 * W floats)
template <typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
ell_rows_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                const X* __restrict__ x, int n_cols, long long n_tile_rows,
                int W, spmm::RowSink sink) {
  extern __shared__ float slab[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long first =
      ((long long)blockIdx.x * kWarps + warp) * kSlabRows;
  if (first >= n_tile_rows) return;  // whole warp leaves together
  float* buf = slab + warp * (33 * W);
  const long long base = first * W;
  const int rows = (int)min((long long)kSlabRows, n_tile_rows - first);
  const int n = rows * W;  // slots of this slab
  for (int s0 = lane; s0 < n; s0 += 32 * kSlabUnroll) {
    int col[kSlabUnroll];
    float v[kSlabUnroll];
#pragma unroll
    for (int u = 0; u < kSlabUnroll; ++u) {
      const int s = s0 + 32 * u;
      col[u] = s < n ? to_i32(cols[base + s]) : -1;
      v[u] = s < n ? to_f32(vals[base + s]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kSlabUnroll; ++u) {
      const int s = s0 + 32 * u;
      const float xv =
          ((unsigned)col[u] < (unsigned)n_cols) ? to_f32(x[col[u]]) : 0.f;
      if (s < n) buf[slab_at(s)] = __fmaf_rn(v[u], xv, 0.f);
    }
  }
  __syncwarp();
  if (lane < rows) {
    // reduce_groups' pairwise tree over the row's 32 slots, the slots past
    // W zeros: subtrees of 4 slots, merged as each closes the subtrees
    // before it (st[l]: the last finished subtree of 4 * 2^l slots; group
    // q closes as many as q has trailing ones)
    const int G = (W + 3) >> 2;  // groups of 4 slots
    float st[4];
#pragma unroll
    for (int q = 0; q < kSlabRows / 4; ++q) {
      if (q >= G) break;  // W is the same for the whole launch
      float p[4];
      const int s0 = lane * W + 4 * q;
      if (4 * q + 4 <= W) {  // a whole group: no masks
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = buf[slab_at(s0 + e)];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = 4 * q + e < W ? buf[slab_at(s0 + e)] : 0.f;
        }
      }
      float v = (p[0] + p[1]) + (p[2] + p[3]);
      int t = 0;
#pragma unroll
      for (int l = 0; l < 3; ++l) t += (q & ((2 << l) - 1)) == (2 << l) - 1;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        if (l < t) {
          v = st[l] + v;
        } else if (l == t) {
          st[l] = v;
        }
      }
    }
    // the open subtrees, smallest first: the all-zero groups past G would
    // add exact zeros to each of them
    float acc = 0.f;
    bool have = false;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      if ((G >> l) & 1) {
        acc = have ? st[l] + acc : st[l];
        have = true;
      }
    }
    sink(first + lane, 0, acc);
  }
}

// the same sums for W > kSlabRows: wpr warps per row (split_rows, B = 1)
template <typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
ell_rows_wide_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                     const X* __restrict__ x, int n_cols,
                     long long n_tile_rows, int W, int wpr,
                     spmm::RowSink sink) {
  spmm::split_rows<kWideUnroll, 1>(vals, cols, x, n_cols, 1, 1, W, wpr, 0,
                                   n_tile_rows, sink, blockIdx.y, gridDim.y);
}

// Launch the row sums of n_tile_rows rows of W slots into sink.
int launch_rows(const void* vals, int vals_bf16, const void* cols,
                int cols_i16, const void* x, int x_bf16, int n_cols,
                long long n_tile_rows, int W, spmm::RowSink sink,
                cudaStream_t s) {
  if (W <= kSlabRows) {
    const long long per_block = (long long)kWarps * kSlabRows;
    const unsigned blocks =
        (unsigned)((n_tile_rows + per_block - 1) / per_block);
    const size_t smem = sizeof(float) * kWarps * 33 * W;
    SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16,
                  ell_rows_kernel<V, C, X><<<blocks, kThreads, smem, s>>>(
                      (const V*)vals, (const C*)cols, (const X*)x, n_cols,
                      n_tile_rows, W, sink));
    return (int)cudaGetLastError();
  }
  const int wpr = spmm::warps_per_row(n_tile_rows, W, 32, kWideUnroll);
  // one "tile" of n_tile_rows * wpr warp-sized items, as split_rows strides;
  // it fits an int: with wpr > 1 it is below 2 * kFillWarps, and 2^31 rows
  // of more than 32 slots would not fit in the card's memory
  const dim3 grid = spmm::item_grid(1, (int)(n_tile_rows * wpr), 1);
  SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16,
                ell_rows_wide_kernel<V, C, X><<<grid, kThreads, 0, s>>>(
                    (const V*)vals, (const C*)cols, (const X*)x, n_cols,
                    n_tile_rows, W, wpr, sink));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ell_rows(const void* vals, int vals_bf16, const void* cols,
                        int cols_i16, const void* x, int x_bf16, int n_cols,
                        float* out, long long n_tile_rows, int W,
                        void* stream) {
  return launch_rows(vals, vals_bf16, cols, cols_i16, x, x_bf16, n_cols,
                     n_tile_rows, W, spmm::RowSink{out, 1, 0, 0, 0},
                     (cudaStream_t)stream);
}

// tiles_per_block is accepted and ignored (see the header)
extern "C" int ell_fused(const void* vals, int vals_bf16, const void* cols,
                         int cols_i16, const void* x, int x_bf16, int n_cols,
                         float* y, long long T, int R, int W, long long row0,
                         long long n_rows, int tiles_per_block,
                         void* stream) {
  (void)tiles_per_block;
  return launch_rows(vals, vals_bf16, cols, cols_i16, x, x_bf16, n_cols,
                     T * R, W, spmm::RowSink{y, 1, 1, row0, n_rows},
                     (cudaStream_t)stream);
}

// The grouped K1 for rows wider than kSlabRows: n buckets (spmm::BucketIn)
// in one launch of ell_rows_wide_kernel's body, each bucket's T*R sums at
// its out_row of the slab out. A bucket of W <= kSlabRows would get the
// same bits here, one warp a row; plans launch those on their own, through
// ell_rows' slab kernel (core/kernel_builder.py).
extern "C" int ell_rows_grouped(const spmm::BucketIn* buckets, int n,
                                int vals_bf16, int cols_i16, const void* x,
                                int x_bf16, int n_cols, float* out,
                                void* stream) {
  return spmm::launch_grouped<kWideUnroll, 1>(
      buckets, n, vals_bf16, cols_i16, x, x_bf16, n_cols, 1, out,
      (cudaStream_t)stream);
}
