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
// Design of ell_rows (K1, K2). One warp per row would keep 9 of 32 lanes
// busy at W = 9 (the banded operand) with 72 bytes in flight, far too
// little to cover the latency of device memory. The (T, R, W) tiles are
// row-major and contiguous, so the mapping follows W, chosen per launch on
// the host:
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
//
// K5 (ell_fused) gives one warp to one tile row. The 32 lanes stride over
// the W slots of the row, so neighbouring lanes read neighbouring
// addresses of vals and cols (coalesced), and a shuffle reduction
// combines the lanes.
//
// K5: the TPU kernel zeroes a resident output block at grid step 0 and
// writes rows in sequential grid order. Blocks on the GPU run in parallel
// and in any order, so ell_fused adds each row straight into y: the rows
// of one bucket are disjoint (affine slope-1 rowmap), so no two threads
// write the same element and no atomics are needed. Rows >= n_rows (the
// padding rows of the last tile) are masked, since an out-of-range write
// is not clamped on the GPU. tiles_per_block (the TPU's tiles_per_step)
// only sets how many tiles one block walks; the sums do not depend on it.
#include "spmm.cuh"

namespace {

using spmm::kThreads;
using spmm::kWarps;

template <typename V, typename C, typename X>
__device__ __forceinline__ float row_dot(const V* __restrict__ vals,
                                         const C* __restrict__ cols,
                                         const X* __restrict__ x, int n_cols,
                                         long long row, int W, int lane) {
  float acc = 0.f;
  const long long base = row * W;
  for (int w = lane; w < W; w += 32) {
    acc += nz_product(vals, cols, x, n_cols, base + w);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

constexpr int kSlabRows = 32;   // rows per warp in ell_rows_kernel
constexpr int kSlabUnroll = 8;  // slots in flight per lane there
constexpr int kWideUnroll = 4;  // ... and per lane and pass for W > 32

// a slot's place in the slab buffer: one padding word every 32 slots
__device__ __forceinline__ int slab_at(int s) { return s + (s >> 5); }

// out[row] = sum_w vals[row, w] * x[cols[row, w]] over all T*R tile rows,
// for W <= kSlabRows (dynamic shared memory: kWarps * 33 * W floats)
template <typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
ell_rows_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                const X* __restrict__ x, int n_cols, float* __restrict__ out,
                long long n_tile_rows, int W) {
  extern __shared__ float slab[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 =
      ((long long)blockIdx.x * kWarps + warp) * kSlabRows;
  if (row0 >= n_tile_rows) return;  // whole warp leaves together
  float* buf = slab + warp * (33 * W);
  const long long base = row0 * W;
  const int rows = (int)min((long long)kSlabRows, n_tile_rows - row0);
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
      if (s < n) buf[slab_at(s)] = v[u] * xv;
    }
  }
  __syncwarp();
  if (lane < rows) {
    float acc = 0.f;
    for (int w = 0; w < W; ++w) acc += buf[slab_at(lane * W + w)];
    out[row0 + lane] = acc;
  }
}

// the same sums for W > kSlabRows: wpr warps per row (split_rows, B = 1)
template <typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
ell_rows_wide_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                     const X* __restrict__ x, int n_cols,
                     float* __restrict__ out, long long n_tile_rows, int W,
                     int wpr) {
  spmm::split_rows<kWideUnroll, 1>(vals, cols, x, n_cols, 1, 1, W, wpr, 0,
                                   n_tile_rows,
                                   spmm::RowSink{out, 1, 0, 0, 0});
}

// y[row0 + t*R + r] += row sum, for t in this block's tiles, masked at n_rows
template <typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
ell_fused_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                 const X* __restrict__ x, int n_cols, float* __restrict__ y,
                 long long T, int R, int W, long long row0, long long n_rows,
                 int tiles_per_block) {
  const long long t0 = (long long)blockIdx.x * tiles_per_block;
  const long long t1 = min(t0 + tiles_per_block, T);
  const int lane = threadIdx.x & 31;
  for (long long row = t0 * R + (threadIdx.x >> 5); row < t1 * R;
       row += kWarps) {
    const float acc = row_dot(vals, cols, x, n_cols, row, W, lane);
    const long long yrow = row0 + row;
    if (lane == 0 && yrow < n_rows) y[yrow] += acc;
  }
}

}  // namespace

extern "C" int ell_rows(const void* vals, int vals_bf16, const void* cols,
                        int cols_i16, const void* x, int x_bf16, int n_cols,
                        float* out, long long n_tile_rows, int W,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W <= kSlabRows) {
    const long long per_block = (long long)kWarps * kSlabRows;
    const unsigned blocks =
        (unsigned)((n_tile_rows + per_block - 1) / per_block);
    const size_t smem = sizeof(float) * kWarps * 33 * W;
    SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16,
                  ell_rows_kernel<V, C, X><<<blocks, kThreads, smem, s>>>(
                      (const V*)vals, (const C*)cols, (const X*)x, n_cols,
                      out, n_tile_rows, W));
    return (int)cudaGetLastError();
  }
  const int wpr = spmm::warps_per_row(n_tile_rows, W, 32, kWideUnroll);
  // one "tile" of n_tile_rows * wpr warp-sized items, as split_rows strides;
  // it fits an int: with wpr > 1 it is below 2 * kFillWarps, and 2^31 rows
  // of more than 32 slots would not fit in the card's memory
  const dim3 grid = spmm::item_grid(1, (int)(n_tile_rows * wpr), 1);
  SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16,
                ell_rows_wide_kernel<V, C, X><<<grid, kThreads, 0, s>>>(
                    (const V*)vals, (const C*)cols, (const X*)x, n_cols, out,
                    n_tile_rows, W, wpr));
  return (int)cudaGetLastError();
}

extern "C" int ell_fused(const void* vals, int vals_bf16, const void* cols,
                         int cols_i16, const void* x, int x_bf16, int n_cols,
                         float* y, long long T, int R, int W, long long row0,
                         long long n_rows, int tiles_per_block,
                         void* stream) {
  const unsigned blocks =
      (unsigned)((T + tiles_per_block - 1) / tiles_per_block);
  cudaStream_t s = (cudaStream_t)stream;
  SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16,
                ell_fused_kernel<V, C, X><<<blocks, kThreads, 0, s>>>(
                    (const V*)vals, (const C*)cols, (const X*)x, n_cols, y, T,
                    R, W, row0, n_rows, tiles_per_block));
  return (int)cudaGetLastError();
}
