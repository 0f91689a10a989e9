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
// Design: one warp per tile row. The 32 lanes stride over the W slots of
// the row, so neighbouring lanes read neighbouring addresses of vals and
// cols (coalesced), and a shuffle reduction combines the lanes. Rows
// narrower than 32 slots leave lanes idle: a first, simple design.
//
// K5: the TPU kernel zeroes a resident output block at grid step 0 and
// writes rows in sequential grid order. Blocks on the GPU run in parallel
// and in any order, so ell_fused adds each row straight into y: the rows
// of one bucket are disjoint (affine slope-1 rowmap), so no two threads
// write the same element and no atomics are needed. Rows >= n_rows (the
// padding rows of the last tile) are masked, since an out-of-range write
// is not clamped on the GPU. tiles_per_block (the TPU's tiles_per_step)
// only sets how many tiles one block walks; the sums do not depend on it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// out[row] = sum_w vals[row, w] * x[cols[row, w]] over all T*R tile rows
template <typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
ell_rows_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                const X* __restrict__ x, int n_cols, float* __restrict__ out,
                long long n_tile_rows, int W) {
  const long long row =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_tile_rows) return;  // whole warp leaves together
  const float acc = row_dot(vals, cols, x, n_cols, row, W, lane);
  if (lane == 0) out[row] = acc;
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
  const unsigned blocks = (unsigned)((n_tile_rows + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16,
                ell_rows_kernel<V, C, X><<<blocks, kThreads, 0, s>>>(
                    (const V*)vals, (const C*)cols, (const X*)x, n_cols, out,
                    n_tile_rows, W));
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
