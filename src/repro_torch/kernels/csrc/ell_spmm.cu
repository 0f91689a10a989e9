// ELL multi-RHS (SpMM) kernels K7, K8 and K9 for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels in src/repro/kernels/ell_spmv.py:
//   K7 ell_spmm_pallas        (_ell_spmm_kernel)        -> ell_spmm
//   K8 ell_spmm_direct_pallas (_ell_spmm_direct_kernel) -> ell_spmm (same
//      sums, read by the caller as the (T*R, B) slab)
//   K9 ell_spmm_fused_pallas  (_ell_spmm_fused_kernel)  -> ell_spmm with
//      fused = 1
//
// Bound on the H100: device-memory bytes. The format streams once for all
// B right-hand sides: each padded slot is read once (4+4 bytes fp32/int32,
// 2+2 bf16/int16) for 2*B flops, so at B = 8 there are 2 flops per byte,
// still far below the card's ~20 flops per byte at fp32. x (n_cols * B
// values) is gathered row by row and re-read from L2, where it fits.
//
// Design: one warp per tile row (the TPU contracts a whole (R, W) tile
// against the (W, B) gather on its matrix unit; rows are independent, so
// the GPU maps warps to rows, which fills the card even when a bucket has
// few tiles). The warp's lanes split into groups of bc lanes (spmm.cuh):
// lane j of a group owns column c0 + j, the groups stride over the row's W
// slots, and xor shuffles combine the groups. Columns beyond 32 are taken
// in further chunks of 32.
//
// K9: the TPU kernel zeroes a resident output block at grid step 0 and
// writes rows in sequential grid order. Blocks on the GPU run in parallel
// and in any order, so the fused kernel adds each row's B sums straight
// into y (n_rows, B): the rows of one bucket are disjoint (affine slope-1
// rowmap), so no two warps write the same element and no atomics are
// needed. Rows >= n_rows (the padding rows of the last tile) are masked,
// since an out-of-range write is not clamped on the GPU. tiles_per_block
// (the TPU's tiles_per_step) groups the tiles along the grid's x axis; the
// grid's y axis spreads the group's rows over blocks, so it changes
// neither the sums nor how many warps run.
#include "spmm.cuh"

namespace {

using spmm::kThreads;
using spmm::kWarps;

// fused = 0: out[row, b] for every tile row (the (T*R, B) slab);
// fused = 1: y[row0 + row, b] += sum, masked at n_rows.
template <typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                const X* __restrict__ x, int n_cols, int B, int bc,
                float* __restrict__ out, long long T, int R, int W,
                int fused, long long row0, long long n_rows,
                int tiles_per_block) {
  const int lane = threadIdx.x & 31;
  const int g = lane / bc, j = lane % bc, groups = 32 / bc;
  const long long t0 = (long long)blockIdx.x * tiles_per_block;
  const long long t1 = min(t0 + tiles_per_block, T);
  const long long stride = (long long)gridDim.y * kWarps;
  for (long long row = t0 * R + (long long)blockIdx.y * kWarps +
                       (threadIdx.x >> 5);
       row < t1 * R; row += stride) {  // warp-uniform
    const long long base = row * W;
    for (int c0 = 0; c0 < B; c0 += bc) {
      const int b = c0 + j;
      float acc = spmm::range_dot(vals, cols, x, n_cols, B, base, base + W,
                                  b, g, groups);
      acc = spmm::reduce_groups(acc, bc);
      if (g != 0 || b >= B) continue;
      if (fused) {
        const long long yrow = row0 + row;
        if (yrow < n_rows) out[yrow * B + b] += acc;
      } else {
        out[row * B + b] = acc;
      }
    }
  }
}

}  // namespace

// out is (T*R, B) when fused = 0 (row0, n_rows unused) and y (n_rows, B)
// when fused = 1.
extern "C" int ell_spmm(const void* vals, int vals_bf16, const void* cols,
                        int cols_i16, const void* x, int x_bf16, int n_cols,
                        int B, float* out, long long T, int R, int W,
                        int fused, long long row0, long long n_rows,
                        int tiles_per_block, void* stream) {
  const int bc = spmm::col_chunk(B);
  const dim3 grid = spmm::item_grid(T, R, tiles_per_block);
  cudaStream_t s = (cudaStream_t)stream;
  SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16,
                ell_spmm_kernel<V, C, X><<<grid, kThreads, 0, s>>>(
                    (const V*)vals, (const C*)cols, (const X*)x, n_cols, B,
                    bc, out, T, R, W, fused, row0, n_rows, tiles_per_block));
  return (int)cudaGetLastError();
}
