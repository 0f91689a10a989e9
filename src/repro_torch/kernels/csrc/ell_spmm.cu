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
// Design. A serving bucket holds 1-5 tiles of ~380-slot rows, so a launch
// has only 128-640 rows; with one warp walking a row in a chain of
// dependent loads (cols, then the x gather, then one FMA) a launch would
// last as long as that chain. Hence (spmm.cuh, split_rows):
// - each group of lanes takes kUnroll = 4 slots per pass whose cols/vals
//   loads are independent, so a lane has 4 loads, then 4 x loads, in
//   flight (8 measured slower on the H100: more registers, fewer warps);
//   cols/vals are loaded evict-first, so the gathered x stays in L1;
// - when B is a multiple of 4 and x is aligned for it, a lane owns 4
//   columns and reads them with one 16-byte (fp32) or 8-byte (bf16) load,
//   so a slot at B = 8 takes a group of 2 lanes instead of 8; otherwise a
//   lane owns one column (groups of bc lanes, bc the smallest power of two
//   >= min(B, 32)). Any B works; wider B is taken in column chunks;
// - one row is split over wpr warps of a block (1, 2, 4 or 8), which take
//   its chunks of one pass (groups * 4 slots) in turn and whose per-lane
//   chunk sums are added in shared memory in chunk order, so a row's sum
//   is the same whatever wpr, W or the launch's row count (spmm.cuh); the
//   host picks wpr from T*R and W so that a launch has about kFillWarps =
//   4096 warps while each warp gets a chunk. A single-tile bucket (128
//   rows, W ~ 400) at B = 8 runs 8 warps per row; the padded 96-tile
//   launch (12288 rows) one.
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

constexpr int kUnroll = 4;

// fused = 0: out[row, b] for every tile row (the (T*R, B) slab);
// fused = 1: y[row0 + row, b] += sum, masked at n_rows. CPL columns per
// lane (1 or 4), bc lanes per column group.
template <int CPL, typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                const X* __restrict__ x, int n_cols, int B, int bc,
                float* __restrict__ out, long long T, int R, int W,
                int fused, long long row0, long long n_rows,
                int tiles_per_block, int wpr) {
  const long long t0 = (long long)blockIdx.x * tiles_per_block;
  const long long t1 = min(t0 + tiles_per_block, T);
  spmm::split_rows<kUnroll, CPL>(vals, cols, x, n_cols, B, bc, W, wpr,
                                 t0 * R, t1 * R,
                                 spmm::RowSink{out, B, fused, row0, n_rows},
                                 blockIdx.y, gridDim.y);
}

// One launch at CPL columns per lane (see the entry point below).
template <int CPL>
void launch(const void* vals, int vals_bf16, const void* cols, int cols_i16,
            const void* x, int x_bf16, int n_cols, int B, int bc, float* out,
            long long T, int R, int W, int fused, long long row0,
            long long n_rows, int tiles_per_block, int wpr, dim3 grid,
            cudaStream_t s) {
  SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16,
                ell_spmm_kernel<CPL, V, C, X><<<grid, kThreads, 0, s>>>(
                    (const V*)vals, (const C*)cols, (const X*)x, n_cols, B, bc,
                    out, T, R, W, fused, row0, n_rows, tiles_per_block, wpr));
}

}  // namespace

// out is (T*R, B) when fused = 0 (row0, n_rows unused) and y (n_rows, B)
// when fused = 1.
extern "C" int ell_spmm(const void* vals, int vals_bf16, const void* cols,
                        int cols_i16, const void* x, int x_bf16, int n_cols,
                        int B, float* out, long long T, int R, int W,
                        int fused, long long row0, long long n_rows,
                        int tiles_per_block, void* stream) {
  // four columns per lane when B and x's alignment allow one load for them
  const size_t x_align = x_bf16 ? 8 : 16;
  const int cpl = (B % 4 == 0 && (uintptr_t)x % x_align == 0) ? 4 : 1;
  const int bc = spmm::col_chunk(B / cpl);
  const int wpr = spmm::warps_per_row((long long)T * R, W, 32 / bc, kUnroll);
  // blocks of kWarps / wpr rows: as many blocks as item_grid gives for
  // R * wpr warp-sized items per tile
  const dim3 grid = spmm::item_grid(T, R * wpr, tiles_per_block);
  (cpl == 4 ? launch<4> : launch<1>)(
      vals, vals_bf16, cols, cols_i16, x, x_bf16, n_cols, B, bc, out, T, R, W,
      fused, row0, n_rows, tiles_per_block, wpr, grid, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The grouped K7: n buckets (spmm::BucketIn) in one launch, each bucket's
// (T*R, B) sums at its out_row of the slab out; four columns a lane on the
// same condition as ell_spmm, so every row keeps ell_spmm's bits.
extern "C" int ell_spmm_grouped(const spmm::BucketIn* buckets, int n,
                                int vals_bf16, int cols_i16, const void* x,
                                int x_bf16, int n_cols, int B, float* out,
                                void* stream) {
  const size_t x_align = x_bf16 ? 8 : 16;
  const bool four = B % 4 == 0 && (uintptr_t)x % x_align == 0;
  return (four ? spmm::launch_grouped<kUnroll, 4>
               : spmm::launch_grouped<kUnroll, 1>)(
      buckets, n, vals_bf16, cols_i16, x, x_bf16, n_cols, B, out,
      (cudaStream_t)stream);
}
