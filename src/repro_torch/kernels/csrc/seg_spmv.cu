// Per-tile segmented-reduction kernels K3, K4 and K6 for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels in src/repro/kernels/seg_spmv.py:
//   K3 seg_spmv_pallas, mode seg_scan   (_seg_scan_partial)  -> seg_tiles
//   K4 seg_spmv_pallas, mode onehot_mxu (_onehot_partial)    -> seg_tiles
//   K6 seg_spmv_fused_pallas, both modes (_seg_fused_kernel) -> seg_tiles
//      with fused = 1
//
// Bound on the H100: device-memory bytes. Each nnz slot is read once
// (vals, cols, plus local_row for one-hot) for 2 flops, and each tile
// writes M partials. x is gathered, from L2 where it fits.
//
// Design: one block of 256 threads per tile of C = S*L slots (K tiles per
// block in the fused kernel, walked in turn).
//  * seg_scan (K3): the tile's products are scanned in passes of 256
//    slots: coalesced loads, a warp-shuffle inclusive scan, a scan of the
//    8 warp totals, and a running carry. The inclusive sums cs[0..C) stay
//    in shared memory (C <= 8192 floats = 32 KB). The TPU kernel's rule
//    then holds exactly: g[m] = cs[end[m]-1], or 0 where end[m] = 0, and
//    the partial is g[m] - g[m-1].
//  * onehot_mxu (K4): the TPU routes the reduction through its matrix
//    unit as a product with a one-hot matrix. For one right-hand side
//    that is C*M multiply-adds for C useful ones; here each product is
//    added into a shared float[M] at its local row with a shared-memory
//    atomic. Slots whose local row is outside [0, M) add nothing, as a
//    one-hot row of zeros would.
//  * fused (K6): the TPU adds tile t's partials at y[r0[t] + m] on a
//    resident output block, in sequential grid order; a row that
//    straddles tiles t and t+1 gets its second add on top of the first.
//    Blocks on the GPU run in parallel and in any order, so the adds are
//    atomicAdd into y. Rows >= n_rows are masked: the TPU clamps an
//    out-of-range slice write, the GPU would corrupt memory.
// Atomics add in an order that changes from run to run, so sums agree
// with the plain version to a tolerance, not bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegScan = 0;  // mode 1 is onehot_mxu

// In-place inclusive scan of the tile's products into cs[0..Cn).
template <typename V, typename C, typename X>
__device__ void scan_tile(const V* __restrict__ vals,
                          const C* __restrict__ cols,
                          const X* __restrict__ x, int n_cols, long long base,
                          int Cn, float* cs, float* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int start = 0; start < Cn; start += kThreads) {
    const int c = start + threadIdx.x;
    float v = (c < Cn) ? nz_product(vals, cols, x, n_cols, base + c) : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += up;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = (lane < kWarps) ? warp_sums[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += up;
      }
      if (lane < kWarps) warp_sums[lane] = w;
    }
    __syncthreads();
    const float before = (warp > 0) ? warp_sums[warp - 1] : 0.f;
    if (c < Cn) cs[c] = carry + (before + v);
    carry += warp_sums[kWarps - 1];
    __syncthreads();  // warp_sums is rewritten by the next pass
  }
}

__device__ __forceinline__ float scan_g(const float* cs, const int* end,
                                        int m, int Cn) {
  const int e = end[m];
  return (e > 0) ? cs[min(e, Cn) - 1] : 0.f;
}

// Partials of tiles [t0, t1) per block: out[t, m] (fused = 0) or
// atomicAdd into y[r0[t] + m] masked at n_rows (fused = 1).
// aux is seg_end (T, M) for seg_scan, local_row (T, Cn) for onehot_mxu.
template <typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
seg_tiles_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                 const int* __restrict__ aux, const X* __restrict__ x,
                 int n_cols, long long T, int Cn, int M, int mode, int fused,
                 float* __restrict__ out, const int* __restrict__ r0,
                 long long n_rows, int tiles_per_block) {
  extern __shared__ float smem[];  // max(Cn, M) floats + kWarps floats
  float* buf = smem;
  float* warp_sums = smem + max(Cn, M);
  const long long t0 = (long long)blockIdx.x * tiles_per_block;
  const long long t1 = min(t0 + tiles_per_block, T);
  for (long long t = t0; t < t1; ++t) {
    const long long base = t * Cn;
    if (mode == kSegScan) {
      scan_tile(vals, cols, x, n_cols, base, Cn, buf, warp_sums);
    } else {
      for (int m = threadIdx.x; m < M; m += kThreads) buf[m] = 0.f;
      __syncthreads();
      const int* local = aux + base;
      for (int c = threadIdx.x; c < Cn; c += kThreads) {
        const int l = local[c];
        if ((unsigned)l < (unsigned)M) {
          atomicAdd(&buf[l], nz_product(vals, cols, x, n_cols, base + c));
        }
      }
      __syncthreads();
    }
    for (int m = threadIdx.x; m < M; m += kThreads) {
      float v = buf[m];
      if (mode == kSegScan) {
        const int* end = aux + t * M;
        v = scan_g(buf, end, m, Cn) -
            (m > 0 ? scan_g(buf, end, m - 1, Cn) : 0.f);
      }
      if (fused) {
        const long long row = (long long)r0[t] + m;
        if (row >= 0 && row < n_rows) atomicAdd(out + row, v);
      } else {
        out[t * M + m] = v;
      }
    }
    __syncthreads();  // buf is rewritten by the next tile
  }
}

}  // namespace

// mode: 0 seg_scan, 1 onehot_mxu. fused = 0: out is (T, M) partials and
// r0 / n_rows are unused; fused = 1: out is y (n_rows,).
extern "C" int seg_tiles(const void* vals, int vals_bf16, const void* cols,
                         int cols_i16, const void* x, int x_bf16, int n_cols,
                         const int* aux, long long T, int Cn, int M, int mode,
                         int fused, float* out, const int* r0,
                         long long n_rows, int tiles_per_block,
                         void* stream) {
  const unsigned blocks =
      (unsigned)((T + tiles_per_block - 1) / tiles_per_block);
  const size_t smem = (size_t)((Cn > M ? Cn : M) + kWarps) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  SPMV_DISPATCH(
      vals_bf16, cols_i16, x_bf16,
      if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            seg_tiles_kernel<V, C, X>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
      } seg_tiles_kernel<V, C, X><<<blocks, kThreads, smem, s>>>(
          (const V*)vals, (const C*)cols, aux, (const X*)x, n_cols, T, Cn, M,
          mode, fused, out, r0, n_rows, tiles_per_block));
  return (int)cudaGetLastError();
}
