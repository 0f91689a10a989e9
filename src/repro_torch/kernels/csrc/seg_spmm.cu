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
// Bound on the H100: device-memory bytes. Each nnz slot is read once
// (vals, cols, plus local_row for one-hot) for 2*B flops, each tile
// writes M*B partials (or adds them into y), and x is gathered row by row
// from L2 where it fits.
//
// Design:
//  * seg_scan (K10a): the TPU scans the tile's (C, B) products along the
//    nnz axis and takes g[m] = cs[end[m]-1] (0 where end[m] = 0), partial
//    g[m] - g[m-1]. A stored scan would need C*B*4 bytes of shared memory
//    (256 KB at C = 8192, B = 8: more than a block may have), so the
//    kernel carries no scan at all: with S(e) the sum of the first e
//    products, g[m] = S(e_m) with e_m = end[m] clamped to [0, C] (K3 clamps
//    at C too), and g[m] - g[m-1] = S(e_m) - S(e_{m-1}) is the sum of the
//    products in [e_{m-1}, e_m), negated when the ends descend. One warp
//    takes one segment and sums that range with the lane groups of
//    spmm.cuh. Real tiles have ascending ends, so every slot is read once;
//    padding tiles (every end 0) and unused slots (end = C after the last
//    segment) give empty ranges and exact zeros, as the scan does.
//  * onehot_mxu (K10b): the TPU multiplies an (M, C) one-hot matrix by the
//    (C, B) products on its matrix unit: C*M*B multiply-adds for C*B
//    useful ones. Here each product is added into a shared-memory
//    accumulator acc[m][j] at its local row with a shared-memory atomic.
//    The block walks its tiles; each tile's M rows go in chunks that fit
//    48 KB of shared memory, and columns in chunks of bc (the grid's y
//    axis). Slots whose local row is outside [0, M) add nothing, as a
//    one-hot row of zeros would.
//  * fused (K11): the TPU adds tile t's partials at y[r0[t] + m, :] on a
//    resident output block, in sequential grid order, so a row that
//    straddles tiles t and t+1 gets its second add on top of the first.
//    Blocks on the GPU run in parallel and in any order, so the adds are
//    atomicAdd into y. Rows >= n_rows are masked: the TPU clamps an
//    out-of-range slice write, the GPU would corrupt memory.
// The sums are taken in another order than the plain version's scan, and
// atomics add in an order that changes from run to run, so results agree
// with the plain version to a tolerance, not bit for bit.
#include "spmm.cuh"

namespace {

using spmm::kThreads;
using spmm::kWarps;

constexpr int kSegScan = 0;  // mode 1 is onehot_mxu
constexpr int kOnehotSmemFloats = 48 * 1024 / 4;

__device__ __forceinline__ int clamp_end(int e, int Cn) {
  return e < 0 ? 0 : (e > Cn ? Cn : e);
}

// K10a / K11 seg_scan: one warp per (tile, segment) of this block's tile
// group. fused = 0: out[t, m, b]; fused = 1: atomicAdd into y[r0[t]+m, b].
template <typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
seg_scan_spmm_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                     const int* __restrict__ seg_end, const X* __restrict__ x,
                     int n_cols, int B, int bc, long long T, int Cn, int M,
                     int fused, float* __restrict__ out,
                     const int* __restrict__ r0, long long n_rows,
                     int tiles_per_block) {
  const int lane = threadIdx.x & 31;
  const int g = lane / bc, j = lane % bc, groups = 32 / bc;
  const long long t0 = (long long)blockIdx.x * tiles_per_block;
  const long long t1 = min(t0 + tiles_per_block, T);
  const long long stride = (long long)gridDim.y * kWarps;
  for (long long item = t0 * M + (long long)blockIdx.y * kWarps +
                        (threadIdx.x >> 5);
       item < t1 * M; item += stride) {  // warp-uniform
    const long long t = item / M;
    const int m = (int)(item - t * M);
    const int* end = seg_end + t * M;
    int hi = clamp_end(end[m], Cn);
    int lo = m > 0 ? clamp_end(end[m - 1], Cn) : 0;
    float sign = 1.f;
    if (hi < lo) {
      const int tmp = hi;
      hi = lo;
      lo = tmp;
      sign = -1.f;
    }
    if (fused && hi == lo) continue;  // adds exactly zero; warp-uniform
    const long long base = t * Cn;
    for (int c0 = 0; c0 < B; c0 += bc) {
      const int b = c0 + j;
      float acc = spmm::range_dot(vals, cols, x, n_cols, B, base + lo,
                                  base + hi, b, g, groups);
      acc = sign * spmm::reduce_groups(acc, bc);
      if (g != 0 || b >= B) continue;
      if (fused) {
        const long long row = (long long)r0[t] + m;
        if (row >= 0 && row < n_rows) atomicAdd(out + row * B + b, acc);
      } else {
        out[item * B + b] = acc;
      }
    }
  }
}

// K10b / K11 onehot_mxu: a block per (tile group, column chunk of bc).
// Thread (grp, j) = (tid / bc, tid % bc) takes slots grp, grp + 256/bc, ...
template <typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
onehot_spmm_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                   const int* __restrict__ local_row,
                   const X* __restrict__ x, int n_cols, int B, int bc,
                   long long T, int Cn, int M, int Mc, int fused,
                   float* __restrict__ out, const int* __restrict__ r0,
                   long long n_rows, int tiles_per_block) {
  extern __shared__ float acc[];  // Mc * bc floats
  const int j = threadIdx.x % bc, grp = threadIdx.x / bc;
  const int ngrp = kThreads / bc;
  const int c0 = blockIdx.y * bc;
  const int b = c0 + j;
  const long long t0 = (long long)blockIdx.x * tiles_per_block;
  const long long t1 = min(t0 + tiles_per_block, T);
  for (long long t = t0; t < t1; ++t) {
    const long long base = t * Cn;
    for (int m0 = 0; m0 < M; m0 += Mc) {
      const int mn = min(Mc, M - m0);
      for (int i = threadIdx.x; i < mn * bc; i += kThreads) acc[i] = 0.f;
      __syncthreads();
      if (b < B) {
        for (int c = grp; c < Cn; c += ngrp) {
          const int l = local_row[base + c] - m0;
          if ((unsigned)l < (unsigned)mn) {
            const int col = to_i32(cols[base + c]);
            const float xv = ((unsigned)col < (unsigned)n_cols)
                                 ? to_f32(x[(long long)col * B + b])
                                 : 0.f;
            atomicAdd(&acc[l * bc + j], to_f32(vals[base + c]) * xv);
          }
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < mn * bc; i += kThreads) {
        const int m = m0 + i / bc, bb = c0 + i % bc;
        if (bb >= B) continue;
        const float v = acc[i];
        if (fused) {
          const long long row = (long long)r0[t] + m;
          if (v != 0.f && row >= 0 && row < n_rows) {
            atomicAdd(out + row * B + bb, v);
          }
        } else {
          out[(t * M + m) * B + bb] = v;
        }
      }
      __syncthreads();  // acc is rewritten by the next chunk
    }
  }
}

}  // namespace

// mode: 0 seg_scan (aux = seg_end (T, M)), 1 onehot_mxu (aux = local_row
// (T, Cn)). fused = 0: out is (T, M, B) partials and r0 / n_rows are
// unused; fused = 1: out is y (n_rows, B).
extern "C" int seg_spmm(const void* vals, int vals_bf16, const void* cols,
                        int cols_i16, const void* x, int x_bf16, int n_cols,
                        int B, const int* aux, long long T, int Cn, int M,
                        int mode, int fused, float* out, const int* r0,
                        long long n_rows, int tiles_per_block, void* stream) {
  const int bc = spmm::col_chunk(B);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kSegScan) {
    const dim3 grid = spmm::item_grid(T, M, tiles_per_block);
    SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16,
                  seg_scan_spmm_kernel<V, C, X><<<grid, kThreads, 0, s>>>(
                      (const V*)vals, (const C*)cols, aux, (const X*)x,
                      n_cols, B, bc, T, Cn, M, fused, out, r0, n_rows,
                      tiles_per_block));
  } else {
    const int cap = kOnehotSmemFloats / bc;
    const int Mc = M < cap ? M : cap;
    const dim3 grid((unsigned)((T + tiles_per_block - 1) / tiles_per_block),
                    (unsigned)((B + bc - 1) / bc), 1);
    const size_t smem = (size_t)Mc * bc * sizeof(float);
    SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16,
                  onehot_spmm_kernel<V, C, X><<<grid, kThreads, smem, s>>>(
                      (const V*)vals, (const C*)cols, aux, (const X*)x,
                      n_cols, B, bc, T, Cn, M, Mc, fused, out, r0, n_rows,
                      tiles_per_block));
  }
  return (int)cudaGetLastError();
}
