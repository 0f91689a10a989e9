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
// block in the fused kernel, walked in turn). The mode is a template
// argument, chosen on the host.
//  * seg_scan (K3): the tile's products are scanned in passes of 256
//    slots: coalesced loads, a warp-shuffle inclusive scan, a scan of the
//    8 warp totals, and a running carry. The inclusive sums cs[0..C) stay
//    in shared memory (C <= 8192 floats = 32 KB). The TPU kernel's rule
//    then holds exactly: g[m] = cs[end[m]-1], or 0 where end[m] = 0, and
//    the partial is g[m] - g[m-1].
//  * onehot_mxu (K4): the TPU routes the reduction through its matrix
//    unit as a product with a one-hot matrix: partial[m] = sum of the
//    products whose local row is m; a local row outside [0, M) matches no
//    column of the one-hot matrix and adds nothing. For one right-hand
//    side that is C*M multiply-adds for C useful ones, so here the
//    products are summed by run instead, with the blocked run reduction
//    of runs.cuh (one column, one lane a slot group): in passes of 2048
//    slots each thread loads 8 consecutive slots' local rows, vals and
//    cols (16-byte vector loads when C % 8 == 0 and the three arrays are
//    16-byte aligned, checked on the host; scalar loads otherwise), then
//    the 8 x gathers, all independent; runs of equal local row are summed
//    in registers and over the warp, and the thread that ends a run adds
//    it into a shared float[M] with one atomicAdd. A local row outside
//    [0, M) gets the key kNone and adds nothing. The packer emits local
//    rows sorted within a tile, so the atomics per tile fall from C to
//    about (distinct rows + warps per pass); the sums are right for any
//    local_row (unsorted, repeated, out of range), only fast for
//    sorted ones. seg_end is not read, as the TPU kernel does not read it.
//  * fused (K6): the TPU adds tile t's partials at y[r0[t] + m] on a
//    resident output block, in sequential grid order; a row that
//    straddles tiles t and t+1 gets its second add on top of the first.
//    Blocks on the GPU run in parallel and in any order, so the adds are
//    atomicAdd into y. Rows >= n_rows are masked: the TPU clamps an
//    out-of-range slice write, the GPU would corrupt memory.
// runs.cuh holds the 8-slot loads and the run helpers, which the seg SpMM
// kernels K10a/K10b/K11 run for B columns.
// Atomics add in an order that changes from run to run, so sums agree
// with the plain version to a tolerance, not bit for bit.
#include "runs.cuh"

namespace {

using runs::kPass;
using runs::kPer;
using runs::load_run;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the modes: host modes 0 (seg_scan) and 1 (onehot_mxu, scalar or vector
// loads)
constexpr int kSegScan = 0, kOnehot = 1, kOnehotVec = 2;

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

// One pass of the one-hot reduction: this thread's kPer slots start at
// slot s0 of the tile at base; each run's sum is added into buf[row] by
// the thread that ends it. A slot at or past Cn, or whose local row is
// outside [0, M), gets the key kNone and adds nothing.
template <bool kVec, typename V, typename C, typename X>
__device__ __forceinline__ void onehot_pass(
    const V* __restrict__ vals, const C* __restrict__ cols,
    const int* __restrict__ local, const X* __restrict__ x, int n_cols,
    long long base, int s0, int Cn, int M, float* buf) {
  int key[kPer], col[kPer];
  float v[kPer];
  // with kVec, Cn % kPer == 0: the kPer slots are all in or all out
  if constexpr (kVec) {
    if (s0 < Cn) {
      load_run(local + base + s0, key);
      load_run(cols + base + s0, col);
      load_run(vals + base + s0, v);
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) key[k] = -1, col[k] = -1, v[k] = 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool in = s0 + k < Cn;
      key[k] = in ? local[base + s0 + k] : -1;
      col[k] = in ? to_i32(cols[base + s0 + k]) : -1;
      v[k] = in ? to_f32(vals[base + s0 + k]) : 0.f;
    }
  }
  // the products first: holding the x gathers in flight across the run
  // structure's shuffles took 40 registers instead of 32, which cost the
  // fused kernel's blocks of several tiles more than it saved
  float p[kPer][1];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    p[k][0] = v[k] *
              ((unsigned)col[k] < (unsigned)n_cols ? to_f32(x[col[k]]) : 0.f);
    if ((unsigned)key[k] >= (unsigned)M) key[k] = runs::kNone;
  }
  const runs::Runs r = runs::run_structure<1>(key);
  runs::add_runs<1, 1>(r, key, p, buf, 1, 0);
}

// Partials of tiles [t0, t1) per block: out[t, m] (fused = 0) or
// atomicAdd into y[r0[t] + m] masked at n_rows (fused = 1).
// aux is seg_end (T, M) for seg_scan, local_row (T, Cn) for one-hot.
template <typename V, typename C, typename X, int kMode>
__global__ void __launch_bounds__(kThreads)
seg_tiles_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                 const int* __restrict__ aux, const X* __restrict__ x,
                 int n_cols, long long T, int Cn, int M, int fused,
                 float* __restrict__ out, const int* __restrict__ r0,
                 long long n_rows, int tiles_per_block) {
  // seg_scan: max(Cn, M) + kWarps floats; one-hot: M floats
  extern __shared__ float smem[];
  float* buf = smem;
  const long long t0 = (long long)blockIdx.x * tiles_per_block;
  const long long t1 = min(t0 + tiles_per_block, T);
  for (long long t = t0; t < t1; ++t) {
    const long long base = t * Cn;
    if constexpr (kMode == kSegScan) {
      scan_tile(vals, cols, x, n_cols, base, Cn, buf, smem + max(Cn, M));
    } else {
      for (int m = threadIdx.x; m < M; m += kThreads) buf[m] = 0.f;
      __syncthreads();
      for (int start = 0; start < Cn; start += kPass) {
        onehot_pass<kMode == kOnehotVec>(vals, cols, aux, x, n_cols, base,
                                         start + threadIdx.x * kPer, Cn, M,
                                         buf);
      }
      __syncthreads();
    }
    for (int m = threadIdx.x; m < M; m += kThreads) {
      float v = buf[m];
      if constexpr (kMode == kSegScan) {
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

template <typename V, typename C, typename X, int kMode>
int launch(const void* vals, const void* cols, const void* x, int n_cols,
           const int* aux, long long T, int Cn, int M, int fused, float* out,
           const int* r0, long long n_rows, int tiles_per_block,
           cudaStream_t s) {
  const unsigned blocks =
      (unsigned)((T + tiles_per_block - 1) / tiles_per_block);
  const int floats = kMode == kSegScan ? (Cn > M ? Cn : M) + kWarps : M;
  const size_t smem = (size_t)floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        seg_tiles_kernel<V, C, X, kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  seg_tiles_kernel<V, C, X, kMode><<<blocks, kThreads, smem, s>>>(
      (const V*)vals, (const C*)cols, aux, (const X*)x, n_cols, T, Cn, M,
      fused, out, r0, n_rows, tiles_per_block);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// mode: 0 seg_scan, 1 onehot_mxu. fused = 0: out is (T, M) partials and
// r0 / n_rows are unused; fused = 1: out is y (n_rows,).
extern "C" int seg_tiles(const void* vals, int vals_bf16, const void* cols,
                         int cols_i16, const void* x, int x_bf16, int n_cols,
                         const int* aux, long long T, int Cn, int M, int mode,
                         int fused, float* out, const int* r0,
                         long long n_rows, int tiles_per_block,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = Cn % kPer == 0 && aligned16(vals) && aligned16(cols) &&
                   aligned16(aux);
  const int kind = mode == kSegScan ? kSegScan : vec ? kOnehotVec : kOnehot;
  SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16, switch (kind) {
    case kSegScan:
      return launch<V, C, X, kSegScan>(vals, cols, x, n_cols, aux, T, Cn, M,
                                       fused, out, r0, n_rows,
                                       tiles_per_block, s);
    case kOnehot:
      return launch<V, C, X, kOnehot>(vals, cols, x, n_cols, aux, T, Cn, M,
                                      fused, out, r0, n_rows,
                                      tiles_per_block, s);
    default:
      return launch<V, C, X, kOnehotVec>(vals, cols, x, n_cols, aux, T, Cn,
                                         M, fused, out, r0, n_rows,
                                         tiles_per_block, s);
  });
  return 0;  // not reached
}
