// Ordered rowmap combine for Hopper (sm_90a): the scatter-add that
// gathers tile partials into y, in an order fixed when the plan is built.
//
// Replaces no Pallas kernel. The reference's combine is an XLA scatter
// (`y.at[safe].add(flat, mode="drop")`,
// src/repro/core/kernel_builder.py:395 and :452),
// and the port's dense plans use `index_add_`, which adds with atomics on
// the card: where several partials land in one row, their order, and so
// the row's last bits, can change from call to call. A sharded plan cuts
// every ELL row into ceil(W / 8) chunks of the same output row (the
// (8, 8) re-tiling of repro_torch/dist/spmv.py), 12.6 a row on the
// serving matrix in col mode, and the reference holds a sharded plan
// bit-exact against its saved-and-loaded copy. So the sharded path, and
// every dense plan's rowmap step, adds its partials through this kernel.
//
// Operands: perm lists the flat partials with a row (rowmap >= 0), sorted
// by row, stably, so each row's partials keep their flat order; offsets
// (n_rows + 1) bound each row's run in perm. y (n_rows, B) += each row's
// partials of flat (N, B), added one after another in perm order into one
// fp32 accumulator that starts at y's value: the same chain of adds as the
// plain version (`rowmap_combine_ref`), so the same bits on every call and
// for every choice of the lanes below. Rows with an empty run are not
// touched; one writer a (row, column), no atomics.
//
// Bound on the H100: device-memory bytes, each partial read once (4 bytes
// a column, plus its 4-byte perm entry), offsets read once, y read and
// written once; one add a partial. What held the first version (one
// thread a (row, column), walking its run alone) far below it: at the
// sharded shapes too few threads (12,288 rows at B = 1 are 48 blocks on
// 132 SMs) and, per partial, a perm load followed by a dependent flat
// load. The design:
// - a group of kParts * C lanes owns one row: kParts (2) partial lanes
//   times C column lanes (C covers B, or B / 4 with 16-byte loads, up to
//   16). The group loads perm[lo ..) coalesced, kUnroll * kParts entries
//   at a time, and then their flat values, all in flight together;
// - every lane of the group then adds the chunk's values in perm order
//   into its accumulator, each taken from its partial lane by __shfl_sync:
//   the loads and shuffles do not wait on the accumulator, only the adds
//   are serial. The partial lane 0 of each column writes the row;
// - 32 / (kParts * C) rows share a warp. Where the rows alone give the
//   card kEnoughThreads (row, column) threads, or B needs more than 16
//   column lanes, one thread a row walks its run alone instead
//   (rowmap_combine_thread): the group's shuffles and uniform loop cost
//   more instructions than the loads they overlap. More partial lanes a
//   row (4 to 32) were no faster than 2 at any shape measured on the H100
//   (12.6, 3.55 and 1.003 partials a row; PERF.md);
// - the group's loop bounds are uniform over the warp (its longest run),
//   so a long run costs its warp, and only its warp, ceil(run / (kUnroll
//   * kParts)) rounds;
// - where B % 4 == 0 and y and flat are 16-byte aligned (checked here, on
//   the host, as ell_spmm does), a column lane reads 4 columns at once.
// Measured on the H100 (chip_smoke.py's combine rows, PERF.md): at the
// sharded shapes the kernel takes about 1.5 us more than a one-element
// kernel (0.0052 ms on the card), where the first version took about
// 2.1 us more; what is left is the chain of loads offsets -> perm -> flat.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;
constexpr int kParts = 2;             // partial lanes a row
// (row, column vector) threads above which a row gets one thread
constexpr long long kEnoughThreads = 65536;
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load_cols(float (&v)[VEC],
                                          const float* __restrict__ p) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void read_y(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void write_y(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// One thread a (row, column vector) walks its run alone, as the first
// version did (with 16-byte loads where it can)
template <int VEC>
__global__ void __launch_bounds__(kThreads)
rowmap_combine_thread(float* __restrict__ y, const float* __restrict__ flat,
                      const int* __restrict__ perm,
                      const long long* __restrict__ offsets,
                      long long n_rows, int B) {
  const int n_cv = B / VEC;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rows * n_cv) return;
  const long long u = i / n_cv;
  const int col = (int)(i - u * n_cv) * VEC;
  const long long lo = offsets[u], hi = offsets[u + 1];
  if (lo == hi) return;
  float acc[VEC];
  read_y<VEC>(acc, y + u * B + col);
#pragma unroll 4
  for (long long j = lo; j < hi; ++j) {
    float v[VEC];
    load_cols<VEC>(v, flat + (long long)__ldg(perm + j) * B + col);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += v[e];
  }
  write_y<VEC>(y + u * B + col, acc);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
rowmap_combine_kernel(float* __restrict__ y, const float* __restrict__ flat,
                      const int* __restrict__ perm,
                      const long long* __restrict__ offsets, long long n_rows,
                      int B, int C) {
  const int lane = threadIdx.x & 31;
  const int G = kParts * C;                      // lanes a row
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int g = lane / G, p = (lane % G) / C, c = lane % C;
  const long long u = warp * (32 / G) + g;
  long long lo = 0;
  int len = 0;
  if (u < n_rows) {
    lo = offsets[u];
    len = (int)(offsets[u + 1] - lo);
  }
  const int wmax = __reduce_max_sync(kFull, len);
  if (wmax == 0) return;                         // the whole warp
  const int src = g * G + c;                     // partial lane 0, column c
  const int col = c * VEC;                       // C * VEC >= B
  const bool on = col < B;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  if (on && len > 0) read_y<VEC>(acc, y + u * B + col);
  for (int j0 = 0; j0 < wmax; j0 += kUnroll * kParts) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = j0 + k * kParts + p;
      if (on && j < len) {
        load_cols<VEC>(v[k], flat + (long long)__ldg(perm + lo + j) * B +
                                 col);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[k][e] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        const int j = j0 + k * kParts + q;
        if (j >= wmax) break;                    // uniform over the warp
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float w = __shfl_sync(kFull, v[k][e], src + q * C);
          if (j < len) acc[e] += w;
        }
      }
    }
  }
  if (on && len > 0 && p == 0) write_y<VEC>(y + u * B + col, acc);
}

}  // namespace

// y (n_rows, B) += the partials of flat (N, B) that perm and offsets give
// each row, in perm order: a group of lanes a row where the rows are few,
// one thread a row where they are many. The lanes never change a bit.
extern "C" int rowmap_combine(float* y, const float* flat, const int* perm,
                              const long long* offsets, long long n_rows,
                              int B, void* stream) {
  if (n_rows == 0 || B <= 0) return 0;
  const bool vec = B % 4 == 0 && (uintptr_t)y % 16 == 0 &&
                   (uintptr_t)flat % 16 == 0;
  const int cols = vec ? B / 4 : B;
  int C = 1;
  while (C < cols) C *= 2;
  cudaStream_t s = (cudaStream_t)stream;
  if (kParts * C > 32 || n_rows * cols >= kEnoughThreads) {
    const long long n = n_rows * cols;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    if (vec) {
      rowmap_combine_thread<4><<<blocks, kThreads, 0, s>>>(
          y, flat, perm, offsets, n_rows, B);
    } else {
      rowmap_combine_thread<1><<<blocks, kThreads, 0, s>>>(
          y, flat, perm, offsets, n_rows, B);
    }
    return (int)cudaGetLastError();
  }
  const long long rows_a_warp = 32 / (kParts * C);
  const long long warps = (n_rows + rows_a_warp - 1) / rows_a_warp;
  const unsigned blocks =
      (unsigned)((warps * 32 + kThreads - 1) / kThreads);
  if (vec) {
    rowmap_combine_kernel<4><<<blocks, kThreads, 0, s>>>(
        y, flat, perm, offsets, n_rows, B, C);
  } else {
    rowmap_combine_kernel<1><<<blocks, kThreads, 0, s>>>(
        y, flat, perm, offsets, n_rows, B, C);
  }
  return (int)cudaGetLastError();
}
