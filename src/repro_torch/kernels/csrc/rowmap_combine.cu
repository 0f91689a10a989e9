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
// (8, 8) re-tiling of repro_torch/dist/spmv.py), about 41 a row on the
// serving matrix in row mode, and the reference holds a sharded plan
// bit-exact against its saved-and-loaded copy. So the sharded path adds
// its partials through this kernel.
//
// Operands: perm lists the flat partials with a row (rowmap >= 0), sorted
// by row, stably, so each row's partials keep their flat order; offsets
// (n_rows + 1) bound each row's run in perm. With a compact row list
// (the rows that the fused seg kernels K6 / K11 leave to a side buffer,
// few of y's), offsets bound each listed row's run. One thread owns one (row, b)
// element of y (n_rows, B) and adds the row's partials to it one after
// another, in perm order: no two threads write one element, no atomics,
// and the sum is the same on every call. The plain version
// (`rowmap_combine_ref`) adds in the same order.
//
// Bound on the H100: device-memory bytes, each partial read once (4 bytes
// a column, plus its 4-byte perm entry) and y read and written once; one
// add a partial. Neighbouring threads take neighbouring columns of a row,
// so at B = 8 a row's reads of one partial share a 32-byte sector.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rowmap_combine_kernel(float* __restrict__ y, const float* __restrict__ flat,
                      const int* __restrict__ perm,
                      const long long* __restrict__ offsets,
                      const int* __restrict__ rows, long long n_out, int B) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out * B) return;
  const long long u = i / B;
  const int b = (int)(i - u * B);
  const long long lo = offsets[u], hi = offsets[u + 1];
  if (lo == hi) return;
  const long long at = (rows ? (long long)rows[u] : u) * B + b;
  float acc = y[at];
  for (long long j = lo; j < hi; ++j) {
    acc += flat[(long long)perm[j] * B + b];
  }
  y[at] = acc;
}

}  // namespace

// y (n_rows, B) += the partials of flat (N, B) that perm and offsets give
// each output row, in perm order. The output rows are y's rows 0 ..
// n_out - 1 (rows = NULL, n_out = n_rows), or rows[0 .. n_out) (distinct:
// a compact list, as for the fused seg kernels' shared rows).
extern "C" int rowmap_combine(float* y, const float* flat, const int* perm,
                              const long long* offsets, const int* rows,
                              long long n_out, int B, void* stream) {
  const long long n = n_out * B;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  rowmap_combine_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      y, flat, perm, offsets, rows, n_out, B);
  return (int)cudaGetLastError();
}
