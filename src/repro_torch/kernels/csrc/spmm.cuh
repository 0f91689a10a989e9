// Shared helpers of the multi-RHS (SpMM) kernels K7-K11.
//
// x is row-major (n_cols, B): one gathered row x[col] is B contiguous
// values. A warp works on one output row (ELL) or one segment (seg_scan)
// and splits its 32 lanes into groups of `bc` lanes, bc the smallest power
// of two >= min(B, 32): lane j of a group owns column c0 + j of the current
// column chunk, and the 32 / bc groups stride over the row's slots. Lanes of
// one group read the same vals/cols element (a broadcast) and neighbouring
// x values; the groups' sums are combined with xor shuffles. B = 1 gives
// the 1-RHS layout (32 groups of one lane); B > 32 loops over chunks of 32
// columns. All loads are scalar, so no B or element size needs alignment.
#pragma once

#include "common.cuh"

namespace spmm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// smallest power of two >= min(B, 32)
inline int col_chunk(int B) {
  int bc = 1;
  while (bc < B && bc < 32) bc <<= 1;
  return bc;
}

// This lane's share of sum_{i in [lo, hi)} vals[i] * x[cols[i], b]: slots
// i = lo + g, lo + g + groups, ... A column outside [0, n_cols) and a
// column b >= B contribute 0.
template <typename V, typename C, typename X>
__device__ __forceinline__ float range_dot(const V* __restrict__ vals,
                                           const C* __restrict__ cols,
                                           const X* __restrict__ x,
                                           int n_cols, int B, long long lo,
                                           long long hi, int b, int g,
                                           int groups) {
  float acc = 0.f;
  if (b >= B) return acc;
  for (long long i = lo + g; i < hi; i += groups) {
    const int col = to_i32(cols[i]);
    const float xv = ((unsigned)col < (unsigned)n_cols)
                         ? to_f32(x[(long long)col * B + b])
                         : 0.f;
    acc += to_f32(vals[i]) * xv;
  }
  return acc;
}

// Sum over the 32 / bc lane groups; every lane ends with its column's sum.
// All 32 lanes must call it.
__device__ __forceinline__ float reduce_groups(float acc, int bc) {
  for (int o = bc; o < 32; o <<= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  }
  return acc;
}

// Grid of the warp-per-item kernels: x walks groups of `tiles_per_block`
// tiles, y slices the group's items (rows or segments) over blocks of
// kWarps warps, so the card fills whatever tiles_per_block is.
inline dim3 item_grid(long long T, int items_per_tile, int tiles_per_block) {
  const long long gx = (T + tiles_per_block - 1) / tiles_per_block;
  long long gy =
      ((long long)tiles_per_block * items_per_tile + kWarps - 1) / kWarps;
  if (gy > 65535) gy = 65535;  // the warps then stride over the rest
  if (gy < 1) gy = 1;
  return dim3((unsigned)gx, (unsigned)gy, 1);
}

}  // namespace spmm
