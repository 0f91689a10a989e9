// The flush of the fused seg kernels K6 (seg_spmv.cu) and K11
// (seg_spmm.cu): where each (tile, segment) partial goes, and how the rows
// that several tiles share are added into y inside the kernel's launch.
//
// The placement is the wrapper's FusedRows (kernels/combine.py
// fused_rows, built once per plan). A row that one pair adds into gets
// that pair's partial with an atomic without a return (its one writer, so
// y[d] + v). A row that several pairs add into is "listed"; its pairs'
// partials are added in (tile, segment) order: acc = y[row]; acc +=
// first; acc += second; ... That is rowmap_combine_kernel's sum
// (rowmap_combine.cu) over the pairs' side slots in perm order, so the
// bits are those of the unfused kernel's partials combined by it.
//
// The last pair of a row to arrive adds the row; no pair waits for
// another, so the order in which blocks run does not matter. Each pair's
// thread holds the card for one round trip to L2 at the end of its block,
// so the protocol keeps that trip short:
//  * A row of two pairs (almost all shared rows: the packers' tiles split
//    a row at most once unless it is longer than a tile) is exchanged
//    through one 64-bit cell a column: each pair swaps (its rank, its
//    partial) into the empty cell with atomicCAS; the one that finds the
//    other's there is the second, adds y[row] + first + second and
//    empties the cell. The data travels in the atomic, so no fence is
//    needed, and dst names the cell and the rank, so no other index is
//    loaded first. The cells have kCellCols columns; a wider x takes the
//    counted path for every row.
//  * A row of more pairs is counted: each pair writes its side slot,
//    fences (the slot is then visible to the whole card) and counts in
//    on the row's arrival counter with atomicInc, which wraps at the
//    row's count of slots; the pair that takes the counter from count - 1
//    back to 0 is the last, fences again and adds the row's slots in perm
//    order, read with L1-bypassing loads (another SM wrote them).
// Every launch leaves each cell empty and each counter at 0, without a
// reset pass, and a CUDA graph may replay it. The cells and counters are
// the plan's: one plan's fused step must not run on two streams at once.
#pragma once

#include "common.cuh"

namespace flush {

// dst codes: y row d >= 0; nothing (-1); exchange code 2u + r at -2 - dst
// (row u of the cells, rank r: 0 is the first pair in (tile, segment)
// order) for kSlotBase < dst <= -2; side slot kSlotBase - dst for dst <=
// kSlotBase
constexpr int kSlotBase = -(1 << 30);
constexpr int kCellCols = 32;  // columns of a row's exchange cells

// A fused step's FusedRows, as the kernels take it. Listed row u adds
// into y row rows[u], from its slots perm[offsets[u] .. offsets[u + 1]).
struct Rows {
  const int* dst;             // T * M pair codes (above)
  const int* n_used;          // T: past it a tile's segments add nothing
  const int* r0;              // T: tile t's segment m adds into r0[t] + m
  float* side;                // n_side * B slot partials
  const int* slot_row;        // n_side: the listed row of each slot
  const int* count;           // per listed row: its slots
  unsigned* arrive;           // per listed row: its arrival counter
  const int* perm;            // the listed rows' slots, row after row
  const long long* offsets;   // per listed row + 1: its run in perm
  const int* rows;            // per listed row: its row of y
  unsigned long long* cells;  // per listed row: kCellCols exchange cells
};

// True when pair code d adds into y through a cell at B columns.
__device__ __forceinline__ bool exchanged(int d, int B) {
  return d <= -2 && d > kSlotBase && B <= kCellCols;
}

// The side slot of a code that is not exchanged: its own, or, at a width
// past the cells, that of exchange rank r of row u.
__device__ __forceinline__ long long slot_of(const Rows& f, int d) {
  if (d <= kSlotBase) return (long long)kSlotBase - d;
  const int c = -2 - d;
  return __ldg(f.perm + __ldg(f.offsets + (c >> 1)) + (c & 1));
}

// Column b of a two-pair row: this pair's partial v, y[at] its element
// of y. The second pair adds y[at] + first + second and empties the cell.
__device__ __forceinline__ void exchange(float* y, const Rows& f, int d,
                                        long long at, int b, float v) {
  const int c = -2 - d, r = c & 1;
  unsigned long long* cell = f.cells + (long long)(c >> 1) * kCellCols + b;
  const float y0 = __ldcg(y + at);  // only this launch's second pair writes
  const unsigned long long mine =
      (1ull << 63) | ((unsigned long long)r << 32) | __float_as_uint(v);
  const unsigned long long old = atomicCAS(cell, 0ull, mine);
  if (old == 0ull) return;  // the first: the other pair adds the row
  const float o = __uint_as_float((unsigned)old);
  float acc = y0;
  acc += r == 0 ? v : o;
  acc += r == 0 ? o : v;
  y[at] = acc;
  *cell = 0ull;
}

// Counts one written slot of listed row u in, after the writes that this
// thread made or saw (a __syncthreads) since its last fence; true for the
// last slot of the row, which may then read all of them (add_row).
__device__ __forceinline__ bool arrive_last(const Rows& f, int u) {
  __threadfence();
  const unsigned last = (unsigned)__ldg(f.count + u) - 1u;
  if (atomicInc(f.arrive + u, last) != last) return false;
  __threadfence();
  return true;
}

// Column b of listed row u: y[row, b] += its slots, in perm order.
__device__ __forceinline__ void add_row(float* y, const Rows& f, int u,
                                        int B, int b) {
  const long long lo = __ldg(f.offsets + u);
  const long long hi = __ldg(f.offsets + u + 1);
  float* at = y + (long long)__ldg(f.rows + u) * B + b;
  float acc = __ldcg(at);
  long long j = lo;
  // four slots' loads in flight at a time; the adds keep their order
  for (; j + 4 <= hi; j += 4) {
    float s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[k] = __ldcg(f.side + (long long)__ldg(f.perm + j + k) * B + b);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc += s[k];
  }
  for (; j < hi; ++j) {
    acc += __ldcg(f.side + (long long)__ldg(f.perm + j) * B + b);
  }
  *at = acc;
}

// The partial v of a pair whose code is d and whose row of y is row, from
// the one thread that holds the pair (K6, one column).
__device__ __forceinline__ void put(float* y, const Rows& f, int d,
                                    long long row, float v) {
  if (d >= 0) {
    atomicAdd(y + d, v);
  } else if (exchanged(d, 1)) {
    exchange(y, f, d, row, 0, v);
  } else if (d != -1) {
    const long long k = slot_of(f, d);
    f.side[k] = v;
    const int u = __ldg(f.slot_row + k);
    if (arrive_last(f, u)) add_row(y, f, u, 1, 0);
  }
}

}  // namespace flush
