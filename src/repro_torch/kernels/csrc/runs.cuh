// The blocked run reduction of the one-hot SpMV kernel K4/K6 (seg_spmv.cu,
// one column, G = 1) and of the seg SpMM kernels K10a/K10b/K11
// (seg_spmm.cu, B columns).
//
// A block walks its slots in passes of kPass = 2048; in a pass each thread
// owns kPer = 8 consecutive slots (the blocked arrangement) and gives each
// a key: the accumulator slot it adds into, or kNone where it adds nothing.
// It loads the slots' indices first (16-byte vector loads with load_run
// where the tile width is a multiple of 8 and the arrays are 16-byte
// aligned, checked on the host), then gathers x, all independent.
//
// Runs of equal key are summed in registers. The run that ends a thread's
// slots is carried over the warp by a segmented __shfl_up_sync scan that
// restarts where a lane's first key differs from its neighbour's last, or
// where the lane's 8 slots are not one run. Only the thread that ends a
// run (where the next key differs, or at the warp's last slot) adds it
// into shared memory, with one atomicAdd per column. The packers emit keys
// sorted within a tile, so the atomics per 2048-slot pass fall from 2048
// to about (distinct keys + warps per pass) per column. The sums are right
// for keys in any order (unsorted, repeated): a run is a run of equal
// keys, whatever comes before or after it.
//
// A fixed order for the runs a key has in several warps or passes. With
// keys sorted, a key's slots are contiguous, so a run that touches
// neither end of its warp's 256 slots is its key's only run: its one
// atomicAdd lands on a zero and its order does not matter. The runs that
// hold a warp's first slot (head) or its last (tail) are the only ones a
// key can have more than one of. Their ends write them to the warp's two
// boundary slots of the pass instead, in a ring of kRing passes; after a
// __syncthreads, when the ring is full and at the end of the block's
// slots, fold_boundary adds the ring's slots (pass, warp, head before
// tail) into the accumulator: a warp a column, 32 slots at a time, the
// slots of one key summed by a segmented warp scan, one atomicAdd a key
// and chunk, chunk after chunk. So a key's sum is taken in the same order
// on every call: the results are bit-stable for sorted keys, and right
// (but not bit-stable) for keys in any order.
//
// The run structure (which slots end a run, which scan steps add) depends
// on the keys alone, so run_structure computes it once per pass and
// add_runs reuses it for every column of the pass.
#pragma once

#include "common.cuh"

namespace runs {

constexpr int kPer = 8;                 // slots per thread and pass
constexpr int kPass = 256 * kPer;       // slots per pass of 256 threads
constexpr int kNone = -1;               // the key of a slot that adds nothing

// kPer consecutive elements at p (16-byte aligned), upcast: vals to float,
// cols and local rows to int. Read once, so loaded evict-first.
__device__ __forceinline__ void load_run(const float* p, float (&o)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; k += 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p + k));
    o[k] = q.x, o[k + 1] = q.y, o[k + 2] = q.z, o[k + 3] = q.w;
  }
}
__device__ __forceinline__ void load_run(const int32_t* p, int (&o)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; k += 4) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p + k));
    o[k] = q.x, o[k + 1] = q.y, o[k + 2] = q.z, o[k + 3] = q.w;
  }
}
// eight 2-byte elements in one 16-byte load; element 2i is the low half of
// word i. A bf16 is the top half of its float.
__device__ __forceinline__ void load_run(const __nv_bfloat16* p,
                                         float (&o)[kPer]) {
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_run(const int16_t* p, int (&o)[kPer]) {
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = (int)(int16_t)(w[i] & 0xffffu);
    o[2 * i + 1] = (int)w[i] >> 16;  // arithmetic shift keeps the sign
  }
}

// The runs of this thread's kPer keys, over the warp. The warp's lanes
// form 32 / G groups of G consecutive lanes; the lanes of a group hold the
// same kPer slots (each its own columns), so the runs and the scan go over
// groups. Every lane of the warp must call it.
struct Runs {
  unsigned same;   // bit k (k >= 1): key[k] == key[k - 1]
  unsigned ends;   // bit k: slot k ends a run
  unsigned steps;  // bit i: scan step i (offset G << i) adds the group below
  bool joins;      // slot 0 continues the run of the group below
  bool head;       // slot 0's run starts at the warp's first slot
};

// A warp's boundary slots of one pass: 2 per warp (head, tail), keys and
// the sums of `stride` columns each; a ring holds kRing passes of them.
constexpr int kSlots = 2 * 8;  // 2 per warp of a 256-thread block
constexpr int kRing = 4;

template <int G>
__device__ __forceinline__ Runs run_structure(const int (&key)[kPer]) {
  const int lane = threadIdx.x & 31;
  Runs r{0u, 0u, 0u, false, false};
  bool whole = true;  // the group's 8 slots are one run
#pragma unroll
  for (int k = 1; k < kPer; ++k) {
    if (key[k] == key[k - 1]) {
      r.same |= 1u << k;
    } else {
      whole = false;
      r.ends |= 1u << (k - 1);
    }
  }
  const int prev_last = __shfl_up_sync(0xffffffffu, key[kPer - 1], G);
  const int next_first = __shfl_down_sync(0xffffffffu, key[0], G);
  r.joins = lane >= G && key[0] == prev_last;
  if (lane >= 32 - G || next_first != key[kPer - 1]) {
    r.ends |= 1u << (kPer - 1);
  }
  // the head run reaches group g when every group in [1, g] continues a
  // group below whose slots are one run
  const bool prev_whole = __shfl_up_sync(0xffffffffu, (int)whole, G);
  const unsigned link =
      __ballot_sync(0xffffffffu, lane >= G && r.joins && prev_whole);
  const unsigned need =
      lane >= G ? ((2u << lane) - 1u) & ~((1u << G) - 1u) : 0u;
  r.head = (link & need) == need;
  // segmented inclusive scan of the flags: a group adds the group o below
  // while its run reaches back over every group in between
  bool open = whole && r.joins;
#pragma unroll
  for (int i = 0; (G << i) < 32; ++i) {
    const int o = G << i;
    const bool up_open = __shfl_up_sync(0xffffffffu, (int)open, o);
    if (lane >= o) {
      if (open) r.steps |= 1u << i;
      open = open && up_open;
    }
  }
  return r;
}

// Adds this pass's runs of CW columns: p[k][j] is slot k's product for
// column j, and a run of key q ends in acc[q * stride + j0 + j]; the
// warp's head and tail runs go to its boundary slots instead (bkey[2w +
// s], bval[(2w + s) * stride + j0 + j], s = 0 head, 1 tail) for
// fold_boundary. Every lane of the warp must call it, with the G of
// run_structure.
template <int CW, int G>
__device__ __forceinline__ void add_runs(const Runs& r,
                                         const int (&key)[kPer],
                                         const float (&p)[kPer][CW],
                                         float* acc, int stride, int j0,
                                         int* bkey, float* bval) {
  // the run that ends this group's slots, per column
  float run[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) run[j] = p[0][j];
#pragma unroll
  for (int k = 1; k < kPer; ++k) {
    const bool same = r.same >> k & 1u;
#pragma unroll
    for (int j = 0; j < CW; ++j) run[j] = same ? run[j] + p[k][j] : p[k][j];
  }
  // ... summed over the groups it spans
#pragma unroll
  for (int i = 0; (G << i) < 32; ++i) {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const float up = __shfl_up_sync(0xffffffffu, run[j], G << i);
      if (r.steps >> i & 1u) run[j] += up;
    }
  }
  float sum[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const float before = __shfl_up_sync(0xffffffffu, run[j], G);
    sum[j] = r.joins ? before : 0.f;
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
#pragma unroll
    for (int j = 0; j < CW; ++j) sum[j] += p[k][j];
    if (r.ends >> k & 1u) {
      const bool head = r.head && (r.ends & ((1u << k) - 1u)) == 0u;
      const bool tail = k == kPer - 1 && lane >= 32 - G;
      if (head || tail) {
        const int s = 2 * w + (head ? 0 : 1);
        bkey[s] = key[k];
        if (head && tail) bkey[s + 1] = kNone;  // one run: the head slot
#pragma unroll
        for (int j = 0; j < CW; ++j) bval[s * stride + j0 + j] = sum[j];
      } else if (key[k] != kNone) {
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          atomicAdd(&acc[key[k] * stride + j0 + j], sum[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < CW; ++j) sum[j] = 0.f;
    }
  }
}

// After a __syncthreads: adds the ring's first n boundary slots (pass,
// warp, head before tail) into acc. Warp w takes columns w, w + 8, ... of
// [0, ncols); in each chunk of 32 slots a segmented scan sums the slots of
// one key, and the chunk's last slot of the key adds the sum with one
// atomicAdd, chunk after chunk, in the warp's program order.
__device__ __forceinline__ void fold_boundary(const int* bkey,
                                              const float* bval, int stride,
                                              int ncols, int n, float* acc) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < ncols; j += blockDim.x >> 5) {
    for (int e0 = 0; e0 < n; e0 += 32) {
      const int e = e0 + lane;
      const int key = e < n ? bkey[e] : kNone;
      float v = key != kNone ? bval[e * stride + j] : 0.f;
      const int prev = __shfl_up_sync(0xffffffffu, key, 1);
      const int next = __shfl_down_sync(0xffffffffu, key, 1);
      // the first lane of this lane's run of equal keys
      int first = lane == 0 || prev != key ? lane : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        first = max(first, __shfl_up_sync(0xffffffffu, first, o));
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, v, o);
        if (lane - o >= first) v += up;
      }
      if (key != kNone && (lane == 31 || next != key)) {
        atomicAdd(&acc[key * stride + j], v);
      }
    }
  }
}

}  // namespace runs
