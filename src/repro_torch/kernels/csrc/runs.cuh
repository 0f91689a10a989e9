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
};

template <int G>
__device__ __forceinline__ Runs run_structure(const int (&key)[kPer]) {
  const int lane = threadIdx.x & 31;
  Runs r{0u, 0u, 0u, false};
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
// column j, and a run of key q ends in acc[q * stride + j0 + j]. Every
// lane of the warp must call it, with the G of run_structure.
template <int CW, int G>
__device__ __forceinline__ void add_runs(const Runs& r,
                                         const int (&key)[kPer],
                                         const float (&p)[kPer][CW],
                                         float* acc, int stride, int j0) {
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
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
#pragma unroll
    for (int j = 0; j < CW; ++j) sum[j] += p[k][j];
    if (r.ends >> k & 1u) {
      if (key[k] != kNone) {
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

}  // namespace runs
