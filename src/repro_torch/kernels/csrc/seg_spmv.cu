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
//  * seg_scan (K3, K6 mode 0): with S(e) the sum of the tile's first e
//    products, g[m] = S(clamp(end[m], 0, C)) and partial[m] = g[m] -
//    g[m-1] (g[-1] = 0), for any ends: descending, repeated, negative,
//    past C.
//    What sets the pace on the card is the x gathers, not the format's
//    bytes. On chip_smoke.py's power-law operand (7.85 M slots, columns
//    uniform over 2^20, a 4 MB x; an H100 80GB HBM3 at 700 W) the kernel
//    takes about 0.078 ms against a byte bound of 0.024 ms; K1's
//    structure on the same vals, cols and x takes 0.072 ms, and this
//    kernel on ascending columns 0.031 ms (76 % of the bound). So about
//    0.047 ms goes to random 32-byte L2 sectors fetched for 4-byte x
//    values, which no arrangement of the format removes; the design
//    trims what is left, the tile structure.
//    scan_tiles_kernel: a block takes the ceil(2048 / C) tiles of one
//    2048-slot pass, or one tile of ceil(C / 2048) passes. In a pass
//    each thread owns 8 consecutive slots (the blocked arrangement of
//    runs.cuh): it loads their vals and cols (16-byte evict-first loads
//    when C % 8 == 0 and both arrays are 16-byte aligned, checked on the
//    host; scalar loads otherwise), issues the 8 x gathers, then scans the
//    8 products in registers. A segmented __shfl_up_sync scan over the
//    warp's thread totals and a walk over the 8 warp totals (double
//    buffered in shared memory, so one __syncthreads a pass) give each
//    thread the sum before its slots; the scan restarts at each tile's
//    first slot, and a running carry spans passes. The inclusive sums go
//    to shared memory (the block's tiles, at most max(C, 4095) floats: it
//    does not grow with M), so g[m] is read at any end, as the Pallas rule
//    has it. The block then takes its tiles' (tile, segment) pairs in
//    turn, reading seg_end from device memory. Overlapping the next
//    tile's loads with this tile's scan (a persistent grid that loads
//    ahead into registers, or cp.async.bulk copies into a two-stage
//    shared ring) was not faster on the card, so neither is done; nor is
//    the run reduction of K10a at one column, which was slower.
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
//    it into a shared float[M] with one atomicAdd; the runs at a warp's
//    two ends go through its boundary slots, folded in warp order after
//    each pass (runs.cuh), so a row's sum is taken in one order on every
//    call. A local row outside [0, M) gets the key kNone and adds
//    nothing. The packer emits local rows sorted within a tile, so the
//    atomics per tile fall from C to about (distinct rows + warps per
//    pass); the sums are right for any local_row (unsorted, repeated, out
//    of range), only fast and bit-stable for sorted ones. seg_end is not
//    read, as the TPU kernel does not read it.
//  * fused (K6): the TPU adds tile t's partials at y[r0[t] + m] on a
//    resident output block, in sequential grid order; a row that
//    straddles tiles t and t+1 gets its second add on top of the first.
//    Blocks on the GPU run in parallel and in any order. The wrapper's
//    FusedRows (combine.fused_rows, built once per plan) gives each (tile,
//    segment) its row where no other tile adds into that row, and the
//    flush adds it there (one writer, so in no varying order). A row that
//    several tiles share is added inside this launch, in (tile, segment)
//    order, by the last of its partials to arrive (flush.cuh): a row of
//    two through a 64-bit exchange cell, a longer one through side slots
//    and an arrival counter. That order is the ordered combine's
//    (rowmap_combine.cu), so the bits are those of the unfused partials
//    combined by it, with no second launch; what it costs is a shared
//    pair's wait for its exchange, about one round trip to L2 at the end
//    of a block (chip_smoke.py --fused-split; PERF.md). The
//    cells and counters belong to the plan, so one plan's fused step runs
//    on one stream at a time. Empty segments and rows outside [0, n_rows)
//    map to nothing: the TPU clamps an out-of-range slice write, the GPU
//    would corrupt memory. One-hot takes a tile a block (walking several
//    tiles a block in turn was slower on the card: their run reductions'
//    barriers and folds in series), seg_scan sets its grid from C alone;
//    neither changes a sum.
// runs.cuh holds the 8-slot loads and the run helpers, which the seg SpMM
// kernels K10a/K10b/K11 run for B columns.
// The sums are taken in another order than the plain version's, so they
// agree with it to a tolerance; from call to call they are bit-identical
// (for the packers' sorted local rows in one-hot mode).
#include "flush.cuh"
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

__device__ __forceinline__ int clamp_end(int e, int Cn) {
  return e < 0 ? 0 : (e > Cn ? Cn : e);
}

// The products of this thread's kPer slots from slot i (of `left` still
// in the block, whose first slot is i0), 0 past the block or for a column
// outside [0, n_cols). The 8 x gathers are issued before any product.
template <bool kVec, typename V, typename C, typename X>
__device__ __forceinline__ void slot_products(
    const V* __restrict__ vals, const C* __restrict__ cols,
    const X* __restrict__ x, int n_cols, long long i0, long long i,
    int left, float (&p)[kPer]) {
  int col[kPer];
  float v[kPer];
  // with kVec, Cn % kPer == 0: the kPer slots are all in or all out. A
  // thread past the block (in its last pass only) loads the block's first
  // slots and drops them, so no branch guards the loads
  if constexpr (kVec) {
    const long long j = left > 0 ? i : i0;
    load_run(cols + j, col);
    load_run(vals + j, v);
    if (left <= 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) col[k] = -1, v[k] = 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool in = k < left;
      col[k] = in ? to_i32(cols[i + k]) : -1;
      v[k] = in ? to_f32(vals[i + k]) : 0.f;
    }
  }
  float xv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    xv[k] = (unsigned)col[k] < (unsigned)n_cols ? to_f32(x[col[k]]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) p[k] = v[k] * xv[k];
}

// K3 / K6 in seg_scan mode: tiles [t0, t0 + K) per block; cs holds their
// in-tile inclusive sums. kFused = false: out[t, m]; kFused = true: y
// (out) or a side slot as f.dst[t * M + m] says (flush::put), for m below
// f.n_used[t].
template <bool kVec, bool kFused, typename V, typename C, typename X>
__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                  const int* __restrict__ seg_end, const X* __restrict__ x,
                  int n_cols, long long T, int Cn, int M, int K,
                  float* __restrict__ out, const flush::Rows f) {
  extern __shared__ float4 cs4[];  // K * Cn floats
  float* cs = reinterpret_cast<float*>(cs4);
  __shared__ float wsum[2][kWarps];  // per pass parity: warp totals ...
  __shared__ int whead[2][kWarps];   // ... and whether a tile starts in it
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * K;
  const int nt = (int)min((long long)K, T - t0);
  const int n = nt * Cn;
  const long long base = t0 * Cn;
  if constexpr (!kFused) {
    // K3's flush reads its nt * M ends after the scan: ask L2 for them
    // now (faster on the card for K3; slower for K6, which adds into y)
    for (int i = tid * 8; i < nt * M; i += kThreads * 8) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(seg_end + t0 * M + i));
    }
  }
  float carry = 0.f;  // the open tile's sum before this pass
  for (int s0 = 0, buf = 0; s0 < n; s0 += kPass, buf ^= 1) {
    const int s = s0 + tid * kPer;
    float p[kPer];
    slot_products<kVec>(vals, cols, x, n_cols, base, base + s, n - s, p);
    // tiles start at slots h, h + Cn, ... of this thread's kPer; the scan
    // restarts there, and slots before h continue the open tile
    const int c0 = s % Cn;
    const int h = c0 == 0 ? 0 : Cn - c0;
    float run = 0.f;
    int next = h;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k == next) {
        run = 0.f;
        next += Cn;
      }
      run += p[k];
      p[k] = run;
    }
    // segmented inclusive scan of the thread totals over the warp: a lane
    // stops adding the lanes below once a tile starts at or below it
    float v = run;
    int f = h < kPer;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, o);
      const int up_f = __shfl_up_sync(0xffffffffu, f, o);
      if (lane >= o) {
        if (!f) v += up;
        f |= up_f;
      }
    }
    const float below = __shfl_up_sync(0xffffffffu, v, 1);
    const int below_f = __shfl_up_sync(0xffffffffu, f, 1);
    if (lane == 31) wsum[buf][warp] = v, whead[buf][warp] = f;
    __syncthreads();
    // the open tile's sum before this thread: the lanes below, then the
    // warps below, then the passes before, up to the tile's start
    float before = lane > 0 ? below : 0.f;
    bool closed = lane > 0 && below_f;
    for (int w = warp - 1; w >= 0 && !closed; --w) {
      before += wsum[buf][w];
      closed = whead[buf][w];
    }
    if (!closed) before += carry;
    float pass = 0.f;  // ... and the carry into the next pass
    closed = false;
    for (int w = kWarps - 1; w >= 0 && !closed; --w) {
      pass += wsum[buf][w];
      closed = whead[buf][w];
    }
    carry = closed ? pass : carry + pass;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k < h) p[k] += before;
    }
    if (s + kPer <= n) {
      cs4[s / 4] = make_float4(p[0], p[1], p[2], p[3]);
      cs4[s / 4 + 1] = make_float4(p[4], p[5], p[6], p[7]);
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (s + k < n) cs[s + k] = p[k];
      }
    }
    // wsum[buf] is next written two passes on, after the next barrier
  }
  __syncthreads();
  // partial[m] = g[m] - g[m-1], g[m] = cs[clamp(end[m]) - 1] or 0
  const int* end = seg_end + t0 * M;
  for (int i = tid; i < nt * M; i += kThreads) {
    const int tr = i / M, m = i - tr * M;
    // past n_used, empty segments
    if (kFused && m >= __ldg(f.n_used + t0 + tr)) continue;
    const float* tcs = cs + tr * Cn;
    const int e = clamp_end(end[i], Cn);
    const int ep = m > 0 ? clamp_end(end[i - 1], Cn) : 0;
    const float g = e > 0 ? tcs[e - 1] : 0.f;
    const float gp = ep > 0 ? tcs[ep - 1] : 0.f;
    const float part = g - gp;
    if constexpr (kFused) {
      const long long row = (long long)__ldg(f.r0 + t0 + tr) + m;
      flush::put(out, f, __ldg(f.dst + t0 * M + i), row, part);
    } else {
      out[t0 * M + i] = part;
    }
  }
}

// One pass of the one-hot reduction: this thread's kPer slots start at
// slot s0 of the tile at base; each run's sum is added into buf[row] by
// the thread that ends it. A slot at or past Cn, or whose local row is
// outside [0, M), gets the key kNone and adds nothing.
template <bool kVec, typename V, typename C, typename X>
__device__ __forceinline__ void onehot_pass(
    const V* __restrict__ vals, const C* __restrict__ cols,
    const int* __restrict__ local, const X* __restrict__ x, int n_cols,
    long long base, int s0, int Cn, int M, float* buf, int* bkey,
    float* bval) {
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
  runs::add_runs<1, 1>(r, key, p, buf, 1, 0, bkey, bval);
}

// K4 / K6 in one-hot mode: the partials of tile t = blockIdx.x, out[t, m]
// (kFused = false) or y / a cell / a side slot as f.dst[t * M + m] says
// for m below f.n_used[t] (kFused = true).
template <typename V, typename C, typename X, int kMode, bool kFused>
__global__ void __launch_bounds__(kThreads)
onehot_tiles_kernel(const V* __restrict__ vals, const C* __restrict__ cols,
                    const int* __restrict__ local, const X* __restrict__ x,
                    int n_cols, int Cn, int M, float* __restrict__ out,
                    const flush::Rows f) {
  extern __shared__ float buf[];  // M floats
  __shared__ int bkey[runs::kRing * runs::kSlots];  // boundary slots
  __shared__ float bval[runs::kRing * runs::kSlots];
  const long long t = blockIdx.x;
  const long long base = t * Cn;
  for (int m = threadIdx.x; m < M; m += kThreads) buf[m] = 0.f;
  __syncthreads();
  int ring = 0;  // passes in the ring
  for (int start = 0; start < Cn; start += kPass) {
    onehot_pass<kMode == kOnehotVec>(
        vals, cols, local, x, n_cols, base, start + threadIdx.x * kPer, Cn,
        M, buf, bkey + ring * runs::kSlots, bval + ring * runs::kSlots);
    if (++ring == runs::kRing && start + kPass < Cn) {
      __syncthreads();
      runs::fold_boundary(bkey, bval, 1, 1, ring * runs::kSlots, buf);
      __syncthreads();
      ring = 0;
    }
  }
  __syncthreads();
  runs::fold_boundary(bkey, bval, 1, 1, ring * runs::kSlots, buf);
  __syncthreads();
  // past n_used, empty segments
  const int lim = kFused ? __ldg(f.n_used + t) : M;
  const long long row0 = kFused ? __ldg(f.r0 + t) : 0;
  for (int m = threadIdx.x; m < lim; m += kThreads) {
    const float v = buf[m];
    if constexpr (kFused) {
      flush::put(out, f, __ldg(f.dst + t * M + m), row0 + m, v);
    } else {
      out[t * M + m] = v;
    }
  }
}

// Launches `kernel` with `smem` bytes of dynamic shared memory (opting in
// where it and the kernel's static shared memory pass 48 KB).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, unsigned blocks, size_t smem, cudaStream_t s,
           Args... args) {
  const cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// mode: 0 seg_scan, 1 onehot_mxu. fused = 0: out is (T, M) partials and
// the FusedRows pointers (dst .. cells) are unused; fused = 1: out is y
// (n_rows,), dst (T * M) gives each partial its row of y, its exchange
// cell or its side slot, and the kernel adds the shared rows into y
// (flush.cuh); r0 (T) is each tile's first row. One-hot takes a tile a
// block (several tiles a block in turn were slower on the card),
// seg_scan the ceil(2048 / Cn) tiles of one pass; neither changes a sum.
extern "C" int seg_tiles(const void* vals, int vals_bf16, const void* cols,
                         int cols_i16, const void* x, int x_bf16, int n_cols,
                         const int* aux, long long T, int Cn, int M, int mode,
                         int fused, float* out, const int* dst,
                         const int* n_used, float* side, const int* slot_row,
                         const int* count, unsigned* arrive, const int* perm,
                         const long long* offsets, const int* rows,
                         const int* r0, unsigned long long* cells,
                         void* stream) {
  if (T <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const flush::Rows f{dst,   n_used, r0,      side, slot_row, count,
                      arrive, perm,  offsets, rows, cells};
  const bool vec = Cn % kPer == 0 && aligned16(vals) && aligned16(cols);
  if (mode == kSegScan) {
    const int per_pass = Cn > 0 ? (kPass + Cn - 1) / Cn : 1;
    const int K = (int)(per_pass < T ? per_pass : T);
    const unsigned blocks = (unsigned)((T + K - 1) / K);
    const size_t smem = (size_t)K * Cn * sizeof(float);
#define SCAN_LAUNCH(VEC, FUSED)                                            \
  return launch(scan_tiles_kernel<VEC, FUSED, V, C, X>, blocks, smem, s,   \
                (const V*)vals, (const C*)cols, aux, (const X*)x, n_cols, \
                T, Cn, M, K, out, f)
    SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16, {
      if (vec) {
        if (fused) SCAN_LAUNCH(true, true);
        SCAN_LAUNCH(true, false);
      }
      if (fused) SCAN_LAUNCH(false, true);
      SCAN_LAUNCH(false, false);
    });
#undef SCAN_LAUNCH
  }
  const size_t smem = (size_t)M * sizeof(float);
#define ONEHOT_LAUNCH(MODE, FUSED)                                           \
  return launch(onehot_tiles_kernel<V, C, X, MODE, FUSED>, (unsigned)T, smem, \
                s, (const V*)vals, (const C*)cols, aux, (const X*)x, n_cols, \
                Cn, M, out, f)
  SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16, {
    if (vec && aligned16(aux)) {
      if (fused) ONEHOT_LAUNCH(kOnehotVec, true);
      ONEHOT_LAUNCH(kOnehotVec, false);
    }
    if (fused) ONEHOT_LAUNCH(kOnehot, true);
    ONEHOT_LAUNCH(kOnehot, false);
  });
#undef ONEHOT_LAUNCH
  return 0;  // not reached
}
