// Shared helpers of the SpMV kernels: storage-type upcasts, the type
// dispatch of the C entry points, and the error string export.
//
// Every kernel reads vals as float or bf16, cols as int32 or int16 and x
// as float or bf16, upcasts in registers and accumulates in float32. A
// column index outside [0, n_cols) contributes 0 instead of reading out of
// bounds: a fault would poison the CUDA context of the whole process.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int to_i32(int32_t v) { return v; }
__device__ __forceinline__ int to_i32(int16_t v) { return (int)v; }

// vals[i] * x[cols[i]], 0 for an out-of-range column
template <typename V, typename C, typename X>
__device__ __forceinline__ float nz_product(const V* __restrict__ vals,
                                            const C* __restrict__ cols,
                                            const X* __restrict__ x,
                                            int n_cols, long long i) {
  int col = to_i32(cols[i]);
  float xv = ((unsigned)col < (unsigned)n_cols) ? to_f32(x[col]) : 0.f;
  return to_f32(vals[i]) * xv;
}

// Runs the statement(s) in __VA_ARGS__ with the type aliases V (vals),
// C (cols) and X (x) bound from the runtime flags.
#define SPMV_DISPATCH_X(x_bf16, ...)                 \
  if (x_bf16) {                                      \
    using X = __nv_bfloat16;                         \
    __VA_ARGS__;                                     \
  } else {                                           \
    using X = float;                                 \
    __VA_ARGS__;                                     \
  }
#define SPMV_DISPATCH_C(cols_i16, x_bf16, ...)       \
  if (cols_i16) {                                    \
    using C = int16_t;                               \
    SPMV_DISPATCH_X(x_bf16, __VA_ARGS__)             \
  } else {                                           \
    using C = int32_t;                               \
    SPMV_DISPATCH_X(x_bf16, __VA_ARGS__)             \
  }
#define SPMV_DISPATCH(vals_bf16, cols_i16, x_bf16, ...)    \
  do {                                                     \
    if (vals_bf16) {                                       \
      using V = __nv_bfloat16;                             \
      SPMV_DISPATCH_C(cols_i16, x_bf16, __VA_ARGS__)       \
    } else {                                               \
      using V = float;                                     \
      SPMV_DISPATCH_C(cols_i16, x_bf16, __VA_ARGS__)       \
    }                                                      \
  } while (0)

// Lets `kernel` launch with `smem` bytes of dynamic shared memory. Without
// the opt-in a launch gets 48 KB of shared memory for static and dynamic
// together, so the opt-in is needed once the two pass 48 KB, which happens
// with less than 48 KB of dynamic memory (a launch of exactly 48 KB next
// to a kernel's own __shared__ arrays fails with "invalid argument").
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t smem) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (smem + attr.sharedSizeBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

extern "C" const char* spmv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
