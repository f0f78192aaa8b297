// Shared pieces of the general attention kernels (flash_general.cu,
// paged_general.cu): element types, their accumulation types, warp
// reductions, the padded row stride of a staged tile, and the dispatch
// over (dtype, head-dim bucket).
//
// A general kernel takes float16, bfloat16, float32 or float64 and any
// head_dim from 1 to 256.  It accumulates in float32 (float64 for
// float64 inputs).  Each warp owns one row; lane l holds elements
// l, l + 32, ... of that row's accumulator, NE = ceil(D / 32) of them,
// rounded up to a power of two for the template (1, 2, 4 or 8).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mxg {

constexpr int WARPS = 8;            // rows per CTA, one warp each
constexpr int NT = WARPS * 32;
constexpr int TILE = 32;            // staged rows per step: one per lane
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_D = 256;

// dtype codes of the C interface
enum { F16 = 0, BF16 = 1, F32 = 2, F64 = 3 };

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ double to_acc(double x) { return x; }

template <typename T> __device__ __forceinline__ T from_acc(float x);
template <> __device__ __forceinline__ __half from_acc<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float from_acc<float>(float x) {
  return x;
}
template <typename T> __device__ __forceinline__ T from_acc(double x) {
  return x;
}

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) {
  return fmax(a, b);
}

template <typename A> __device__ __forceinline__ A warp_max(A v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max_(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <typename A> __device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Elements per staged row of D values of T.  Lane l reads row l (the
// key or query it scores), so the stride in 4-byte words is made odd:
// the 32 lanes then fall in 32 banks (2 per lane for 8-byte values,
// which take two wavefronts whatever the stride).
template <typename T> __host__ __device__ inline int row_stride(int D) {
  if (sizeof(T) == 8) return (D % 2) ? D : D + 1;
  int words = (D * (int)sizeof(T) + 3) / 4;
  if (words % 2 == 0) ++words;
  return words * 4 / (int)sizeof(T);
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// ceil(D / 32) rounded up to 1, 2, 4 or 8
inline int ne_bucket(int D) {
  int ne = (D + 31) / 32;
  return ne <= 1 ? 1 : ne <= 2 ? 2 : ne <= 4 ? 4 : 8;
}

// Allow `bytes` of dynamic shared memory for `kernel` when above the
// default 48 KB.
template <typename K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace mxg

// Call LAUNCH<T, NE>(...) for the dtype code and head-dim bucket; yields
// cudaErrorInvalidValue for anything else.
#define MXG_DISPATCH(dtype, D, LAUNCH, ...)                                  \
  ([&]() -> int {                                                            \
    if ((D) < 1 || (D) > mxg::MAX_D) return (int)cudaErrorInvalidValue;      \
    const int ne_ = mxg::ne_bucket(D);                                       \
    switch ((dtype) * 16 + ne_) {                                            \
      case mxg::F16 * 16 + 1: return LAUNCH<__half, 1>(__VA_ARGS__);         \
      case mxg::F16 * 16 + 2: return LAUNCH<__half, 2>(__VA_ARGS__);         \
      case mxg::F16 * 16 + 4: return LAUNCH<__half, 4>(__VA_ARGS__);         \
      case mxg::F16 * 16 + 8: return LAUNCH<__half, 8>(__VA_ARGS__);         \
      case mxg::BF16 * 16 + 1: return LAUNCH<__nv_bfloat16, 1>(__VA_ARGS__); \
      case mxg::BF16 * 16 + 2: return LAUNCH<__nv_bfloat16, 2>(__VA_ARGS__); \
      case mxg::BF16 * 16 + 4: return LAUNCH<__nv_bfloat16, 4>(__VA_ARGS__); \
      case mxg::BF16 * 16 + 8: return LAUNCH<__nv_bfloat16, 8>(__VA_ARGS__); \
      case mxg::F32 * 16 + 1: return LAUNCH<float, 1>(__VA_ARGS__);          \
      case mxg::F32 * 16 + 2: return LAUNCH<float, 2>(__VA_ARGS__);          \
      case mxg::F32 * 16 + 4: return LAUNCH<float, 4>(__VA_ARGS__);          \
      case mxg::F32 * 16 + 8: return LAUNCH<float, 8>(__VA_ARGS__);          \
      case mxg::F64 * 16 + 1: return LAUNCH<double, 1>(__VA_ARGS__);         \
      case mxg::F64 * 16 + 2: return LAUNCH<double, 2>(__VA_ARGS__);         \
      case mxg::F64 * 16 + 4: return LAUNCH<double, 4>(__VA_ARGS__);         \
      case mxg::F64 * 16 + 8: return LAUNCH<double, 8>(__VA_ARGS__);         \
      default: return (int)cudaErrorInvalidValue;                            \
    }                                                                        \
  }())
