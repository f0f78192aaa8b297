// Tensor-core pieces shared by the mma.sync attention kernels
// (flash_fwd_mma.cu, flash_bwd_mma.cu): the TF32 split of a float32
// value and of a tile in shared memory, the m16n8k8 TF32 mma, fragment
// loads from padded shared-memory rows, 16-byte cp.async copies with
// commit / wait groups, and the input check and (dtype, head dim)
// dispatch of their C interface.
//
// 3xTF32.  A TF32 operand keeps 10 explicit mantissa bits, about three
// decimal digits.  A float32 x splits into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna both times), and a product a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the small terms first, three mma;
// a_lo.b_lo (2^-22 of the product) is dropped.  float16 and bfloat16
// values are exact in TF32 (lo = 0), so a product of two of them is one
// mma, and of one of them with a split float32 value two.
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, with
// g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"):
//   A (16 x 8, row):  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)
//                     a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g)   b1 (k = t + 4, n = g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)
//                     c3 (g + 8, 2t + 1)
// A product whose A operand is an accumulator (P or dS) maps its k slots
// to keys as slot t -> 2t and slot t + 4 -> 2t + 1: then a0..a3 are
// c0, c2, c1, c3 of the same thread, and no value moves between lanes;
// the B operand reads its rows in the same order (load_b_pair below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "general.cuh"

namespace mxm {

constexpr int MAX_D = 128;      // head dims up to 128, padded to 16..128
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to 2^-22 of |x|: both TF32, rounded to nearest, ties away
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand element as float32: exact for every input type.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A fragment operand: hi and lo of N values of an input of type T.  For
// 16-bit T, hi is the value (exact) and lo is never read.
template <typename T, int N>
__device__ __forceinline__ void make(const float (&x)[N], uint32_t (&hi)[N],
                                     uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (sizeof(T) == 4) {
      split(x[i], hi[i], lo[i]);
    } else {
      hi[i] = __float_as_uint(x[i]);
      lo[i] = 0u;
    }
  }
}

// d = a b, the accumulator input a constant zero
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// acc += a b in 3xTF32 where both sides are split (one or two mmas where
// a side is exact: its lo is zero and skipped), the terms small first
// into an accumulator of their own that starts at zero, then added to
// acc by the CUDA cores, rounded to nearest.  The tensor cores' own
// accumulation is not rounded to nearest: on an H100 a float32 dk kept
// in one mma accumulator over 480 mma (tests/test_torch_cuda.py, 32 GQA
// heads x 40 queries) reached 1.3e-5 of max|plain|, over the limit of
// 1e-5.  S and dP are summed the same way.
template <bool SplitA, bool SplitB>
__device__ __forceinline__ void mma3_add(float (&acc)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  float t[4];
  if constexpr (SplitA) {
    mma0(t, al, bh);
    if constexpr (SplitB) mma(t, ah, bl);
    mma(t, ah, bh);
  } else if constexpr (SplitB) {
    mma0(t, ah, bl);
    mma(t, ah, bh);
  } else {
    mma0(t, ah, bh);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

// 2^x to 2^-22 (ex2.approx), 0 for -inf
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Elements of a tile of rows in shared memory, `ld` elements apart.
// A fragment of rows r0 .. r0 + 15 and columns c0 .. c0 + 7.
template <typename T>
__device__ __forceinline__ void load_a(const T* s, int ld, int r0, int c0,
                                       float (&x)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = s + (size_t)(r0 + g) * ld + c0 + t;
  x[0] = to_f(p[0]);
  x[1] = to_f(p[8 * ld]);
  x[2] = to_f(p[4]);
  x[3] = to_f(p[8 * ld + 4]);
}

// B fragment (k x n = 8 x 8) whose column n is row n0 + n of the tile
// and whose k runs along that row from c0: B = tile^T, as S = Q K^T
// reads K.
template <typename T>
__device__ __forceinline__ void load_bt(const T* s, int ld, int n0, int c0,
                                        float (&x)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = s + (size_t)(n0 + g) * ld + c0 + t;
  x[0] = to_f(p[0]);
  x[1] = to_f(p[4]);
}

// B fragment whose k runs down rows k0 .. k0 + 7 in the accumulator slot
// order (slot t -> row k0 + 2t, slot t + 4 -> row k0 + 2t + 1) and whose
// n is column c0 + n: B = tile, as dQ = dS K reads K.
template <typename T>
__device__ __forceinline__ void load_b_pair(const T* s, int ld, int k0,
                                            int c0, float (&x)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = s + (size_t)(k0 + 2 * t) * ld + c0 + g;
  x[0] = to_f(p[0]);
  x[1] = to_f(p[ld]);
}

// A B fragment of a streamed tile as load_bt / load_b_pair read it, in
// TF32 parts.  For float32 the tile holds its hi parts in place of the
// values and `lo` its lo parts (split_tile: once per CTA, not once per
// warp and use); 16-bit values are read as they are.
template <typename T>
__device__ __forceinline__ void frag_bt(const T* s, const float* lo, int ld,
                                        int n0, int c0, uint32_t (&h)[2],
                                        uint32_t (&l)[2]) {
  if constexpr (sizeof(T) == 4) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const size_t at = (size_t)(n0 + g) * ld + c0 + t;
    h[0] = __float_as_uint(s[at]);
    h[1] = __float_as_uint(s[at + 4]);
    l[0] = __float_as_uint(lo[at]);
    l[1] = __float_as_uint(lo[at + 4]);
  } else {
    float y[2];
    load_bt(s, ld, n0, c0, y);
    make<T>(y, h, l);
  }
}

template <typename T>
__device__ __forceinline__ void frag_b_pair(const T* s, const float* lo,
                                            int ld, int k0, int c0,
                                            uint32_t (&h)[2],
                                            uint32_t (&l)[2]) {
  if constexpr (sizeof(T) == 4) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const size_t at = (size_t)(k0 + 2 * t) * ld + c0 + g;
    h[0] = __float_as_uint(s[at]);
    h[1] = __float_as_uint(s[at + ld]);
    l[0] = __float_as_uint(lo[at]);
    l[1] = __float_as_uint(lo[at + ld]);
  } else {
    float y[2];
    load_b_pair(s, ld, k0, c0, y);
    make<T>(y, h, l);
  }
}

// Split `rows` rows of `cols` float32 values (`ld` apart, both multiples
// of 4) into TF32 parts: hi in place, lo into `lo`.  Nothing for 16-bit
// T.
template <typename T, int NT>
__device__ __forceinline__ void split_tile(T* s, float* lo, int ld,
                                           int rows, int cols) {
  if constexpr (sizeof(T) == 4) {
    const int n4 = cols / 4;
    for (int i = threadIdx.x; i < rows * n4; i += NT) {
      const int r = i / n4;
      const size_t at = (size_t)r * ld + (i - r * n4) * 4;
      const float4 x = *reinterpret_cast<const float4*>(s + at);
      uint4 h, l;
      split(x.x, h.x, l.x);
      split(x.y, h.y, l.y);
      split(x.z, h.z, l.z);
      split(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(s + at) = h;
      *reinterpret_cast<uint4*>(lo + at) = l;
    }
  }
}

// cp.async: 16 bytes from global to shared memory; with src_bytes 0 the
// 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, zero-filled with src_bytes 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [row0, row0 + n) of a (rows x D) array of T into a tile of
// `ld`-element rows with cp.async, 16 bytes a thread at a time (D *
// sizeof(T) a multiple of 16); rows at or past `nrows` are zero-filled.
template <typename T, int NT>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          int D, int row0, int n,
                                          int nrows) {
  constexpr int E = 16 / sizeof(T);   // elements per 16-byte chunk
  const int chunks = D / E;
  for (int i = threadIdx.x; i < n * chunks; i += NT) {
    const int r = i / chunks, c = (i - r * chunks) * E;
    const bool in = row0 + r < nrows;
    cp_async16(dst + (size_t)r * ld + c,
               src + (in ? (size_t)(row0 + r) * D + c : 0), in ? 16 : 0);
  }
}

// Zero columns D .. DP - 1 of `rows` rows `ld` elements apart: cp.async
// writes columns < D only, so a padded column stays zero and adds
// nothing to a product over the head dim.
template <typename T, int NT>
__device__ __forceinline__ void zero_cols(T* s, int rows, int ld, int D,
                                          int DP) {
  const int w = DP - D;
  if (w == 0) return;
  for (int i = threadIdx.x; i < rows * w; i += NT) {
    const int r = i / w;
    s[(size_t)r * ld + D + (i - r * w)] = mxg::from_acc<T>(0.f);
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The shapes, and rows of 16-byte multiples on 16-byte boundaries
// (`dout` may be null).
inline bool inputs_ok(int B, int H, int Hkv, int Tq, int Tk, int D,
                      int dtype, const void* q, const void* k,
                      const void* v, const void* dout) {
  const int size = dtype == mxg::F32 ? 4 : 2;
  return B >= 0 && H > 0 && Hkv > 0 && H % Hkv == 0 && Tq >= 0 &&
         Tk >= 0 && D >= 1 && D <= MAX_D && (D * size) % 16 == 0 &&
         aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
}

}  // namespace mxm

// Call LAUNCH<T, DP>(...) for the dtype code (float16, bfloat16 or
// float32) and the head dim's bucket, 16, 32, 64 or 128.
#define MXM_DISPATCH(dtype, D, LAUNCH, ...)                                  \
  ([&]() -> int {                                                            \
    const int dp_ = (D) <= 16 ? 16 : (D) <= 32 ? 32 : (D) <= 64 ? 64 : 128;  \
    switch ((dtype) * 256 + dp_) {                                           \
      case mxg::F16 * 256 + 16: return LAUNCH<__half, 16>(__VA_ARGS__);      \
      case mxg::F16 * 256 + 32: return LAUNCH<__half, 32>(__VA_ARGS__);      \
      case mxg::F16 * 256 + 64: return LAUNCH<__half, 64>(__VA_ARGS__);      \
      case mxg::F16 * 256 + 128: return LAUNCH<__half, 128>(__VA_ARGS__);    \
      case mxg::BF16 * 256 + 16: return LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__); \
      case mxg::BF16 * 256 + 32: return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__); \
      case mxg::BF16 * 256 + 64: return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__); \
      case mxg::BF16 * 256 + 128:                                            \
        return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);                      \
      case mxg::F32 * 256 + 16: return LAUNCH<float, 16>(__VA_ARGS__);       \
      case mxg::F32 * 256 + 32: return LAUNCH<float, 32>(__VA_ARGS__);       \
      case mxg::F32 * 256 + 64: return LAUNCH<float, 64>(__VA_ARGS__);       \
      case mxg::F32 * 256 + 128: return LAUNCH<float, 128>(__VA_ARGS__);     \
      default: return (int)cudaErrorInvalidValue;                            \
    }                                                                        \
  }())
