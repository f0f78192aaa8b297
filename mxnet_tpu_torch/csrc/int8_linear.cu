// W8A16 product for the serving decode: y = x @ dequant(q)^T.
//
// No Pallas kernel of the JAX package computes this: its int8 weight
// path (mxnet_tpu/serve.py:902-938, `quantize_weights` / `_dequant`)
// dequantizes inside the decode program and leaves XLA to fuse
// `int8 * scale` into the consuming matmul, so the decode reads int8
// weights from HBM.  This file is that fusion written by hand.
//
//   x: (M, K) in the compute dtype T (float16, bfloat16, float32 or
//      float64), row-major;
//   q: (N, K) int8, one float scale for the whole tensor;
//   y: (M, N) in T;
//   dequant(q) = round_T(T(q) * T(scale)), rounded in T exactly as the
//   JAX `_dequant` rounds it (q is at most 7 bits, so T(q) * T(scale)
//   is exact in float32 before that one rounding);
//   sums in float32 (float64 for float64 input).
//
// What bounds it on this card: bytes.  At the decode's M = 8 slots each
// weight byte meets 8 rows of x, far below the ~295 operations per byte
// the card needs to be compute-bound, so the floor is the int8 weight
// over 3.35 TB/s (half the bytes of the same weights in bf16).
//
// Two kernels, one C entry point:
//
// (a) int8_linear_mma, for float16 / bfloat16 with K a multiple of 16
//     and 16-byte aligned x and q (the decode's products): tensor cores
//     (mma.sync m16n8k16, float32 accumulation).  A CTA of MMA_WARPS
//     warps owns 32 weight rows (two m16 tiles) and 8 rows of x (the n8
//     of the mma); its warps split K in chunks of 64 and sum their
//     partial products in shared memory, in warp order, at the end.  Per chunk a
//     lane loads 16 weight bytes of each of its four rows and the 16 x
//     values at the same k (16-byte loads, no shared memory), dequantizes
//     in registers (byte -> float by the 2^23 magic number, times the
//     scale, rounded in pairs to T) and issues 8 mma.  A dot product's k
//     order is free, so each lane's 16 contiguous bytes are dealt to the
//     k slots of its fragments (4 mma steps x 4 slots); x is read in the
//     same order.  Each warp keeps MMA_BUFS chunks in registers, the
//     next ones' loads in flight during a chunk's math.  Each weight byte
//     is read once; x, 1 byte of it per 2 weight bytes, comes from L1 /
//     L2.  (16 warps and 2 buffers: the fastest of 4 / 8 / 16 warps x 2 /
//     3 / 4 buffers by tools/kernel_variants.py on the H100, within 8%
//     of each other; none reached half the byte bound on the decode's
//     4096-wide products.)
// (b) int8_linear_kernel, for the rest (float32, float64, K not a
//     multiple of 16, unaligned x): SIMT.  A CTA of WARPS warps owns
//     COLS = WARPS * CW output columns for a tile of MT <= 16 rows of x
//     (8 for float64).  Lane l of a warp takes bytes 16l .. 16l+15 of
//     each 512-byte stretch of its rows (16-byte loads), dequantizes in
//     registers and accumulates with x staged in shared memory 512
//     columns at a time, permuted so that the 32 lanes read 32
//     consecutive words (no bank conflicts); per-lane sums are reduced
//     across the warp.  Rows whose length K is not a multiple of 16
//     bytes are not 16-byte aligned: those shapes take one byte per lane
//     per step instead.
//
// The caller (ops/int8.py) refuses a weight whose base pointer is not
// 16-byte aligned, and counts one launch of either kernel.
//
// (c) int8_dequant: the whole weight dequantized into a buffer of T, for
//     the prefill and chunk programs, which then run one plain product
//     (the JAX prefill program dequantizes the same way).  Bound by bytes
//     (1 read, sizeof(T) written per weight); one pass, each thread 16
//     weights per step in 16-byte loads and stores where the pointers
//     allow it.

#include "general.cuh"

namespace mxi8 {

using mxg::Acc;
using mxg::from_acc;
using mxg::to_acc;
using mxg::warp_sum;

constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int CW = 4;               // weight rows (output columns) a warp
constexpr int COLS = WARPS * CW;    // output columns a CTA
constexpr int KT = 512;             // x columns a staged tile: 32 lanes x 16

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// Byte i of `flipped` (a word of int8 with each sign bit flipped) as a
// float: 2^23 + (q + 128) built in the mantissa, minus 2^23 + 128.
__device__ __forceinline__ float byte_value(unsigned flipped, int i) {
  return __int_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u + i)) -
         8388736.0f;
}

// dequant of one weight, back in the accumulation type
template <typename T>
__device__ __forceinline__ typename Acc<T>::type dequant(
    float qv, typename Acc<T>::type s) {
  using A = typename Acc<T>::type;
  return to_acc(from_acc<T>(mul_rn(static_cast<A>(qv), s)));
}

// The staged position of tile column p on the vector path: lane p / 16
// holds it as its byte p % 16, stored at (p % 16) * 32 + p / 16.
__device__ __forceinline__ int vec_slot(int p) {
  return ((p & 15) << 5) | (p >> 4);
}

template <typename T, int MT>
__global__ void __launch_bounds__(NT) int8_linear_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q, T* __restrict__ y,
    int M, int N, int K, typename Acc<T>::type s) {
  using A = typename Acc<T>::type;
  __shared__ A xs[MT * KT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * MT;
  const int n0 = blockIdx.x * COLS + warp * CW;
  const bool vec = (K & 15) == 0;
  A acc[CW][MT];
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = A(0);

  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kn = min(KT, K - k0);
    // this tile's weights first, so their loads are in flight while x
    // is staged
    int4 w[CW];
    const int kk = lane * 16;
    if (vec) {
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        w[c] = make_int4(0, 0, 0, 0);
        if (n0 + c < N && kk < kn)
          w[c] = __ldg(reinterpret_cast<const int4*>(
              q + (size_t)(n0 + c) * K + k0 + kk));
      }
    }
    __syncthreads();   // the previous tile of xs is consumed
    for (int i = threadIdx.x; i < MT * KT; i += NT) {
      const int m = i / KT, p = i % KT;
      const A v = (m0 + m < M && p < kn)
                      ? to_acc(x[(size_t)(m0 + m) * K + k0 + p])
                      : A(0);
      xs[m * KT + (vec ? vec_slot(p) : p)] = v;
    }
    __syncthreads();
    if (vec) {
      unsigned words[CW][4];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        words[c][0] = (unsigned)w[c].x ^ 0x80808080u;
        words[c][1] = (unsigned)w[c].y ^ 0x80808080u;
        words[c][2] = (unsigned)w[c].z ^ 0x80808080u;
        words[c][3] = (unsigned)w[c].w ^ 0x80808080u;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        A wv[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c)
          wv[c] = dequant<T>(byte_value(words[c][j >> 2], j & 3), s);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const A xv = xs[m * KT + j * 32 + lane];
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[c][m] += xv * wv[c];
        }
      }
    } else {
      for (int p = lane; p < kn; p += 32) {
        A wv[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c)
          wv[c] = n0 + c < N
                      ? dequant<T>((float)q[(size_t)(n0 + c) * K + k0 + p], s)
                      : A(0);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const A xv = xs[m * KT + p];
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[c][m] += xv * wv[c];
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const A v = warp_sum(acc[c][m]);
      if (lane == 0 && n0 + c < N && m0 + m < M)
        y[(size_t)(m0 + m) * N + n0 + c] = from_acc<T>(v);
    }
}

// ---------------------------------------------------------------------
// (a) the tensor-core kernel
// ---------------------------------------------------------------------
constexpr int KC = 64;              // k a warp takes per chunk: 4 lanes x 16
constexpr int ROWS = 32;            // weight rows a CTA: two m16 tiles
constexpr int MMA_WARPS = 16;       // warps a CTA, splitting K
constexpr int MMA_NT = MMA_WARPS * 32;
constexpr int MMA_BUFS = 2;         // chunks a warp holds: BUFS - 1 in flight

template <typename T> struct Pack;
template <> struct Pack<__nv_bfloat16> {
  __device__ static uint32_t two(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};
template <> struct Pack<__half> {
  __device__ static uint32_t two(float a, float b) {
    __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// bytes i and i + 1 of `flipped`, dequantized and packed: the low half
// holds byte i
template <typename T>
__device__ __forceinline__ uint32_t deq2(unsigned flipped, int i, float s) {
  return Pack<T>::two(__fmul_rn(byte_value(flipped, i), s),
                      __fmul_rn(byte_value(flipped, i + 1), s));
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One chunk's operands of a lane: 16 bytes of each of its four weight
// rows (g, g + 8, g + 16, g + 24) and 16 x values of its x row g.
struct Chunk {
  uint4 w[4];
  uint4 x[2];
};

__device__ __forceinline__ void load_chunk(Chunk& c, const int8_t* q,
                                           const void* x, int n0, int m0,
                                           int M, int N, int K, int k,
                                           int g, int esize) {
  const bool in_k = k < K;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + g + 8 * r;
    c.w[r] = make_uint4(0, 0, 0, 0);
    if (in_k && n < N)
      c.w[r] = __ldg(reinterpret_cast<const uint4*>(q + (size_t)n * K + k));
  }
  c.x[0] = c.x[1] = make_uint4(0, 0, 0, 0);
  if (in_k && m0 + g < M) {
    const uint4* xp = reinterpret_cast<const uint4*>(
        static_cast<const char*>(x) + ((size_t)(m0 + g) * K + k) * esize);
    c.x[0] = __ldg(xp);
    c.x[1] = __ldg(xp + 1);
  }
}

template <typename T>
__device__ __forceinline__ void chunk_mma(float (&acc)[2][4], const Chunk& c,
                                          float s) {
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(c.x);
#pragma unroll
  for (int tile = 0; tile < 2; ++tile) {
    const uint32_t* lo = reinterpret_cast<const uint32_t*>(&c.w[2 * tile]);
    const uint32_t* hi =
        reinterpret_cast<const uint32_t*>(&c.w[2 * tile + 1]);
#pragma unroll
    for (int st = 0; st < 4; ++st) {     // word st: bytes 4st .. 4st + 3
      const unsigned fl = lo[st] ^ 0x80808080u, fh = hi[st] ^ 0x80808080u;
      const uint32_t a[4] = {deq2<T>(fl, 0, s), deq2<T>(fh, 0, s),
                             deq2<T>(fl, 2, s), deq2<T>(fh, 2, s)};
      mma16816<T>(acc[tile], a, xw[2 * st], xw[2 * st + 1]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(MMA_NT) int8_linear_mma(
    const T* __restrict__ x, const int8_t* __restrict__ q, T* __restrict__ y,
    int M, int N, int K, float s) {
  __shared__ float part[MMA_WARPS][2][4][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * ROWS, m0 = blockIdx.y * 8;
  const int chunks = (K + KC - 1) / KC;
  float acc[2][4] = {};
  // warp w takes chunks w, w + W, w + 2W, ...; a ring of BUFS of them is
  // loaded ahead, each refilled BUFS chunks on as soon as it is used (the
  // unrolled ring index is a constant: the buffers stay in registers)
  Chunk buf[MMA_BUFS];
#pragma unroll
  for (int b = 0; b < MMA_BUFS; ++b) {
    const int c = warp + b * MMA_WARPS;
    if (c < chunks)
      load_chunk(buf[b], q, x, n0, m0, M, N, K, c * KC + 16 * t, g,
                 sizeof(T));
  }
  for (int c0 = warp; c0 < chunks; c0 += MMA_BUFS * MMA_WARPS) {
#pragma unroll
    for (int b = 0; b < MMA_BUFS; ++b) {
      const int c = c0 + b * MMA_WARPS;
      if (c < chunks) {
        chunk_mma<T>(acc, buf[b], s);
        const int next = c + MMA_BUFS * MMA_WARPS;
        if (next < chunks)
          load_chunk(buf[b], q, x, n0, m0, M, N, K, next * KC + 16 * t, g,
                     sizeof(T));
      }
    }
  }
#pragma unroll
  for (int tile = 0; tile < 2; ++tile)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[warp][tile][i][lane] = acc[tile][i];
  __syncthreads();
  // thread (tile, i, lane) sums its value over the warps, in warp order:
  // c0, c1 are (row g, x rows 2t, 2t + 1), c2, c3 (row g + 8, the same)
  for (int v = threadIdx.x; v < 2 * 4 * 32; v += MMA_NT) {
    const int tile = v >> 7, i = (v >> 5) & 3, l = v & 31;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) sum += part[w][tile][i][l];
    const int n = n0 + 16 * tile + (l >> 2) + (i >= 2 ? 8 : 0);
    const int m = m0 + 2 * (l & 3) + (i & 1);
    if (n < N && m < M) y[(size_t)m * N + n] = from_acc<T>(sum);
  }
}

// the largest row tile: 16 rows, 8 for float64 (whose staged tile would
// pass the 48 KB of static shared memory at 16)
template <typename T> constexpr int max_rows() {
  return sizeof(typename Acc<T>::type) == 8 ? 8 : 16;
}

template <typename T>
int launch(const void* x, const void* q, void* y, int M, int N, int K,
           double scale, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if constexpr (sizeof(T) == 2) {
    if (K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
      dim3 grid((N + ROWS - 1) / ROWS, (M + 7) / 8);
      int8_linear_mma<T><<<grid, MMA_NT, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const int8_t*>(q),
          static_cast<T*>(y), M, N, K, static_cast<float>(scale));
      return (int)cudaGetLastError();
    }
  }
  int mt = 1;
  while (mt < M && mt < max_rows<T>()) mt *= 2;
  dim3 grid((N + COLS - 1) / COLS, (M + mt - 1) / mt);
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  T* yp = static_cast<T*>(y);
  const A s = static_cast<A>(scale);
  switch (mt) {
    case 1: int8_linear_kernel<T, 1><<<grid, NT, 0, stream>>>(xp, qp, yp, M, N, K, s); break;
    case 2: int8_linear_kernel<T, 2><<<grid, NT, 0, stream>>>(xp, qp, yp, M, N, K, s); break;
    case 4: int8_linear_kernel<T, 4><<<grid, NT, 0, stream>>>(xp, qp, yp, M, N, K, s); break;
    case 8: int8_linear_kernel<T, 8><<<grid, NT, 0, stream>>>(xp, qp, yp, M, N, K, s); break;
    default:
      if constexpr (max_rows<T>() == 16)
        int8_linear_kernel<T, 16><<<grid, NT, 0, stream>>>(xp, qp, yp, M, N, K, s);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace mxi8

namespace mxi8 {

template <typename T>
__global__ void __launch_bounds__(NT) int8_dequant_kernel(
    const int8_t* __restrict__ q, T* __restrict__ out, size_t n, float s,
    bool vec) {
  const size_t stride = (size_t)gridDim.x * NT;
  size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
  if (vec) {
    for (; 16 * i + 16 <= n; i += stride) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(q) + i);
      const unsigned words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                 w.z ^ 0x80808080u, w.w ^ 0x80808080u};
      uint32_t o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = deq2<T>(words[j >> 1], 2 * (j & 1), s);
      uint4* dst = reinterpret_cast<uint4*>(out) + 2 * i;
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
    i = (n / 16) * 16 + (size_t)blockIdx.x * NT + threadIdx.x;   // the tail
  }
  for (; i < n; i += stride)
    out[i] = from_acc<T>(__fmul_rn((float)q[i], s));
}

template <typename T>
__global__ void __launch_bounds__(NT) int8_dequant_wide(
    const int8_t* __restrict__ q, T* __restrict__ out, size_t n,
    typename Acc<T>::type s) {
  const size_t stride = (size_t)gridDim.x * NT;
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n; i += stride)
    out[i] = from_acc<T>(mul_rn(static_cast<typename Acc<T>::type>(q[i]), s));
}

template <typename T>
int launch_dequant(const void* q, void* out, size_t n, double scale,
                   cudaStream_t stream) {
  size_t blocks = (n + 16 * NT - 1) / (16 * NT);
  if (blocks > 132 * 16) blocks = 132 * 16;        // grid-stride past that
  const int8_t* qp = static_cast<const int8_t*>(q);
  T* op = static_cast<T*>(out);
  if constexpr (sizeof(T) == 2) {
    const bool vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    int8_dequant_kernel<T><<<blocks, NT, 0, stream>>>(
        qp, op, n, static_cast<float>(scale), vec);
  } else {
    int8_dequant_wide<T><<<blocks, NT, 0, stream>>>(
        qp, op, n, static_cast<typename Acc<T>::type>(scale));
  }
  return (int)cudaGetLastError();
}

}  // namespace mxi8

// out (n) = dequant(q (n)) in the dtype of `dtype`, `scale` already
// rounded to it.  Returns the launch's CUDA error (0 when it launched).
extern "C" int mx_int8_dequant(const void* q, void* out, long long n,
                               double scale, int dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t m = (size_t)n;
  switch (dtype) {
    case mxg::F16: return mxi8::launch_dequant<__half>(q, out, m, scale, st);
    case mxg::BF16:
      return mxi8::launch_dequant<__nv_bfloat16>(q, out, m, scale, st);
    case mxg::F32: return mxi8::launch_dequant<float>(q, out, m, scale, st);
    case mxg::F64: return mxi8::launch_dequant<double>(q, out, m, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y (M, N) = x (M, K) @ dequant(q (N, K))^T.  `scale` is the tensor's
// scale already rounded to the compute dtype; `dtype` a code of
// general.cuh.  Returns the launch's CUDA error (0 when it launched).
extern "C" int mx_int8_linear(const void* x, const void* q, void* y, int M,
                              int N, int K, double scale, int dtype,
                              void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mxg::F16: return mxi8::launch<__half>(x, q, y, M, N, K, scale, st);
    case mxg::BF16:
      return mxi8::launch<__nv_bfloat16>(x, q, y, M, N, K, scale, st);
    case mxg::F32: return mxi8::launch<float>(x, q, y, M, N, K, scale, st);
    case mxg::F64: return mxi8::launch<double>(x, q, y, M, N, K, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
