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
//   or up to three weights stacked in q by rows, each with its scale
//   and its own y (Segs): the decode's products that read one x (wq,
//   wk, wv; w1, w3) are one launch, which pays one launch's ramp and
//   tail instead of three or two;
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
// (a) int8_linear_mma, for float16 / bfloat16 with K a positive multiple of
//     16 and 16-byte aligned x and q (the decode's products): tensor cores
//     (mma.sync m16n8k16, float32 accumulation; wgmma's rate is not needed at
//     16 operations a byte).  A CTA owns 64 weight rows and 8 rows of x (the
//     n8 of the mma): one producer warp streams its rows' bytes by TMA, 128 k
//     a stage (8 KB of weights and the 2 KB of x at the same k), into a ring
//     of LSTAGES stages under mbarriers, in the 128-byte swizzle; four
//     consumer warps, two to each 32 rows, each taking half of a stage's k,
//     read their fragments out of shared memory, dequantize in registers
//     (byte -> float by the 2^23 magic number, times the row's weight's
//     scale, rounded in pairs to T) and issue the mma.  A dot product's k
//     order is free, so each lane's 16 contiguous bytes are dealt to the k
//     slots of its fragments (4 mma steps x 4 slots); x is read in the same
//     order.  To fill the card at every decode shape (ops/int8.py
//     int8_linear_plan), `splits` CTAs of a cluster split K (the narrow
//     products: 1024 rows give 16 row tiles); each pushes the columns of its
//     partial 8 x 64 tiles that CTA `rank` owns into that CTA's shared
//     memory (distributed shared memory), and after one cluster barrier CTA
//     `rank` sums its 64 / splits columns in rank order (no atomics, the
//     same bits every call).  The launch is a programmatic dependent one:
//     while the previous kernel of the stream finishes, a CTA prefetches
//     its first stages' weights into L2 (a hint, which reads no value, so q
//     may come from that kernel); it waits for that kernel
//     (griddepcontrol.wait) before any load into shared memory or store of
//     y, and lets the next kernel start at once.  (One and two CTAs an SM,
//     4, 6 and 8 stages, two or four consumer warps, and one persistent CTA
//     an SM owning whole rows with no split were timed against each other
//     by tools/kernel_variants.py on the H100; this is the fastest back to
//     back.)
// (b) int8_linear_kernel, for the rest (float32, float64, K not a
//     multiple of 16 or 0, unaligned x): SIMT.  A CTA of WARPS warps owns
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

#include <cooperative_groups.h>

#include <type_traits>

#include "general.cuh"
#include "hopper.cuh"

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

// The products of one launch: q's N rows are up to MAX_SEGS weights
// stacked, weight i (rows end[i - 1] .. end[i] - 1, end[-1] = 0; every
// end past the last weight's is N) with its own scale s[i], already
// rounded to the compute dtype, and its own output y[i] (M x its rows,
// row-major).  The decode's products that read the same x (wq, wk, wv;
// w1, w3) are one launch.
constexpr int MAX_SEGS = 3;
struct Segs {
  void* y[MAX_SEGS];
  double s[MAX_SEGS];
  int end[MAX_SEGS];
};

__device__ __forceinline__ int seg_of(const Segs& g, int row) {
  return (row >= g.end[0]) + (row >= g.end[1]);
}

template <typename T>
__device__ __forceinline__ void store_y(const Segs& g, int m, int row,
                                        T v) {
  const int i = seg_of(g, row), start = i ? g.end[i - 1] : 0;
  static_cast<T*>(g.y[i])[(size_t)m * (g.end[i] - start) + row - start] = v;
}

// The staged position of tile column p on the vector path: lane p / 16
// holds it as its byte p % 16, stored at (p % 16) * 32 + p / 16.
__device__ __forceinline__ int vec_slot(int p) {
  return ((p & 15) << 5) | (p >> 4);
}

template <typename T, int MT>
__global__ void __launch_bounds__(NT) int8_linear_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q, const Segs g,
    int M, int N, int K) {
  using A = typename Acc<T>::type;
  __shared__ A xs[MT * KT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * MT;
  const int n0 = blockIdx.x * COLS + warp * CW;
  const bool vec = (K & 15) == 0;
  A acc[CW][MT], s[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    s[c] = static_cast<A>(g.s[seg_of(g, n0 + c)]);
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = A(0);
  }

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
          wv[c] = dequant<T>(byte_value(words[c][j >> 2], j & 3), s[c]);
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
                      ? dequant<T>((float)q[(size_t)(n0 + c) * K + k0 + p],
                                   s[c])
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
        store_y<T>(g, m0 + m, n0 + c, from_acc<T>(v));
    }
}

// ---------------------------------------------------------------------
// (a) the tensor-core kernel
// ---------------------------------------------------------------------
constexpr int LROWS = 64;           // weight rows a CTA: 2 groups of 32
constexpr int LBK = 128;            // k a stage: one 128-byte int8 row
constexpr int LSTAGES = 4;          // ring depth
constexpr int LKSPLIT = 2;          // warps sharing a group's stage (1, 2)
constexpr int LCONS = 2 * LKSPLIT;  // consumer warps
constexpr int LNT = (LCONS + 1) * 32;             // + the producer warp
constexpr int W_STAGE = LROWS * LBK;              // 8 KB of weights
constexpr int X_STAGE = 8 * LBK * 2;              // 8 rows of x, 2 boxes
constexpr int L_STAGE = W_STAGE + X_STAGE;
constexpr int L_PART = LKSPLIT * 8 * LROWS * 4;   // received partials
constexpr int L_SMEM = LSTAGES * L_STAGE + L_PART + 2 * LSTAGES * 8 + 1024;

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
// rows (g, g + 8, g + 16, g + 24), whose scales are s[0 .. 3], and 16 x
// values of its x row g, all at the same 16 k.
struct Chunk {
  uint4 w[4];
  uint4 x[2];
};

template <typename T>
__device__ __forceinline__ void chunk_mma(float (&acc)[2][4], const Chunk& c,
                                          const float (&s)[4]) {
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(c.x);
#pragma unroll
  for (int tile = 0; tile < 2; ++tile) {
    const uint32_t* lo = reinterpret_cast<const uint32_t*>(&c.w[2 * tile]);
    const uint32_t* hi =
        reinterpret_cast<const uint32_t*>(&c.w[2 * tile + 1]);
#pragma unroll
    for (int st = 0; st < 4; ++st) {     // word st: bytes 4st .. 4st + 3
      const unsigned fl = lo[st] ^ 0x80808080u, fh = hi[st] ^ 0x80808080u;
      const float sl = s[2 * tile], sh = s[2 * tile + 1];
      const uint32_t a[4] = {deq2<T>(fl, 0, sl), deq2<T>(fh, 0, sh),
                             deq2<T>(fl, 2, sl), deq2<T>(fh, 2, sh)};
      mma16816<T>(acc[tile], a, xw[2 * st], xw[2 * st + 1]);
    }
  }
}

// Programmatic dependent launch: the next kernel of the stream may be
// scheduled now; wait for the previous one's memory.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(LNT) int8_linear_mma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_x, const Segs sg, int M, int N,
    int K, int splits) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  float* recv = reinterpret_cast<float*>(sm + LSTAGES * L_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + LSTAGES * L_STAGE +
                                               L_PART);
  uint64_t* empty = full + LSTAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.x % splits;
  const int n0 = blockIdx.x / splits * LROWS, m0 = blockIdx.y * 8;
  const int KT = (K + LBK - 1) / LBK;
  const int kb = split * KT / splits;
  const int nsteps = (split + 1) * KT / splits - kb;
  const int cols = LROWS / splits;     // the columns of y this CTA writes
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < LSTAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], LCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  pdl_launch_dependents();
  if (splits > 1) cluster_arrive();   // waited on before the push

  float acc[2][4] = {};
  if (warp == LCONS) {
    // ---- producer: the first stages' weights into L2 while the previous
    // kernel finishes; every load into shared memory after it has
    if (lane == 0) {
      for (int i = 0; i < min(nsteps, LSTAGES); ++i)
        tma_prefetch_3d(&tm_q, (kb + i) * LBK, n0, 0);
      pdl_wait();
      for (int i = 0; i < nsteps; ++i) {
        const int st = i % LSTAGES;
        unsigned char* sp = sm + st * L_STAGE;
        if (i >= LSTAGES) mbar_wait(&empty[st], (i / LSTAGES - 1) & 1);
        mbar_expect_tx(&full[st], L_STAGE);
        const int k = (kb + i) * LBK;
        tma_load_3d(sp, &tm_q, &full[st], k, n0, 0);
        tma_load_3d(sp + W_STAGE, &tm_x, &full[st], k, m0, 0);
        tma_load_3d(sp + W_STAGE + 1024, &tm_x, &full[st], k + 64, m0, 0);
      }
    }
    if (splits > 1) cluster_wait();
  } else {
    // ---- consumers: warp w owns weight rows 32 (w % 2) .. + 31 and,
    // of each stage's two chunk-steps of 64 k, every LKSPLIT-th from w /
    // 2.  Lane (g, t) takes, in chunk-step cs, the 16 k at 16 * (2t +
    // cs): in the 128-byte swizzle (16-byte chunk j of row r at j ^ (r &
    // 7)) the eight lanes of a quarter-warp then read eight distinct bank
    // groups.
    const int g = lane >> 2, t = lane & 3;
    const int rows = (warp & 1) * 32, half = warp >> 1;
    float s[4];                          // the scales of the lane's rows
#pragma unroll
    for (int r = 0; r < 4; ++r)
      s[r] = static_cast<float>(sg.s[seg_of(sg, n0 + rows + g + 8 * r)]);
    for (int i = 0; i < nsteps; ++i) {
      const int st = i % LSTAGES;
      mbar_wait(&full[st], (i / LSTAGES) & 1);
      const unsigned char* W = sm + st * L_STAGE;
      const unsigned char* X = W + W_STAGE;
      Chunk c[2 / LKSPLIT];
#pragma unroll
      for (int h = 0; h < 2 / LKSPLIT; ++h) {
        const int L = 2 * t + half + h;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          c[h].w[r] = *reinterpret_cast<const uint4*>(
              W + (rows + g + 8 * r) * LBK + ((L ^ g) << 4));
        const unsigned char* xr = X + (L >> 2) * 1024 + g * 128;
        const int xc = 2 * (L & 3);
        c[h].x[0] = *reinterpret_cast<const uint4*>(xr + ((xc ^ g) << 4));
        c[h].x[1] =
            *reinterpret_cast<const uint4*>(xr + (((xc + 1) ^ g) << 4));
      }
#pragma unroll
      for (int h = 0; h < 2 / LKSPLIT; ++h) chunk_mma<T>(acc, c[h], s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);   // the stage may refill
    }
    // push: c0, c1 are (row g, x rows 2t, 2t + 1), c2, c3 (row g + 8, the
    // same); weight row nl goes to the cluster CTA that owns column block
    // nl / cols of y, into its slot for this split and k-half
    if (splits > 1) cluster_wait();
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 2 * t + (i & 1);
        const int nl = rows + 16 * tile + g + (i >= 2 ? 8 : 0);
        const int q = nl / cols;
        float* dst = recv + ((split * LKSPLIT + half) * 8 + m) * cols +
                     nl - q * cols;
        *(splits == 1 ? dst : cl.map_shared_rank(dst, q)) = acc[tile][i];
      }
  }
  // CTA `rank` sums its columns over the cluster's partial tiles in rank
  // order (the same bits every call); y is written only once the
  // previous kernel has finished
  pdl_wait();
  if (splits > 1) cluster_sync(); else __syncthreads();
  for (int v = threadIdx.x; v < 8 * cols; v += LNT) {
    const int m = v / cols, c = v - m * cols;
    float sum = 0.f;
    for (int q = 0; q < splits * LKSPLIT; ++q)
      sum += recv[(q * 8 + m) * cols + c];
    if (m0 + m < M && n0 + split * cols + c < N)
      store_y<T>(sg, m0 + m, n0 + split * cols + c, from_acc<T>(sum));
  }
}

template <typename T>
int launch_mma(const void* x, const void* q, const Segs& sg, int M, int N,
               int K, int splits, cudaStream_t stream) {
  const CUtensorMapDataType xt = std::is_same_v<T, __half>
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tx;
  if (!make_rows_map(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, N, K,
                     LROWS) ||
      !make_rows_map(&tx, xt, 2, x, M, K, 8))
    return (int)cudaErrorInvalidValue;
  auto kern = int8_linear_mma<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + LROWS - 1) / LROWS * splits, (M + 7) / 8);
  cfg.blockDim = dim3(LNT);
  cfg.dynamicSmemBytes = L_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kern, tq, tx, sg, M, N, K, splits);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// the largest row tile: 16 rows, 8 for float64 (whose staged tile would
// pass the 48 KB of static shared memory at 16)
template <typename T> constexpr int max_rows() {
  return sizeof(typename Acc<T>::type) == 8 ? 8 : 16;
}

template <typename T>
int launch(const void* x, const void* q, const Segs& sg, int M, int N,
           int K, int splits, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (K > 0 && K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
      if (splits < 1 || splits > 8 || (splits & (splits - 1)) ||
          splits > (K + LBK - 1) / LBK || (M + 7) / 8 > 65535)
        return (int)cudaErrorInvalidValue;
      return launch_mma<T>(x, q, sg, M, N, K, splits, stream);
    }
  }
  int mt = 1;
  while (mt < M && mt < max_rows<T>()) mt *= 2;
  dim3 grid((N + COLS - 1) / COLS, (M + mt - 1) / mt);
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  switch (mt) {
    case 1: int8_linear_kernel<T, 1><<<grid, NT, 0, stream>>>(xp, qp, sg, M, N, K); break;
    case 2: int8_linear_kernel<T, 2><<<grid, NT, 0, stream>>>(xp, qp, sg, M, N, K); break;
    case 4: int8_linear_kernel<T, 4><<<grid, NT, 0, stream>>>(xp, qp, sg, M, N, K); break;
    case 8: int8_linear_kernel<T, 8><<<grid, NT, 0, stream>>>(xp, qp, sg, M, N, K); break;
    default:
      if constexpr (max_rows<T>() == 16)
        int8_linear_kernel<T, 16><<<grid, NT, 0, stream>>>(xp, qp, sg, M, N, K);
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

// y_i (M, rows[i]) = x (M, K) @ dequant(q_i)^T for the n <= 3 weights q_i
// stacked in q (N, K), N = the sum of rows; scales[i] is q_i's scale
// already rounded to the compute dtype; `dtype` a code of general.cuh;
// `splits` the tensor-core route's depth split (ops/int8.py
// int8_linear_plan).  Returns the launch's CUDA error (0 when it
// launched).
extern "C" int mx_int8_linear(const void* x, const void* q, void* const* ys,
                              const int* rows, const double* scales, int n,
                              int M, int N, int K, int dtype, int splits,
                              void* stream) {
  if (n < 1 || n > mxi8::MAX_SEGS) return (int)cudaErrorInvalidValue;
  mxi8::Segs sg;
  int end = 0;
  for (int i = 0; i < mxi8::MAX_SEGS; ++i) {
    if (i < n && rows[i] <= 0) return (int)cudaErrorInvalidValue;
    end += i < n ? rows[i] : 0;
    sg.y[i] = ys[i < n ? i : n - 1];
    sg.s[i] = scales[i < n ? i : n - 1];
    sg.end[i] = i < n ? end : N;
  }
  if (end != N) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0 || K < 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using mxi8::launch;
  switch (dtype) {
    case mxg::F16: return launch<__half>(x, q, sg, M, N, K, splits, st);
    case mxg::BF16:
      return launch<__nv_bfloat16>(x, q, sg, M, N, K, splits, st);
    case mxg::F32: return launch<float>(x, q, sg, M, N, K, splits, st);
    case mxg::F64: return launch<double>(x, q, sg, M, N, K, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
