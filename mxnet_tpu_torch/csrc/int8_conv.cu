// int8 post-training quantization: the activation quantize pass (K2) and
// the int8 x int8 -> int32 convolution on the tensor cores (K3).
//
// No Pallas kernel of the JAX package computes either: its quantized
// layers (mxnet_tpu/contrib/quantization.py:115-206) leave XLA to run
// `quantize_array` (clip(round(x / scale), -127, 127)) and the int8
// convolution and product (`lax.conv_general_dilated` / `dot_general`
// with preferred_element_type=int32), and PyTorch has no int8
// convolution on CUDA.  These kernels are that work written by hand.
//
// (K2) quantize_kernel: x (N, C, P) in float16, bfloat16, float32 or int8
//      (P the spatial positions; a Dense input is (M, K, 1)) ->
//      q (N, P, G, Cgp) int8, NHWC with each group's Cg channels padded
//      with zeros to Cgp, a multiple of 4 (the stem's C = 3 becomes 4).
//      Each value is cast to float32, divided by the scale in IEEE
//      arithmetic (__fdiv_rn: not a product with the reciprocal), rounded
//      half to even (rintf) and clipped to [-127, 127]: the bits of the
//      JAX `quantize_array` and of the plain version.  An int8 x (at
//      scale 1) is only laid out, -128 kept.  A thread writes
//      one 4-byte word (4 channels of one position); consecutive threads
//      take consecutive positions, so the reads of each channel are
//      coalesced.  Bound by bytes: x read once, q written once.
//
// (K3) conv_kernel: implicit GEMM.  Per group, rows are the output
//      positions m = (n, oh, ow) (M = N * OH * OW), columns the group's
//      Og output channels, and the depth k runs over (r, s, c) with c
//      fastest, Kreal = KH * KW * Cgp, padded with zero weights to Kp, a
//      multiple of BK.  Weights are repacked once, at the layer's
//      construction, to (G, Og, Kp) int8.  A CTA of 8 warps owns a
//      BM x BN = 128 x 64 tile of one group; each step of BK = 64 depth
//      stages the A tile (gathered from x: 32 contiguous bytes of one tap
//      where Cgp is a multiple of 32, else 4-byte words, zeros outside
//      the image and beyond Kreal) and the B tile in shared memory, two
//      buffers, the next step's loads in registers during this step's
//      products.  Each warp computes 32 x 32 with
//      mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 from fragments
//      read out of shared memory rows padded to 80 bytes (no bank
//      conflicts).  The sums are int32, exact.  Every stride, padding,
//      dilation and group count runs; depthwise (Cg = 1, Og = 1) wastes
//      most of a tile but is right.
//      Epilogues: raw, int32 acc + an int32 bias (nd.contrib's
//      quantized_conv / quantized_fully_connected); or float, y =
//      f32(acc) * scale[o] (+ bias[o]) (relu), each operation rounded once
//      (__int2float_rn, __fmul_rn, __fadd_rn: never an FMA), stored in
//      float16 / bfloat16 / float32 (round to nearest even).  The output
//      is written through strides (n, channel, position), so NCHW and
//      NHWC are both one kernel.
//
// What bounds K3 on this card: at ResNet-50's shapes, operations (2 *
// MACs over the 1,979 TOP/s dense int8 peak of the H100 data sheet,
// which only wgmma reaches; mma.sync issues at a fraction of it).  The
// design is the simple one: tiles staged through shared memory, no TMA
// or wgmma; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace mxq {

enum { F16 = 0, BF16 = 1, F32 = 2, I8 = 3 };          // x dtype (K2)
enum { OUT_F16 = 0, OUT_BF16 = 1, OUT_F32 = 2, OUT_I32 = 3 };   // K3

constexpr int QNT = 256;           // K2 threads per block
constexpr int BM = 128, BN = 64, BK = 64;
constexpr int NT = 256;            // K3 threads per block: 8 warps
constexpr int LDS = BK + 16;       // bytes per shared-memory row

// ---------------------------------------------------------------- K2 --
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One channel's int8: a float is divided, rounded and clipped; an int8 is
// laid out unchanged (the entry point takes it at scale 1 only), -128
// included, as the reference convolves raw int8 data.
template <typename T>
__device__ __forceinline__ int quant(T x, float scale) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(to_f(x), scale)), -127.f), 127.f);
}
__device__ __forceinline__ int quant(int8_t x, float) { return x; }

template <typename T>
__global__ void __launch_bounds__(QNT)
quantize_kernel(const T* __restrict__ x, uint32_t* __restrict__ q,
                long long words, int P, int C, int Cg, int Cgp, int CW,
                float scale) {
  for (long long w = blockIdx.x * (long long)QNT + threadIdx.x; w < words;
       w += (long long)gridDim.x * QNT) {
    const int p = (int)(w % P);
    const long long rest = w / P;
    const int cw = (int)(rest % CW);
    const long long n = rest / CW;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = cw * 4 + j;
      const int grp = cl / Cgp, c = cl - grp * Cgp;
      int v = 0;
      if (c < Cg)
        v = quant(x[(n * C + grp * Cg + c) * (long long)P + p], scale);
      word |= (uint32_t)(uint8_t)(int8_t)v << (8 * j);
    }
    q[(n * P + p) * CW + cw] = word;
  }
}

// ---------------------------------------------------------------- K3 --
// The launch's arguments; ops/int8.py builds the same layout with a numpy
// structured dtype (align=True) and the entry point checks its size.
struct ConvArgs {
  const int8_t* x;        // (N, H, W, G * Cgp)
  const int8_t* w;        // (G, Og, Kp)
  void* out;
  const float* scale;     // (G * Og) float epilogue
  const float* bias;      // (G * Og) or null
  const int* bias_i32;    // (G * Og) or null, raw epilogue
  long long sN, sC, sP;   // output strides, elements
  int N, H, W, G, Cgp, Og, KH, KW, OH, OW;
  int sh, sw, ph, pw, dh, dw;
  int Kreal, Kp, M, out_kind, relu;
};

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(int* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(NT) conv_kernel(const ConvArgs a) {
  __shared__ __align__(16) int8_t sA[2][BM * LDS];
  __shared__ __align__(16) int8_t sB[2][BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int Ctot = a.G * a.Cgp;
  const int P = a.OH * a.OW;

  // A: thread -> one row (output position) and 32 of the 64 bytes of
  // depth; its position's image and top-left corner, once
  const int arow = tid >> 1, ahalf = tid & 1;
  const int am = m0 + arow;
  const bool avalid = am < a.M;
  int ih0 = 0, iw0 = 0;
  long long an = 0;
  if (avalid) {
    an = am / P;
    const int p = am - (int)an * P;
    const int oh = p / a.OW, ow = p - (p / a.OW) * a.OW;
    ih0 = oh * a.sh - a.ph;
    iw0 = ow * a.sw - a.pw;
  }
  const int8_t* xg = a.x + an * a.H * a.W * Ctot + grp * a.Cgp;
  // B: thread -> one row (output channel) and 16 bytes of depth
  const int brow = tid >> 2, bq = tid & 3;
  const bool bvalid = n0 + brow < a.Og;
  const int8_t* wg = a.w + ((long long)grp * a.Og + n0 + brow) * a.Kp
                     + bq * 16;
  const bool vec = (a.Cgp & 31) == 0;

  uint4 ra0, ra1, rb;
  auto tap_ptr = [&](int k, int& c) -> const int8_t* {
    const int tap = k / a.Cgp;
    c = k - tap * a.Cgp;
    const int r = tap / a.KW, s = tap - r * a.KW;
    const int ih = ih0 + r * a.dh, iw = iw0 + s * a.dw;
    if (ih < 0 || ih >= a.H || iw < 0 || iw >= a.W) return nullptr;
    return xg + ((long long)ih * a.W + iw) * Ctot + c;
  };
  auto load = [&](int kt) {
    const int k0 = kt * BK + ahalf * 32;
    ra0 = ra1 = make_uint4(0, 0, 0, 0);
    if (avalid && vec) {
      int c;
      const int8_t* src = k0 < a.Kreal ? tap_ptr(k0, c) : nullptr;
      if (src) {
        ra0 = reinterpret_cast<const uint4*>(src)[0];
        ra1 = reinterpret_cast<const uint4*>(src)[1];
      }
    } else if (avalid) {
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + 4 * j;
        int c;
        const int8_t* src = k < a.Kreal ? tap_ptr(k, c) : nullptr;
        v[j] = src ? ld32(src) : 0u;
      }
      ra0 = make_uint4(v[0], v[1], v[2], v[3]);
      ra1 = make_uint4(v[4], v[5], v[6], v[7]);
    }
    rb = bvalid ? *reinterpret_cast<const uint4*>(wg + (long long)kt * BK)
                : make_uint4(0, 0, 0, 0);
  };
  auto store = [&](int buf) {
    uint4* da = reinterpret_cast<uint4*>(sA[buf] + arow * LDS + ahalf * 32);
    da[0] = ra0;
    da[1] = ra1;
    *reinterpret_cast<uint4*>(sB[buf] + brow * LDS + bq * 16) = rb;
  };

  const int wm = warp >> 1, wn = warp & 1;    // the warp's 32 x 32
  const int g = lane >> 2, t = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = a.Kp / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
    const int8_t* A = sA[buf];
    const int8_t* B = sB[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* r0 = A + (wm * 32 + mi * 16 + g) * LDS + kk + 4 * t;
        af[mi][0] = ld32(r0);
        af[mi][1] = ld32(r0 + 8 * LDS);
        af[mi][2] = ld32(r0 + 16);
        af[mi][3] = ld32(r0 + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* c0 = B + (wn * 32 + ni * 8 + g) * LDS + kk + 4 * t;
        bf[ni][0] = ld32(c0);
        bf[ni][1] = ld32(c0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af[mi], bf[ni]);
    }
    if (kt + 1 < KT) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + mi * 16 + g + (e >> 1) * 8;
        const int o = n0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        if (m >= a.M || o >= a.Og) continue;
        const long long n = m / P;
        const int p = m - (int)n * P;
        const int oc = grp * a.Og + o;
        const long long idx = n * a.sN + oc * a.sC + p * a.sP;
        const int v = acc[mi][ni][e];
        if (a.out_kind == OUT_I32) {
          static_cast<int*>(a.out)[idx] = a.bias_i32 ? v + a.bias_i32[oc]
                                                     : v;
          continue;
        }
        float y = __fmul_rn(__int2float_rn(v), a.scale[oc]);
        if (a.bias) y = __fadd_rn(y, a.bias[oc]);
        if (a.relu && y < 0.f) y = 0.f;
        if (a.out_kind == OUT_F16)
          static_cast<__half*>(a.out)[idx] = __float2half_rn(y);
        else if (a.out_kind == OUT_BF16)
          static_cast<__nv_bfloat16*>(a.out)[idx] = __float2bfloat16_rn(y);
        else
          static_cast<float*>(a.out)[idx] = y;
      }
}

int grid_cap() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!sms[dev]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
    sms[dev] = n;
  }
  return sms[dev] * 16;
}

}  // namespace mxq

// K2: x (N, C, P) of dtype code `dtype` -> q (N, P, G * Cgp) int8 (C = G *
// Cg).  Returns a CUDA error code (cudaErrorInvalidValue for bad sizes).
extern "C" int mx_int8_quantize(const void* x, void* q, int dtype, int N,
                                int C, int P, int G, int Cgp, float scale,
                                void* stream) {
  using namespace mxq;
  if (N <= 0 || C <= 0 || P <= 0 || G <= 0 || C % G || Cgp % 4 ||
      Cgp < C / G)
    return (int)cudaErrorInvalidValue;
  const int CW = G * Cgp / 4;
  const long long words = (long long)N * P * CW;
  long long blocks = (words + QNT - 1) / QNT;
  if (blocks > grid_cap()) blocks = grid_cap();
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  uint32_t* out = static_cast<uint32_t*>(q);
  const int Cg = C / G;
  switch (dtype) {
    case F16:
      quantize_kernel<__half><<<(int)blocks, QNT, 0, st>>>(
          static_cast<const __half*>(x), out, words, P, C, Cg, Cgp, CW,
          scale);
      break;
    case BF16:
      quantize_kernel<__nv_bfloat16><<<(int)blocks, QNT, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), out, words, P, C, Cg, Cgp,
          CW, scale);
      break;
    case F32:
      quantize_kernel<float><<<(int)blocks, QNT, 0, st>>>(
          static_cast<const float*>(x), out, words, P, C, Cg, Cgp, CW,
          scale);
      break;
    case I8:
      quantize_kernel<int8_t><<<(int)blocks, QNT, 0, st>>>(
          static_cast<const int8_t*>(x), out, words, P, C, Cg, Cgp, CW,
          scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The bytes of ConvArgs, for the host's check of its layout.
extern "C" int mx_int8_conv_args_size() { return (int)sizeof(mxq::ConvArgs); }

// K3 over one ConvArgs.  Returns a CUDA error code.
extern "C" int mx_int8_conv(const void* args, int args_bytes, void* stream) {
  using namespace mxq;
  if (args_bytes != (int)sizeof(ConvArgs)) return (int)cudaErrorInvalidValue;
  ConvArgs a;
  memcpy(&a, args, sizeof(ConvArgs));
  if (a.M <= 0 || a.Og <= 0 || a.G <= 0 || a.Kp <= 0 || a.Kp % BK ||
      a.Cgp % 4 || a.Kreal != a.KH * a.KW * a.Cgp || a.Kreal > a.Kp ||
      a.out_kind < OUT_F16 || a.out_kind > OUT_I32 ||
      (a.out_kind != OUT_I32 && !a.scale))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.M + BM - 1) / BM, (a.Og + BN - 1) / BN, a.G);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  conv_kernel<<<grid, NT, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
