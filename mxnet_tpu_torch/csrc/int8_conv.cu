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
// (K2) the activation quantize, three kernels behind one entry point.
//      Each value is cast to float32, divided by the scale in IEEE
//      arithmetic, rounded half to even and clipped to [-127, 127]: the
//      bits of the JAX `quantize_array` and of the plain version (NaN
//      gives 0, as the plain version's conversion does).  The quotient is
//      x * RN(1 / scale), within 3 * 2^-24 of x / scale relatively, so
//      its rint is the IEEE quotient's except within 2^-13 of a half
//      (about one value in 4000), where __fdiv_rn decides (quant_f).  An
//      int8 x (at scale 1) is only laid out, -128 kept.  Bound by bytes:
//      x read once, q written once.
//      quantize_tile: x (N, C, P) in float16, bfloat16, float32 or int8
//      -> q (N, P, G, Cgp) int8, NHWC with each group's Cg channels
//      padded with zeros to Cgp, a multiple of 4 (the stem's C = 3
//      becomes 4).  A CTA transposes one tile of one image through
//      shared memory: TP positions by TCB output channels, 4 KB of int8
//      (TCB = 128 bytes of a wide row, else the whole row rounded to 16,
//      32 or 64).  Each thread loads 4 channel rows x 4 positions (one
//      16-byte load a row for float32 where P % 4 == 0: a warp reads 4
//      runs of 128 bytes), quantizes them, transposes the 4 x 4 bytes in
//      registers and writes 4 words into the tile, whose 16-byte chunks
//      are XOR-swizzled by position so that neither these writes nor the
//      16-byte reads of the stores meet a bank twice; then the tile goes
//      out in 16-byte stores along the channels, a 128-byte line per
//      quarter warp.  A thread's 16 loads are all issued before any is
//      used, and the SM's other CTAs (6 fit) keep the next tiles' loads
//      in flight while one converts; loads and stores are marked
//      streaming (read once, written once); index math is per tile, in
//      32 bits (ops/int8.py int8_quantize_plan picks TCB).
//      quantize_kernel: the Dense's (M, K) input (P = 1) and rows under 16
//      bytes (the stem's 4 channels, where a tile would idle): a thread
//      one 4-byte word, consecutive threads consecutive words.
//      quantize_im2col: x (N, C, H, W), one group whose Cgp is not a
//      multiple of 32 (the stem) -> rows (N * OH * OW, Kc) int8, the
//      depth (kh, kw, c) c fastest as pack_conv_weight orders a weight
//      row, zeros outside the image and past KH * KW * Cgp, Kc rounded
//      up to a multiple of 32.  K3's hopper route then runs them as a
//      1 x 1 convolution over Kc channels with the layer's packed weight
//      unchanged: the same sum in the same order.  A CTA takes TH x TW
//      output positions of one image (ops/int8.py int8_im2col_plan; the
//      stem 4 x 112): it quantizes their input patch into shared memory
//      once (each input value once a CTA, not once a tap: 7 x 7 taps at
//      stride 2 read each value ~12 times), then writes the rows in
//      16-byte chunks, consecutive threads consecutive chunks, each word
//      of depth one read of the patch at the offset a table gives it.
//
// (K3) the int8 convolution, three routes (ops/int8.py int8_conv_route).
//      Two are implicit GEMMs.  Per group, rows are the output positions
//      m = (n, oh, ow) (M = N * OH * OW), columns the group's Og output
//      channels, and the depth k runs over (r, s, c) with c fastest,
//      Kreal = KH * KW * Cgp, padded with zero weights to Kp, a multiple
//      of BK.  Weights are repacked once, at the layer's construction, to
//      (G, Og, Kp) int8.  The sums are int32, exact.
//      Epilogues: raw, int32 acc + an int32 bias (nd.contrib's
//      quantized_conv / quantized_fully_connected); or float, y =
//      f32(acc) * scale[o] (+ bias[o]) (relu), each operation rounded once
//      (__int2float_rn, __fmul_rn, __fadd_rn: never an FMA), stored in
//      float16 / bfloat16 / float32 (round to nearest even).  The output
//      is written through strides (n, channel, position), so NCHW and
//      NHWC are both one kernel.
//      "hopper", conv_hopper (below): one group with Cgp a multiple of
//      32, which 52 of ResNet-50's 53 convolutions and its Dense are.
//      "general", conv_kernel: groups of two or more channels, odd
//      channel counts (the stem through _int8_conv(..., route=
//      "general")).  A CTA of 8 warps owns a BM x BN = 128 x 64 tile of
//      one group; each step of BK = 64 depth stages the A tile (gathered
//      from x: 32 contiguous bytes of one tap where Cgp is a multiple of
//      32, else 4-byte words, zeros outside the image and beyond Kreal)
//      and the B tile in shared memory, two buffers, the next step's
//      loads in registers during this step's products.  Each warp
//      computes 32 x 32 with mma.sync.aligned.m16n8k32.row.col.s32.s8.s8
//      .s32 from fragments read out of shared memory rows padded to 80
//      bytes (no bank conflicts).  Every stride, padding, dilation and
//      group count runs; depthwise (Cg = 1, Og = 1) wastes most of a tile
//      but is right; it runs depthwise layers only when forced, through
//      a copy with each channel padded to 4 bytes.
//      "depthwise", conv_depthwise (below): one channel a group (Cg = 1,
//      G > 1), any multiplier, kernel, stride, padding and dilation: the
//      depthwise layers of MobileNet v1 / v2, which conv_kernel ran at
//      1.0-1.7% of their byte bound (one mma.sync column of 64 and 9 of
//      64 depth bytes used, each channel read as a padded 4-byte word,
//      scattered scalar stores).  The work is a stencil, ~2 operations a
//      byte: bound by bytes, int8 read once and the output (float32 in
//      quantize_net, 80% of the bytes) written once.  The design moves
//      just those: x unpadded (K2 lays one-channel groups out as one
//      group), each input byte staged once a tile (the halo of an 8 x
//      32 tile is 1.33x at 3 x 3 / 1, and its repeats mostly hit L2),
//      and NCHW stores of 4 outputs at once, a warp's runs whole lines.
//      A first design (a byte of shared memory a tap, one output column
//      a thread) ran at 24-50% of the bound, as much issue-bound as
//      memory-bound: its ~24 instructions an output are cut to ~10 by
//      channel-major staging and __dp4a over packed taps (the tensor
//      cores buy nothing at 9 MACs an output).
//
// What bounds K3 on this card: operations at the 7^2 and 14^2 stages
// (2 * MACs over the 1,979 TOP/s dense int8 peak of the H100 data sheet,
// which only wgmma reaches; mma.sync issues at a fraction of it); bytes
// at 56^2, where the float32 NCHW output the int8 ResNet-50 writes is
// most of them.  The hopper route answers both: wgmma from swizzled
// shared memory fed by an asynchronous ring, split depth where the tiles
// do not fill the card, and persistent CTAs whose loads overlap the last
// tile's 16-byte stores.

#include <cuda_fp16.h>
#include <string.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"

namespace mxq {

enum { F16 = 0, BF16 = 1, F32 = 2, I8 = 3 };          // x dtype (K2)
enum { OUT_F16 = 0, OUT_BF16 = 1, OUT_F32 = 2, OUT_I32 = 3 };   // K3

constexpr int QNT = 256;           // K2 threads per block
constexpr int QTILE = 4096;        // K2 tile bytes: positions x channels
constexpr int COL_PATCH = 24576;   // im2col: input patch bytes a CTA holds
constexpr int COL_WORDS = 512;     // most 4-byte words an im2col row holds
constexpr int BM = 128, BN = 64, BK = 64;
constexpr int NT = 256;            // K3 threads per block: 8 warps
constexpr int LDS = BK + 16;       // bytes per shared-memory row

// ---------------------------------------------------------------- K2 --
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// RN(1 / s) where s and 1 / s are normal, else 0 (every quotient then
// takes __fdiv_rn).
__device__ __forceinline__ float quant_recip(float s) {
  return fabsf(s) >= 0x1p-126f && fabsf(s) <= 0x1p126f ? __frcp_rn(s) : 0.f;
}

// clip(rint(x / s), -127, 127) with x / s the IEEE quotient, r =
// quant_recip(s).  q = x * r is within 3 * 2^-24 * |x / s| of RN(x / s),
// under 2^-15 below 128: where q is more than 2^-13 from a half, both
// round to one integer; from 128 up both clip alike.  The conversion
// rounds half to even, saturates, and gives 0 for NaN.
__device__ __forceinline__ int quant_f(float x, float s, float r) {
  float q = x * r;
  if (r == 0.f ||
      (fabsf(q) < 128.f && fabsf(q - rintf(q)) >= 0.5f - 0x1p-13f))
    q = __fdiv_rn(x, s);
  return max(min(__float2int_rn(q), 127), -127);
}

// One channel's int8: a float is divided, rounded and clipped; an int8 is
// laid out unchanged (the entry point takes it at scale 1 only), -128
// included, as the reference convolves raw int8 data.
template <typename T>
__device__ __forceinline__ int quant(T x, float s, float r) {
  return quant_f(to_f(x), s, r);
}
__device__ __forceinline__ int quant(int8_t x, float, float) { return x; }

__device__ __forceinline__ uint32_t byte_at(int v, int j) {
  return (uint32_t)(uint8_t)(int8_t)v << (8 * j);
}

// The Dense's input (P = 1) and rows under 16 bytes (any shape is right):
// a thread one 4-byte word.
template <typename T>
__global__ void __launch_bounds__(QNT)
quantize_kernel(const T* __restrict__ x, uint32_t* __restrict__ q,
                long long words, int P, int C, int Cg, int Cgp, int CW,
                float scale) {
  const float r = quant_recip(scale);
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
      if (c < Cg)
        word |= byte_at(
            quant(x[(n * C + grp * Cg + c) * (long long)P + p], scale, r), j);
    }
    q[(n * P + p) * CW + cw] = word;
  }
}

// 4 values of T as one load
template <typename T> struct Run4;
template <> struct Run4<float> { using V = float4; };
template <> struct Run4<__half> { using V = uint2; };
template <> struct Run4<__nv_bfloat16> { using V = uint2; };
template <> struct Run4<int8_t> { using V = uint32_t; };

// Positions p .. p + 3 of one channel row: one vector load where `vec`
// (P % 4 == 0 on an aligned x: every run is aligned), else four loads,
// clamped to the row (the positions past P are never stored).
template <typename T>
__device__ __forceinline__ void load_run(const T* row, int p, int P,
                                         bool vec, T (&v)[4]) {
  if (vec) {
    if (p >= P) return;         // a run past the row (P % 4 == 0)
    union {
      typename Run4<T>::V w;
      T e[4];
    } u;
    u.w = __ldcs(reinterpret_cast<const typename Run4<T>::V*>(row + p));
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = u.e[i];
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = row[min(p + i, P - 1)];
  }
}

// A tile of one image: TP = QTILE / TCB positions by TCB output channels.
// The tile lives in 128-byte lines, RPL = 128 / TCB rows a line; the
// 16-byte chunk h of line L sits at chunk h ^ ((row >> 2) & 7).  A warp's
// unit writes (4 channel quads x 8 runs of 4 positions, one row of each
// run at a time) and a quarter warp's 16-byte reads (one line) each touch
// every bank once.
template <typename T, int TCB>
__global__ void __launch_bounds__(QNT)
quantize_tile(const T* __restrict__ x, int8_t* __restrict__ q, int P, int C,
              int Cg, int Cgp, int Ctot, int ptiles, float scale, bool vec) {
  constexpr int TP = QTILE / TCB, RPL = 128 / TCB, CPR = TCB / 16;
  constexpr int UNITS = QTILE / 16, PER = UNITS / QNT;
  __shared__ __align__(16) uint32_t tile[QTILE / 4];
  const int n = blockIdx.x / ptiles;
  const int p0 = (blockIdx.x - n * ptiles) * TP, c0 = blockIdx.y * TCB;
  const T* xn = x + (long long)n * C * P;
  int8_t* qn = q + ((long long)n * P + p0) * Ctot;
  const int lane = threadIdx.x & 31;
  const float r = quant_recip(scale);

  // every load first: unit k -> channel quad cq, run of positions pq
  T v[PER][4][4];
  bool ok[PER][4];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int wu = (threadIdx.x >> 5) + k * (QNT / 32);
    const int cq = (wu % CPR) * 4 + (lane >> 3);
    const int pq = (wu / CPR) * 8 + (lane & 7);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oc = c0 + 4 * cq + j;
      int src = oc;                     // one group: no division
      ok[k][j] = oc < Cg;
      if (Ctot != Cgp) {
        const int grp = oc / Cgp, cl = oc - grp * Cgp;
        ok[k][j] = oc < Ctot && cl < Cg;
        src = grp * Cg + cl;
      }
      if (ok[k][j]) load_run(xn + src * P, p0 + 4 * pq, P, vec, v[k][j]);
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int wu = (threadIdx.x >> 5) + k * (QNT / 32);
    const int cq = (wu % CPR) * 4 + (lane >> 3);
    const int pq = (wu / CPR) * 8 + (lane & 7);
#pragma unroll
    for (int i = 0; i < 4; ++i) {         // row 4 pq + i: 4 channels
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ok[k][j]) word |= byte_at(quant(v[k][j][i], scale, r), j);
      const int row = 4 * pq + i;
      const int h = (row % RPL) * CPR + (cq >> 2);
      tile[(row / RPL) * 32 + ((h ^ (pq & 7)) << 2) + (cq & 3)] = word;
    }
  }
  __syncthreads();
  const uint4* chunks = reinterpret_cast<const uint4*>(tile);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int t = threadIdx.x + k * QNT, line = t >> 3, h = t & 7;
    const int row = line * RPL + h / CPR, col = (h % CPR) * 16;
    const int oc = c0 + col;
    if (p0 + row >= P || oc >= Ctot) continue;
    const uint4 val = chunks[line * 8 + (h ^ ((row >> 2) & 7))];
    int8_t* dst = qn + row * Ctot + oc;
    if (oc + 16 <= Ctot && (Ctot & 15) == 0) {
      __stcs(reinterpret_cast<uint4*>(dst), val);
    } else {
      const uint32_t w4[4] = {val.x, val.y, val.z, val.w};
      for (int w = 0; w < 4 && oc + 4 * w < Ctot; ++w)
        reinterpret_cast<uint32_t*>(dst)[w] = w4[w];
    }
  }
}

// im2col geometry and plan, 18 ints from ops/int8.py (int8_quantize_im2col,
// int8_im2col_plan): a CTA takes TH x TW output positions of one image
struct ColGeo {
  int N, C, H, W, Cgp, KH, KW, sh, sw, ph, pw, dh, dw, OH, OW, Kc, TH, TW;
};

// The CTA's input patch (the taps of its TH x TW positions) is read once
// and quantized into shared memory, [row][column][Cgp] int8, zeros
// outside the image and in the padded channels; then each thread writes
// 16-byte chunks of the rows, each 4-byte word of depth one aligned read
// of the patch at the word's tabulated offset.
template <typename T>
__global__ void __launch_bounds__(QNT)
quantize_im2col(const T* __restrict__ x, int8_t* __restrict__ q,
                const ColGeo g, float scale) {
  __shared__ __align__(16) int8_t patch[COL_PATCH];
  __shared__ __align__(16) int word_off[COL_WORDS];
  const int twn = (g.OW + g.TW - 1) / g.TW, thn = (g.OH + g.TH - 1) / g.TH;
  const int tw = blockIdx.x % twn, rest = blockIdx.x / twn;
  const int th = rest % thn, n = rest / thn;
  const int oh0 = th * g.TH, ow0 = tw * g.TW;
  const int ih0 = oh0 * g.sh - g.ph, iw0 = ow0 * g.sw - g.pw;
  const int PH = (g.TH - 1) * g.sh + (g.KH - 1) * g.dh + 1;
  const int PW = (g.TW - 1) * g.sw + (g.KW - 1) * g.dw + 1;
  const int Kreal = g.KH * g.KW * g.Cgp, nw = g.Kc / 4;
  for (int w = threadIdx.x; w < nw; w += QNT) {
    const int k = 4 * w;
    int off = -1;                               // past Kreal: zeros
    if (k < Kreal) {
      const int tap = k / g.Cgp, r = tap / g.KW;
      off = ((r * g.dh) * PW + (tap - r * g.KW) * g.dw) * g.Cgp +
            (k - tap * g.Cgp);
    }
    word_off[w] = off;
  }
  // the patch: a warp a (channel, row), its lanes along the row, 8 loads
  // in flight a lane (more rows' loads at once measured slower)
  const float rs = quant_recip(scale);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* xn = x + (long long)n * g.C * g.H * g.W;
  for (int cr = warp; cr < g.Cgp * PH; cr += QNT / 32) {
    const int c = cr / PH, py = cr - c * PH, ih = ih0 + py;
    const bool row_in = c < g.C && (unsigned)ih < (unsigned)g.H;
    const T* src = xn + (c * g.H + ih) * g.W;
    int8_t* dst = patch + py * PW * g.Cgp + c;
    for (int px0 = lane; px0 < PW; px0 += 256) {
      T v[8];
      bool in[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int iw = iw0 + px0 + 32 * i;
        in[i] = row_in && (unsigned)iw < (unsigned)g.W;
        if (in[i]) v[i] = src[iw];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (px0 + 32 * i < PW)
          dst[(px0 + 32 * i) * g.Cgp] =
              (int8_t)(in[i] ? quant(v[i], scale, rs) : 0);
    }
  }
  __syncthreads();
  // thread -> (row, chunk) of the tile's rows, stepped QNT chunks at a
  // time with carries: a division only where a row of positions wraps
  const int cw = g.Kc / 16, rows = g.TH * g.TW;
  const int drow = QNT / cw, dch = QNT - drow * cw;
  int row = threadIdx.x / cw, ch = threadIdx.x - row * cw;
  int lr = row / g.TW, lc = row - lr * g.TW;
  while (row < rows) {
    if (oh0 + lr < g.OH && ow0 + lc < g.OW) {
      const int base = (lr * g.sh * PW + lc * g.sw) * g.Cgp;
      const int4 o4 = reinterpret_cast<const int4*>(word_off)[ch];
      const int offs[4] = {o4.x, o4.y, o4.z, o4.w};
      uint32_t wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[j] = offs[j] < 0 ? 0u : *reinterpret_cast<const uint32_t*>(
                                       patch + base + offs[j]);
      const long long m = ((long long)n * g.OH + oh0 + lr) * g.OW + ow0 +
                          lc;
      *reinterpret_cast<uint4*>(q + m * g.Kc + ch * 16) =
          make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
    int adv = drow;
    ch += dch;
    if (ch >= cw) {
      ch -= cw;
      ++adv;
    }
    row += adv;
    lc += adv;
    if (lc >= g.TW) {
      lr += lc / g.TW;
      lc -= (lc / g.TW) * g.TW;
    }
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
  // the launch plan: route 0 general, 1 hopper, 2 depthwise; the hopper
  // tile shape `cfg` (HOPPER_CFGS), the `splits` CTAs of a cluster that
  // split the depth's stages evenly (ops/int8.py int8_conv_plan); the
  // depthwise tile, `th` x `tw` output positions of `cb` channels
  // (int8_depthwise_plan); and the `ctas`
  int route, cfg, splits, ctas, th, tw, cb;
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

// ------------------------------------------------------- K3, hopper --
// The route for G == 1 and Cgp % 32 == 0: every 16-byte run of depth
// lies in one tap.  A CTA is one producer warpgroup and NWG consumer
// warpgroups around a ring of STAGES stages, each stage HBK = 128 bytes
// of depth of a tile of positions (P, gathered by cp.async) and a tile of
// output channels (W, one TMA box of the packed weight), both K-major in
// the 128-byte swizzle.  Consumer warpgroup w runs wgmma
// m64nNk32.s32.s8.s8 on rows 64w .. 64w + 63 of the A operand: the
// positions, or with SWAP (small M: the Dense) the output channels, so
// that a handful of positions is wgmma's N side and not most of a 64-row
// tile.  Per tile, the producer tabulates the positions (image base,
// corner: one division a row); each of its threads then walks the taps
// of one 16-byte chunk of depth with no division, and its copies arrive
// on the stage's mbarrier as they land; then it fills the epilogue's
// tables (output offsets, scales, biases), double-buffered under
// mbarriers.  Unsplit, CTAs are persistent: the producer streams the
// next tile while the consumers finish the last.  Split, `splits` CTAs
// of one cluster share a tile's depth: each pushes the rows of its int32
// partial tile that CTA `rank` finishes into that CTA's shared memory
// (distributed shared memory; no atomics), and after one cluster barrier
// CTA `rank` sums its slice in rank order (int32 sums are exact).  The
// sums are staged along the output's contiguous dimension and written
// as 16-byte runs.
constexpr int HBK = 128;         // depth bytes a stage: one swizzled row
constexpr int HPROD = 128;       // the producer warpgroup

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void fence_acc(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// barrier `id` over the first `n` threads (0 is __syncthreads', 1 the
// producer warpgroup's)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int NWG, int N, bool SWAP, bool NCHW>
struct HCfg {
  static constexpr int AM = 64 * NWG;        // rows of wgmma's A operand
  static constexpr int PR = SWAP ? N : AM;   // positions a tile
  static constexpr int WR = SWAP ? AM : N;   // output channels a tile
  static constexpr int P_BYTES = PR * HBK, W_BYTES = WR * HBK;
  static constexpr int STAGE = P_BYTES + W_BYTES;
  static constexpr int STAGES = SWAP ? 4 : 3;               // ring depth
  static constexpr int CONS = 128 * NWG;                    // consumers
  static constexpr int THREADS = CONS + HPROD;
  // The int32 sums are staged along the output's contiguous dimension:
  // positions (NCHW) or channels (NHWC).  INNER_A: that is wgmma's A
  // side, and a slice of a_n = AM / splits rows is stored transposed,
  // [N][a_n (+ 4 unsplit)]; else [a_n][N + 4].  Runs of 16 bytes stay
  // aligned; the pad keeps the unsplit tile's writes off each other's
  // banks.  A CTA receives `splits` such slices, one from each CTA of
  // its cluster.
  static constexpr bool INNER_A = NCHW != SWAP;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int ACC = (INNER_A ? N * (AM + 4) : AM * (N + 4)) * 4;
  // per-tile tables: the producer's row table (image base, corner) and,
  // two tiles' worth, the epilogue's (each position's output offset, -1
  // past M; each channel's scale and bias)
  static constexpr int TABLES = PR * 3 * 4 + 2 * (PR * 8 + WR * 8);
  static constexpr int BARS = (2 * STAGES + 4) * 8;
  static constexpr int SMEM = RING + ACC + TABLES + BARS + 1024;
  static constexpr int MINB = N == 128 && !SWAP ? 1 : 2;     // CTAs an SM
};

// One epilogue value: the float one (each operation rounded once) or the
// raw int32 sum plus its bias.
template <typename OT>
__device__ __forceinline__ OT finish(int v, float sc, float bi, bool bias,
                                     bool relu) {
  if constexpr (std::is_same_v<OT, int>) {
    return v + __float_as_int(bi);
  } else {
    float y = __fmul_rn(__int2float_rn(v), sc);
    if (bias) y = __fadd_rn(y, bi);
    if (relu && y < 0.f) y = 0.f;
    if constexpr (std::is_same_v<OT, float>) return y;
    else if constexpr (std::is_same_v<OT, __half>) return __float2half_rn(y);
    else return __float2bfloat16_rn(y);
  }
}

// This CTA's slice of the tile, A rows [rank * a_n, +a_n): the `splits`
// received partial slices summed in rank order, finished and stored by
// the consumer threads.  Each takes VEC values (16 bytes of output) along
// the output's contiguous dimension; offsets, scales and biases come from
// the tile's tables.
template <int NWG, int N, bool SWAP, bool NCHW, typename OT>
__device__ void hopper_store(const ConvArgs& a, const int* recv,
                             const long long* pos_off, const float* ch_sc,
                             const float* ch_bi, int rank, int o0) {
  using C = HCfg<NWG, N, SWAP, NCHW>;
  constexpr int VEC = 16 / sizeof(OT);
  const int S = a.splits, a_n = C::AM / S, a_lo = rank * a_n;
  const int lds = C::INNER_A ? a_n + (S == 1 ? 4 : 0) : N + 4;
  const int slice = (C::INNER_A ? N : a_n) * lds;
  const int inner_v = (C::INNER_A ? a_n : N) / VEC;
  const int groups = (C::INNER_A ? N : a_n) * inner_v;
  const bool bias = a.out_kind == OUT_I32 ? a.bias_i32 != nullptr
                                          : a.bias != nullptr;
  OT* out = static_cast<OT*>(a.out);
  for (int gi = threadIdx.x; gi < groups; gi += C::CONS) {
    const int outer = gi / inner_v, in0 = (gi - outer * inner_v) * VEC;
    const int off = outer * lds + in0;     // local row-major in the slice
    int sum[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) sum[v] = 0;
    for (int q = 0; q < S; ++q) {
#pragma unroll
      for (int v = 0; v < VEC; v += 4) {
        const int4 w = *reinterpret_cast<const int4*>(recv + q * slice +
                                                      off + v);
        sum[v] += w.x;
        sum[v + 1] += w.y;
        sum[v + 2] += w.z;
        sum[v + 3] += w.w;
      }
    }
    const int arow0 = a_lo + (C::INNER_A ? in0 : outer);
    const int bcol0 = C::INNER_A ? outer : in0;
    // the run: positions of one channel (NCHW) or channels of one
    // position (NHWC)
    const int pi0 = SWAP ? bcol0 : arow0, ol0 = SWAP ? arow0 : bcol0;
    union {
      OT v[VEC];
      uint4 u;
    } vals;
    if constexpr (NCHW) {
      const int o = o0 + ol0;
      if (o >= a.Og) continue;
      const float sc = ch_sc[ol0], bi = ch_bi[ol0];
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        vals.v[v] = finish<OT>(sum[v], sc, bi, bias, a.relu);
      const long long b0 = pos_off[pi0], b1 = pos_off[pi0 + VEC - 1];
      const long long idx = b0 + o * a.sC;
      if (b0 >= 0 && b1 == b0 + VEC - 1 && idx % VEC == 0) {
        *reinterpret_cast<uint4*>(out + idx) = vals.u;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (pos_off[pi0 + v] >= 0)
            out[pos_off[pi0 + v] + o * a.sC] = vals.v[v];
      }
    } else {
      const long long b0 = pos_off[pi0];
      const int oc0 = o0 + ol0;
      if (b0 < 0) continue;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        vals.v[v] = finish<OT>(sum[v], ch_sc[ol0 + v], ch_bi[ol0 + v], bias,
                               a.relu);
      if (oc0 + VEC <= a.Og && (b0 + oc0) % VEC == 0) {
        *reinterpret_cast<uint4*>(out + b0 + oc0) = vals.u;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (oc0 + v < a.Og) out[b0 + oc0 + v] = vals.v[v];
      }
    }
  }
}

// A cluster of `splits` CTAs takes tile cluster, cluster + clusters, ...
// (one tile a cluster when splits > 1; unsplit, a persistent CTA walks
// several, its producer streaming the next tile's stages while the
// consumers finish the last).
template <int NWG, int N, bool SWAP, bool NCHW>
__global__ void __launch_bounds__(HCfg<NWG, N, SWAP, NCHW>::THREADS,
                                  HCfg<NWG, N, SWAP, NCHW>::MINB)
conv_hopper(const __grid_constant__ ConvArgs a,
            const __grid_constant__ CUtensorMap tm_w) {
  using C = HCfg<NWG, N, SWAP, NCHW>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  int* recv = reinterpret_cast<int*>(sm + C::RING);
  long long* pos_offs = reinterpret_cast<long long*>(sm + C::RING + C::ACC);
  float* ch_scs = reinterpret_cast<float*>(pos_offs + 2 * C::PR);
  float* ch_bis = ch_scs + 2 * C::WR;
  int* row_base = reinterpret_cast<int*>(ch_bis + 2 * C::WR);
  int* row_ih0 = row_base + C::PR;
  int* row_iw0 = row_ih0 + C::PR;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::RING + C::ACC +
                                               C::TABLES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* tab_full = empty + C::STAGES;    // a tile's epilogue tables
  uint64_t* tab_empty = tab_full + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = a.splits;
  const int split = blockIdx.x % S, cluster = blockIdx.x / S;
  const int clusters = gridDim.x / S;
  const int mt = (a.M + C::PR - 1) / C::PR, ot = (a.Og + C::WR - 1) / C::WR;
  const int b_tiles = SWAP ? mt : ot, tiles = mt * ot;
  const int KT = (a.Kp + HBK - 1) / HBK;
  const int kb = split * KT / S;
  const int nsteps = (split + 1) * KT / S - kb;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], HPROD + 1);     // each producer thread + the TMA
      mbar_init(&empty[s], 4 * NWG);      // each consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&tab_full[b], HPROD);
      mbar_init(&tab_empty[b], 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (S > 1) cluster_arrive();       // waited on before the push

  int gs = 0;                        // stages through the ring so far
  if (warp >= 4 * NWG) {
    // ---- producer.  A tile's row table first, a row a thread (one
    // division a row); then thread -> 16-byte chunk j of rows r0 + 16i,
    // the (r, s, c) walk of chunk j stepping HBK bytes a stage with no
    // division.  Each thread's copies arrive on the stage's barrier as
    // they land (cp.async.mbarrier.arrive.noinc): no thread waits on its
    // own copies.  Once a tile's stages are issued, the producer fills
    // the epilogue's tables for it, off the consumers' path.
    constexpr int RPT = C::PR / 16;
    const int ptid = tid - C::CONS, j = ptid & 7, r0 = ptid >> 3;
    const int P = a.OH * a.OW, Ct = a.Cgp;         // G == 1
    for (int t = cluster, tt = 0; t < tiles; t += clusters, ++tt) {
      const int p0 = (SWAP ? t % b_tiles : t / b_tiles) * C::PR;
      const int o0 = (SWAP ? t / b_tiles : t % b_tiles) * C::WR;
      warpgroup_sync(HPROD);         // the last tile's table is read
      long long my_off = -1;         // this thread's row's output offset
      if (ptid < C::PR) {
        const int m = p0 + ptid;
        int base = 0, ih0 = -(1 << 29), iw0 = 0;  // past M: never inside
        if (m < a.M) {
          const int n = m / P, p = m - n * P;
          const int oh = p / a.OW, ow = p - oh * a.OW;
          ih0 = oh * a.sh - a.ph;
          iw0 = ow * a.sw - a.pw;
          base = ((n * a.H + ih0) * a.W + iw0) * Ct;
          my_off = n * a.sN + p * a.sP;
        }
        row_base[ptid] = base;
        row_ih0[ptid] = ih0;
        row_iw0[ptid] = iw0;
      }
      warpgroup_sync(HPROD);
      int base[RPT], ih0[RPT], iw0[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        base[i] = row_base[r0 + 16 * i];
        ih0[i] = row_ih0[r0 + 16 * i];
        iw0[i] = row_iw0[r0 + 16 * i];
      }
      const int k = kb * HBK + 16 * j;
      const int tap = k / Ct;
      int c = k - tap * Ct, r = tap / a.KW, s = tap - r * a.KW;
      for (int i = 0; i < nsteps; ++i, ++gs) {
        const int st = gs % C::STAGES;
        unsigned char* sp = sm + st * C::STAGE;     // P tile, then W tile
        if (gs >= C::STAGES)
          mbar_wait(&empty[st], (gs / C::STAGES - 1) & 1);
        if (ptid == 0) {
          mbar_expect_tx(&full[st], C::W_BYTES);
          tma_load_3d(sp + C::P_BYTES, &tm_w, &full[st], (kb + i) * HBK,
                      o0, 0);
        }
        const bool kin = r < a.KH;
        const int dy = r * a.dh, dx = s * a.dw;
        const int off = (dy * a.W + dx) * Ct + c;
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int row = r0 + 16 * q;
          const int ih = ih0[q] + dy, iw = iw0[q] + dx;
          const bool ok = kin && (unsigned)ih < (unsigned)a.H &&
                          (unsigned)iw < (unsigned)a.W;
          cp_async16_zfill(sp + row * HBK + ((j ^ (row & 7)) << 4),
                           a.x + (ok ? base[q] + off : 0), ok);
        }
        cp_async_arrive(&full[st]);
        c += HBK;
        while (c >= Ct) {
          c -= Ct;
          if (++s == a.KW) {
            s = 0;
            ++r;
          }
        }
      }
      // the epilogue's tables, into the buffer of this tile's parity once
      // the tile two back is stored
      const int b = tt & 1;
      if (tt >= 2) mbar_wait(&tab_empty[b], ((tt >> 1) - 1) & 1);
      if (ptid < C::PR) pos_offs[b * C::PR + ptid] = my_off;
      if (ptid < C::WR) {
        const int o = min(o0 + ptid, a.Og - 1);
        if (a.out_kind == OUT_I32) {
          ch_bis[b * C::WR + ptid] =
              __int_as_float(a.bias_i32 ? a.bias_i32[o] : 0);
        } else {
          ch_scs[b * C::WR + ptid] = a.scale[o];
          ch_bis[b * C::WR + ptid] = a.bias ? a.bias[o] : 0.f;
        }
      }
      mbar_arrive(&tab_full[b]);
    }
    if (S > 1) {                     // the consumers' two waits
      cluster_wait();
      cluster_sync();
    }
    return;
  }

  // ---- consumers: per tile, 4 k-steps of 32 bytes a stage (the
  // gathered tile was written by cp.async, the generic proxy: a proxy
  // fence before wgmma reads it), a stage released once the wgmma group
  // reading it has completed; then each partial slice pushed to the
  // cluster CTA that finishes it, and this CTA's slice stored.
  const int wg = warp >> 2;
  const int a_n = C::AM / S;
  const int lds = C::INNER_A ? a_n + (S == 1 ? 4 : 0) : N + 4;
  const int slice = (C::INNER_A ? N : a_n) * lds;
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  for (int t = cluster, tt = 0; t < tiles; t += clusters, ++tt) {
    const int o0 = (SWAP ? t / b_tiles : t % b_tiles) * C::WR;
    int acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0;
    for (int i = 0; i < nsteps; ++i, ++gs) {
      const int st = gs % C::STAGES;
      mbar_wait(&full[st], (gs / C::STAGES) & 1);
      fence_proxy_async();
      const unsigned char* sp = sm + st * C::STAGE;
      const unsigned char* A = (SWAP ? sp + C::P_BYTES : sp) + wg * 64 * HBK;
      const unsigned char* B = SWAP ? sp : sp + C::P_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HBK / 32; ++kk)
        wgmma_s8<N>(acc, sw128_desc(A + 32 * kk, 16, 1024),
                    sw128_desc(B + 32 * kk, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      if (i > 0 && lane == 0)
        mbar_arrive(&empty[(gs - 1) % C::STAGES]);
    }
    wgmma_wait0();
    fence_acc(acc);
    if (nsteps > 0 && lane == 0) mbar_arrive(&empty[(gs - 1) % C::STAGES]);
    // push: A row `row` belongs to the slice of CTA row / a_n
    named_sync(2, C::CONS);          // the last tile is stored
    if (S > 1) cluster_wait();
    const int g = lane >> 2, tq = lane & 3;
    const int row0 = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
      const int q = row / a_n, rl = row - q * a_n;
      int* dst = recv + split * slice +
                 (C::INNER_A ? col * lds + rl : rl * lds + col);
      *(S == 1 ? dst : cl.map_shared_rank(dst, q)) = acc[i];
    }
    if (S > 1) cluster_sync(); else named_sync(2, C::CONS);
    const int b = tt & 1;
    mbar_wait(&tab_full[b], (tt >> 1) & 1);
    const long long* pos_off = pos_offs + b * C::PR;
    const float* ch_sc = ch_scs + b * C::WR;
    const float* ch_bi = ch_bis + b * C::WR;
    switch (a.out_kind) {
      case OUT_F16:
        hopper_store<NWG, N, SWAP, NCHW, __half>(a, recv, pos_off, ch_sc,
                                                 ch_bi, split, o0);
        break;
      case OUT_BF16:
        hopper_store<NWG, N, SWAP, NCHW, __nv_bfloat16>(a, recv, pos_off,
                                                        ch_sc, ch_bi, split,
                                                        o0);
        break;
      case OUT_F32:
        hopper_store<NWG, N, SWAP, NCHW, float>(a, recv, pos_off, ch_sc,
                                                ch_bi, split, o0);
        break;
      default:
        hopper_store<NWG, N, SWAP, NCHW, int>(a, recv, pos_off, ch_sc,
                                              ch_bi, split, o0);
        break;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&tab_empty[b]);
  }
}

template <int NWG, int N, bool SWAP, bool NCHW>
int launch_hopper(const ConvArgs& a, cudaStream_t st) {
  using C = HCfg<NWG, N, SWAP, NCHW>;
  CUtensorMap tm;
  if (!make_rows_map(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.w, a.Og, a.Kp,
                     C::WR))
    return (int)cudaErrorInvalidValue;
  auto kern = conv_hopper<NWG, N, SWAP, NCHW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  // the plan's CTAs: every tile's cluster once when split, at most the
  // tiles when not
  const long long tiles = (long long)((a.M + C::PR - 1) / C::PR) *
                          ((a.Og + C::WR - 1) / C::WR);
  if (a.ctas % a.splits ||
      (a.splits > 1 ? a.ctas != tiles * a.splits : a.ctas > tiles))
    return (int)cudaErrorInvalidValue;
  err = launch_clusters(kern, dim3(a.ctas), C::THREADS, C::SMEM, a.splits,
                        st, a, tm);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int NWG, int N, bool SWAP>
int launch_hopper(const ConvArgs& a, cudaStream_t st) {
  return a.sP == 1 ? launch_hopper<NWG, N, SWAP, true>(a, st)
                   : launch_hopper<NWG, N, SWAP, false>(a, st);
}

// ----------------------------------------------------- K3, depthwise --
// The route for one channel a group (G > 1, Cg = 1, any multiplier Og,
// kernel, stride, padding and dilation).  x is K2's one-group layout of
// the G channels, (N, H, W, Ctot) with Ctot = G rounded up to 4 and
// channel c at byte c.  A CTA of 256 threads owns a tile: image n, CB =
// 32 channels (a 32-byte sector of each NHWC row) and TH x TW output
// positions (ops/int8.py int8_depthwise_plan: TW 32, 16 or 8; TH 8, or 4
// at stride 2 and TW 32; fewer rows, then channels, where a patch is
// larger than a CTA's shared memory).  It stages the tile's input patch,
// PH = (TH - 1) sh + (KH - 1) dh + 1 rows x PW = (TW - 1) sw + (KW - 1)
// dw + 1 columns, in shared memory channel-major: a channel's rows of RW
// words, P = PH * RW words a channel, odd.  A thread loads 4 positions x
// 4 channels (four 4-byte loads; the 8 lanes of a channel quad read a
// 32-byte sector of one position), every unit's loads issued before any
// is used, transposes the 4 x 4 bytes with byte permutes and stores 4
// words (P odd: a warp's 32 stores meet 32 banks); zeros outside the
// image.  At TW 32 a thread then takes a strip: one channel, 4
// consecutive output columns, the tile's TH rows.  For 3 x 3 at stride
// 1 or 2 each staged row is 2 or 3 words a strip, read once: a byte
// permute cuts each output's 3 taps out of them, and __dp4a sums them
// against the row's 3 weights packed in a word (a zero fourth byte), for
// every output row the staged row reaches; NCHW output: each row's 4
// outputs one 16-byte (8-byte for 16-bit types) store where the rows are
// a multiple of 4.  Narrower tiles (the 14^2 and 7^2 layers) and other
// kernels take strips of one column (a row of 4 columns a thread would
// scatter a warp's stores over 8-16 channels' sectors): NCHW lanes along
// the columns, each a warp-wide run of a channel's row.  Channels last:
// lanes along the channels.  The epilogue is `finish`, as the other
// routes'.
constexpr int DW_CB = 32;     // channels a tile
constexpr int DW_NT = 256;    // threads a CTA
constexpr int DW_SMEM = 232448;   // the most shared memory a CTA takes

// Bytes j .. j + 3 of the 8 bytes (lo, hi).
__device__ __forceinline__ int window(uint32_t lo, uint32_t hi, int j) {
  return (int)__byte_perm(lo, hi, 0x3210 + 0x1111 * j);
}

// Four values of OT as one store
template <typename OT, int B = sizeof(OT)> struct Vec4;
template <typename OT> struct Vec4<OT, 4> { using V = uint4; };
template <typename OT> struct Vec4<OT, 2> { using V = uint2; };

// K = 3: a 3 x 3 kernel at stride S, dilation 1, FTH output rows (the
// taps and the row walk unrolled); K = 0: any geometry, from the
// arguments.
template <typename OT, int K, int S, int FTH>
__global__ void __launch_bounds__(DW_NT, 4) conv_depthwise(const ConvArgs a) {
  extern __shared__ __align__(16) uint32_t patch[];
  constexpr bool FIXED = K > 0;
  // staging units a thread holds at once (a 3 x 3 tile's all)
  constexpr int UNITS = FIXED ? (S == 1 ? 3 : 5) : 4;
  const int KH = FIXED ? K : a.KH, KW = FIXED ? K : a.KW;
  const int sh = FIXED ? S : a.sh, sw = FIXED ? S : a.sw;
  const int dh = FIXED ? 1 : a.dh, dw = FIXED ? 1 : a.dw;
  const int TH = FIXED ? FTH : a.th, TW = a.tw, CB = a.cb;
  const int NT = blockDim.x;
  const int PH = (TH - 1) * sh + (KH - 1) * dh + 1;
  const int PW = (TW - 1) * sw + (KW - 1) * dw + 1;
  const int RW = (PW + 3) / 4;            // words of a channel's row
  const int P = (PH * RW) | 1;            // words of a channel
  const int Ctot = (a.G + 3) & ~3;
  // this CTA: tile column fastest, then tile row, channel block, image
  // (the CTAs in flight together share their halos through L2)
  const int w_tiles = (a.OW + TW - 1) / TW, h_tiles = (a.OH + TH - 1) / TH;
  const int c_tiles = (a.G + CB - 1) / CB;
  int b = blockIdx.x;
  const int tw_i = b % w_tiles;
  b /= w_tiles;
  const int th_i = b % h_tiles;
  b /= h_tiles;
  const int ct = b % c_tiles, n = b / c_tiles;
  const int oh0 = th_i * TH, ow0 = tw_i * TW, c0 = ct * CB;
  const int ih0 = oh0 * sh - a.ph, iw0 = ow0 * sw - a.pw;

  // the patch: units of 4 channels x 4 positions of a row, channel
  // quads fastest; up to UNITS units' loads in flight a thread
  const int8_t* xn = a.x + (long long)n * a.H * a.W * Ctot;
  const int CQ = CB / 4, units = PH * RW * CQ;
  for (int u0 = 0; u0 < units; u0 += UNITS * NT) {
    uint32_t v[UNITS][4];
    int dst[UNITS];
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      const int u = u0 + j * NT + threadIdx.x;
      dst[j] = -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) v[j][i] = 0;
      if (u >= units) continue;
      const int cq = u % CQ, rest = u / CQ;
      const int pq = rest % RW, pr = rest / RW;
      const int c = c0 + 4 * cq, ih = ih0 + pr;
      dst[j] = 4 * cq * P + pr * RW + pq;
      if (c >= Ctot || (unsigned)ih >= (unsigned)a.H) continue;
      const int8_t* row = xn + (long long)ih * a.W * Ctot + c;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pc = 4 * pq + i, iw = iw0 + pc;
        if (pc < PW && (unsigned)iw < (unsigned)a.W)
          v[j][i] = __ldg(reinterpret_cast<const unsigned*>(
              row + (long long)iw * Ctot));
      }
    }
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      if (dst[j] < 0) continue;
      // word k: channel 4 cq + k at the unit's 4 positions
      const uint32_t t0 = __byte_perm(v[j][0], v[j][1], 0x5140);
      const uint32_t t1 = __byte_perm(v[j][2], v[j][3], 0x5140);
      const uint32_t t2 = __byte_perm(v[j][0], v[j][1], 0x7362);
      const uint32_t t3 = __byte_perm(v[j][2], v[j][3], 0x7362);
      patch[dst[j]] = __byte_perm(t0, t1, 0x5410);
      patch[dst[j] + P] = __byte_perm(t0, t1, 0x7632);
      patch[dst[j] + 2 * P] = __byte_perm(t2, t3, 0x5410);
      patch[dst[j] + 3 * P] = __byte_perm(t2, t3, 0x7632);
    }
  }
  __syncthreads();

  const bool nchw = a.sP == 1;
  const bool bias = a.out_kind == OUT_I32 ? a.bias_i32 != nullptr
                                          : a.bias != nullptr;
  const long long row_step = (long long)a.OW * a.sP;
  OT* out = static_cast<OT*>(a.out);
  // output channel oc's scale and bias (the raw epilogue's int32 bias as
  // float bits)
  auto epilogue = [&](int oc, float& sc, float& bi) {
    if constexpr (std::is_same_v<OT, int>) {
      sc = 0.f;
      bi = __int_as_float(bias ? a.bias_i32[oc] : 0);
    } else {
      sc = a.scale[oc];
      bi = bias ? a.bias[oc] : 0.f;
    }
  };
  if constexpr (FIXED) {
    if (TW == 32) {
      // a strip of 4 columns, a thread: 3 x 3 taps by __dp4a
      const int s = threadIdx.x;
      const int g = nchw ? s % 8 : s / CB, cl = nchw ? s / 8 : s % CB;
      const int c = c0 + cl, ow = ow0 + 4 * g;
      if (s >= CB * 8 || c >= a.G || ow >= a.OW) return;
      const bool vec = nchw && a.OW % 4 == 0;
      for (int m = 0; m < a.Og; ++m) {
        const int oc = c * a.Og + m;
        const int8_t* wr = a.w + (long long)oc * a.Kp;
        float sc, bi;
        epilogue(oc, sc, bi);
        OT* dst = out + n * a.sN + oc * a.sC +
                  ((long long)oh0 * a.OW + ow) * a.sP;
        // row r's taps packed, the fourth byte 0
        int wk[3], acc[FTH][4];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          uint32_t w = 0;
#pragma unroll
          for (int q = 0; q < 3; ++q)
            w |= (uint32_t)(uint8_t)__ldg(wr + 4 * (3 * r + q)) << (8 * q);
          wk[r] = (int)w;
        }
#pragma unroll
        for (int i = 0; i < FTH; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0;
        const uint32_t* rp = patch + cl * P + S * g;
#pragma unroll
        for (int pr = 0; pr < (FTH - 1) * S + 3; ++pr) {
          // the taps of the 4 outputs: input columns S j .. S j + 2
          int win[4];
          if constexpr (S == 1) {
            const uint32_t lo = rp[0], hi = rp[1];
#pragma unroll
            for (int j = 0; j < 4; ++j) win[j] = window(lo, hi, j);
          } else {
            const uint32_t w0 = rp[0], w1 = rp[1], w2 = rp[2];
            win[0] = (int)w0;
            win[1] = window(w0, w1, 2);
            win[2] = (int)w1;
            win[3] = window(w1, w2, 2);
          }
#pragma unroll
          for (int i = 0; i < FTH; ++i) {
            const int r = pr - i * S;
            if (r >= 0 && r < 3) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = __dp4a(win[j], wk[r], acc[i][j]);
            }
          }
          rp += RW;
        }
#pragma unroll
        for (int i = 0; i < FTH; ++i) {
          if (oh0 + i >= a.OH) break;
          union {
            OT o[4];
            typename Vec4<OT>::V v;
          } y;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            y.o[j] = finish<OT>(acc[i][j], sc, bi, bias, a.relu);
          OT* d = dst + i * row_step;
          if (vec) {
            *reinterpret_cast<typename Vec4<OT>::V*>(d) = y.v;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (ow + j < a.OW) d[j * a.sP] = y.o[j];
          }
        }
      }
      return;
    }
  }
  // narrower tiles and other kernels: a strip of one column, a thread
  // (NCHW: lanes along the columns, a warp's stores runs of a row)
  for (int s = threadIdx.x; s < CB * TW; s += DW_NT) {
    const int jw = nchw ? s % TW : s / CB, cl = nchw ? s / TW : s % CB;
    const int c = c0 + cl, ow = ow0 + jw;
    if (c >= a.G || ow >= a.OW) continue;
    const int8_t* col = reinterpret_cast<const int8_t*>(patch + cl * P) +
                        jw * sw;
    for (int m = 0; m < a.Og; ++m) {
      const int oc = c * a.Og + m;
      const int8_t* wr = a.w + (long long)oc * a.Kp;
      float sc, bi;
      epilogue(oc, sc, bi);
      OT* dst = out + n * a.sN + oc * a.sC +
                ((long long)oh0 * a.OW + ow) * a.sP;
      if constexpr (FIXED) {
        int wt[9], acc[FTH];
#pragma unroll
        for (int t = 0; t < 9; ++t) wt[t] = __ldg(wr + 4 * t);
#pragma unroll
        for (int i = 0; i < FTH; ++i) acc[i] = 0;
        const int8_t* p = col;
#pragma unroll
        for (int pr = 0; pr < (FTH - 1) * S + 3; ++pr) {
          const int v0 = p[0], v1 = p[1], v2 = p[2];
#pragma unroll
          for (int i = 0; i < FTH; ++i) {
            const int r = pr - i * S;
            if (r >= 0 && r < 3)
              acc[i] += v0 * wt[3 * r] + v1 * wt[3 * r + 1] +
                        v2 * wt[3 * r + 2];
          }
          p += 4 * RW;
        }
#pragma unroll
        for (int i = 0; i < FTH; ++i)
          if (oh0 + i < a.OH)
            dst[i * row_step] = finish<OT>(acc[i], sc, bi, bias, a.relu);
      } else {
        for (int i = 0; i < TH && oh0 + i < a.OH; ++i) {
          int acc = 0;
          for (int r = 0; r < KH; ++r) {
            const int8_t* p = col + (i * sh + r * dh) * RW * 4;
            for (int q = 0; q < KW; ++q)
              acc += p[q * dw] * (int)__ldg(wr + 4 * (r * KW + q));
          }
          dst[i * row_step] = finish<OT>(acc, sc, bi, bias, a.relu);
        }
      }
    }
  }
}

template <typename OT, int K, int S, int FTH>
int launch_dw(const ConvArgs& a, int smem, cudaStream_t st) {
  auto kern = conv_depthwise<OT, K, S, FTH>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.ctas, DW_NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// 3 x 3 at stride 1 (8 rows) or 2 (4 rows at TW 32, else 8) unrolled
template <typename OT>
int launch_dw(const ConvArgs& a, int smem, cudaStream_t st) {
  if (a.KH == 3 && a.KW == 3 && a.dh == 1 && a.dw == 1 && a.sh == a.sw) {
    if (a.sh == 1 && a.th == 8) return launch_dw<OT, 3, 1, 8>(a, smem, st);
    if (a.sh == 2 && a.th == 4) return launch_dw<OT, 3, 2, 4>(a, smem, st);
    if (a.sh == 2 && a.th == 8) return launch_dw<OT, 3, 2, 8>(a, smem, st);
  }
  return launch_dw<OT, 0, 0, 0>(a, smem, st);
}

// The depthwise route's checks: one byte a group, the plan's tile (TW 8,
// 16 or 32, CB a multiple of 4 up to DW_CB) and CTAs as ops/int8.py
// int8_depthwise_plan makes them.
int launch_depthwise(const ConvArgs& a, cudaStream_t st) {
  if (a.G < 2 || a.Cgp != 1 || a.th < 1 || (a.tw != 8 && a.tw != 16 &&
      a.tw != 32) || a.cb < 4 || a.cb % 4 || a.cb > DW_CB ||
      a.sh < 1 || a.sw < 1 || a.dh < 1 || a.dw < 1 || a.ph < 0 ||
      a.pw < 0 || a.OH < 1 || a.OW < 1 || a.N < 1)
    return (int)cudaErrorInvalidValue;
  // the staged patch: CB channels of P words, P = rows x words a row, odd
  const long long ph = (long long)(a.th - 1) * a.sh + (a.KH - 1) * a.dh + 1;
  const long long pw = (long long)(a.tw - 1) * a.sw + (a.KW - 1) * a.dw + 1;
  const int cb = a.cb;
  const long long smem = 4ll * cb * ((ph * ((pw + 3) / 4)) | 1);
  const long long ctas = (long long)a.N * ((a.G + cb - 1) / cb) *
                         ((a.OH + a.th - 1) / a.th) *
                         ((a.OW + a.tw - 1) / a.tw);
  if (smem > DW_SMEM || ctas != a.ctas || ctas >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  switch (a.out_kind) {
    case OUT_F16: return launch_dw<__half>(a, (int)smem, st);
    case OUT_BF16: return launch_dw<__nv_bfloat16>(a, (int)smem, st);
    case OUT_F32: return launch_dw<float>(a, (int)smem, st);
    default: return launch_dw<int>(a, (int)smem, st);
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
// Cg): `tcb` 0 runs quantize_kernel, 16 / 32 / 64 / 128 quantize_tile
// with that tile width (ops/int8.py int8_quantize_plan).  Returns a CUDA
// error code (cudaErrorInvalidValue for bad sizes).
namespace mxq {
template <typename T>
int launch_quantize(const T* x, void* q, int N, int C, int P, int G, int Cgp,
                    int tcb, float scale, cudaStream_t st) {
  const int Cg = C / G, Ctot = G * Cgp;
  if (tcb == 0) {
    const int CW = Ctot / 4;
    const long long words = (long long)N * P * CW;
    long long blocks = (words + QNT - 1) / QNT;
    if (blocks > grid_cap()) blocks = grid_cap();
    quantize_kernel<T><<<(int)blocks, QNT, 0, st>>>(
        x, static_cast<uint32_t*>(q), words, P, C, Cg, Cgp, CW, scale);
    return (int)cudaGetLastError();
  }
  // int offsets inside an image
  if ((long long)C * P >= (1ll << 31) || (long long)P * Ctot >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  const int tp = QTILE / tcb, ptiles = (P + tp - 1) / tp;
  const long long bx = (long long)N * ptiles;
  const int by = (Ctot + tcb - 1) / tcb;
  if (bx >= (1ll << 31) || by > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = P % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  const dim3 grid((unsigned)bx, by);
  int8_t* out = static_cast<int8_t*>(q);
  switch (tcb) {
    case 16:
      quantize_tile<T, 16><<<grid, QNT, 0, st>>>(x, out, P, C, Cg, Cgp, Ctot,
                                                 ptiles, scale, vec);
      break;
    case 32:
      quantize_tile<T, 32><<<grid, QNT, 0, st>>>(x, out, P, C, Cg, Cgp, Ctot,
                                                 ptiles, scale, vec);
      break;
    case 64:
      quantize_tile<T, 64><<<grid, QNT, 0, st>>>(x, out, P, C, Cg, Cgp, Ctot,
                                                 ptiles, scale, vec);
      break;
    case 128:
      quantize_tile<T, 128><<<grid, QNT, 0, st>>>(x, out, P, C, Cg, Cgp,
                                                  Ctot, ptiles, scale, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_im2col(const T* x, void* q, const ColGeo& g, float scale,
                  cudaStream_t st) {
  const long long ctas = (long long)g.N * ((g.OH + g.TH - 1) / g.TH) *
                         ((g.OW + g.TW - 1) / g.TW);
  if (ctas >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  quantize_im2col<T><<<(unsigned)ctas, QNT, 0, st>>>(
      x, static_cast<int8_t*>(q), g, scale);
  return (int)cudaGetLastError();
}
}  // namespace mxq

extern "C" int mx_int8_quantize(const void* x, void* q, int dtype, int N,
                                int C, int P, int G, int Cgp, int tcb,
                                float scale, void* stream) {
  using namespace mxq;
  if (N <= 0 || C <= 0 || P <= 0 || G <= 0 || C % G || Cgp % 4 ||
      Cgp < C / G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F16:
      return launch_quantize(static_cast<const __half*>(x), q, N, C, P, G,
                             Cgp, tcb, scale, st);
    case BF16:
      return launch_quantize(static_cast<const __nv_bfloat16*>(x), q, N, C,
                             P, G, Cgp, tcb, scale, st);
    case F32:
      return launch_quantize(static_cast<const float*>(x), q, N, C, P, G,
                             Cgp, tcb, scale, st);
    case I8:
      return launch_quantize(static_cast<const int8_t*>(x), q, N, C, P, G,
                             Cgp, tcb, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K2's im2col mode: x (N, C, H, W) of dtype code `dtype` -> q (N * OH * OW,
// Kc) int8, `geo` the 18 ints of ColGeo.  Returns a CUDA error code.
extern "C" int mx_int8_quantize_im2col(const void* x, void* q, int dtype,
                                       const int* geo, float scale,
                                       void* stream) {
  using namespace mxq;
  ColGeo g;
  memcpy(&g, geo, sizeof g);
  for (int i = 0; i < 18; ++i)            // only the paddings may be 0
    if (geo[i] < 0 || (geo[i] == 0 && i != 9 && i != 10))
      return (int)cudaErrorInvalidValue;
  const long long PH = (long long)(g.TH - 1) * g.sh + (g.KH - 1) * g.dh + 1;
  const long long PW = (long long)(g.TW - 1) * g.sw + (g.KW - 1) * g.dw + 1;
  if (g.Cgp % 4 || g.Cgp < g.C || g.Kc % 32 || g.Kc > 4 * COL_WORDS ||
      g.Kc < g.KH * g.KW * g.Cgp || PH * PW * g.Cgp > COL_PATCH ||
      (long long)g.C * g.H * g.W >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F16:
      return launch_im2col(static_cast<const __half*>(x), q, g, scale, st);
    case BF16:
      return launch_im2col(static_cast<const __nv_bfloat16*>(x), q, g, scale,
                           st);
    case F32:
      return launch_im2col(static_cast<const float*>(x), q, g, scale, st);
    case I8:
      return launch_im2col(static_cast<const int8_t*>(x), q, g, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bytes of ConvArgs, for the host's check of its layout.
extern "C" int mx_int8_conv_args_size() { return (int)sizeof(mxq::ConvArgs); }

// K3 over one ConvArgs, on the route and plan it names.  Returns a CUDA
// error code.
extern "C" int mx_int8_conv(const void* args, int args_bytes, void* stream) {
  using namespace mxq;
  if (args_bytes != (int)sizeof(ConvArgs)) return (int)cudaErrorInvalidValue;
  ConvArgs a;
  memcpy(&a, args, sizeof(ConvArgs));
  // a group's bytes in x: a multiple of 4, or 1 on the depthwise route;
  // a tap of a weight row: the group's bytes padded to 4
  if (a.M <= 0 || a.Og <= 0 || a.G <= 0 || a.Kp <= 0 || a.Kp % BK ||
      a.Cgp <= 0 || (a.Cgp % 4 && a.route != 2) ||
      a.Kreal != a.KH * a.KW * ((a.Cgp + 3) / 4 * 4) || a.Kreal > a.Kp ||
      a.out_kind < OUT_F16 || a.out_kind > OUT_I32 ||
      (a.out_kind != OUT_I32 && !a.scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (a.route == 2) return launch_depthwise(a, st);
  if (a.route == 1) {
    // every split non-empty, at most 8 CTAs a cluster, int offsets
    if (a.G != 1 || a.Cgp % 32 || a.splits < 1 || a.splits > 8 ||
        (a.splits & (a.splits - 1)) || a.splits > (a.Kp + HBK - 1) / HBK ||
        (long long)a.N * a.H * a.W * a.Cgp >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
    switch (a.cfg) {
      case 0: return launch_hopper<2, 64, false>(a, st);
      case 1: return launch_hopper<2, 128, false>(a, st);
      case 2: return launch_hopper<1, 32, true>(a, st);
      case 3: return launch_hopper<1, 64, true>(a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (a.route != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.M + BM - 1) / BM, (a.Og + BN - 1) / BN, a.G);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  conv_kernel<<<grid, NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}
