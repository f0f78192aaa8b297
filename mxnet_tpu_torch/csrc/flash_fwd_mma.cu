// Flash-attention forward on the tensor cores for float16, bfloat16 and
// float32 at head_dim 1..128: O and the float32 lse.
//
// Replaces, for every input the Hopper kernel of flash_fwd.cu (bf16,
// head_dim 64 or 128) does not take and whose rows cp.async can copy 16
// bytes at a time, the Pallas TPU kernel `_fwd_call` of
// mxnet_tpu/ops/pallas_ops.py (:62, pallas_call at :126), and the dense
// fallback the reference takes for other dtypes and head dims.
// float64, head_dim 129..256 and rows that are not 16-byte multiples
// stay on flash_general.cu's forward.  The C interface is that of
// mx_flash_fwd_general, so the Python launcher is shared.
//
// Semantics (those of `_dense_with_lse` in ops/cuda_ops.py): a query at
// q_off + t sees a key at k_off + j iff not causal or q_off + t >=
// k_off + j (offsets read on the device); the softmax and P V run in
// float32; a row that sees no key writes O = 0 and lse = -inf.  O is
// written in the input dtype, the lse in float32.
//
// What bounds it on this card: operations.  A visible (query, key) pair
// costs 4 D flops (2 D for S, 2 D for P V); at BERT-base's float32
// shape, q/k/v (16, 12, 512, 64), that is 0.19 ms at the 67 TFLOP/s
// float32 rate of the CUDA cores.  The tensor cores run TF32, but TF32
// keeps ~3 digits, against a limit of 1e-5 of max|plain|: float32
// operands are split into two TF32 parts and each product takes three
// mma (3xTF32, mma.cuh), a floor of 3 x flops / 495 TFLOP/s (0.078 ms
// at that shape; 0.119 ms at the 323.9 TFLOP/s mma.sync reaches on an
// H100, tools/mma_peak.cu).  float16 / bfloat16 inputs are exact in
// TF32, so only the float32 P is split and S takes one mma.  Each k
// step's mma sum starts from zero and is added to its accumulator on
// the CUDA cores (mma.cuh mma3_add), as the tensor cores do not round
// their own accumulation to nearest.
//
// Design (mma.sync m16n8k8, not wgmma: TF32 wgmma wants both operands
// K-major, and V in O += P V is MN-major; an mma.sync fragment is
// loaded from shared memory in any layout).  The template is the
// backward's dq kernel (flash_bwd_mma.cu) without dP and delta:
// * A CTA of 8 warps owns 128 query rows of one head, 16 per warp (the
//   mma's m16).  Q is copied in once (cp.async); at head dims up to 32
//   its fragments are split once into registers, above that they are
//   read and split per tile (fewer registers).  K and V stream through
//   a 2-stage cp.async ring of 64 keys (32 for float32 at 128), the
//   next tile's copy in flight while the current one is computed.  A
//   float32 tile that has landed is split once into TF32 hi (in place)
//   and lo parts (mma.cuh split_tile), which the 8 warps then read.
// * Per tile and warp: S = Q K^T on the tensor cores; an online softmax
//   on the accumulator registers -- the running max of each row reduced
//   over the row's 4-lane quad, P = exp2(fma(s, scale log2 e, -m)), the
//   O accumulators rescaled, each lane's partial row sum carried and
//   reduced over the quad at the end; O += P V with P taken from the
//   accumulators as the A operand, without any exchange between lanes
//   (mma.cuh: the k slots follow the accumulator's key order).
// * Causal: a CTA stops at its last visible key tile, a warp skips a
//   tile none of whose pairs it sees, and only tiles that straddle the
//   diagonal or the ragged end are masked.  The CTAs of a head run from
//   the last row block (the most keys) to the first.
// * A head dim is padded to an instance of 16, 32, 64 or 128 columns;
//   the pad columns are zeroed once, so they add nothing to S, and are
//   never written out.  Rows are padded by 16 bytes, so the fragment
//   loads of a warp fall in 32 different banks.
// * Shared memory: 128 own rows, 4 x 64 streamed rows and, at float32,
//   the 2 x 64 rows of their lo parts: 139,264 B at float32 and head_dim
//   64 (168,960 B at 128 with 32-key tiles); one CTA an SM.  On an H100
//   at BERT's float32 shape this ran 11% faster than 4 warps a CTA with
//   32-key tiles and Q's fragments held in registers at 64 (2 CTAs an
//   SM): the split and the copy of a tile serve twice the rows.
//
// Layouts (all contiguous): q, o (B*H, T, D); k, v (B*Hkv, Tk, D); lse
// (B*H, T) float32; q_off, k_off one int32 each.

#include <limits.h>

#include "general.cuh"
#include "mma.cuh"

namespace {

using namespace mxm;

constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int BM = 16 * WARPS;      // query rows a CTA owns: 16 per warp
constexpr float LN2 = 0.6931471805599453f;

// An instance: element type T, head dim padded to DP.
template <typename T, int DP> struct Geo {
  static constexpr bool SPLIT = sizeof(T) == 4;        // float32: 3xTF32
  static constexpr bool QREG = DP <= 32;    // Q's fragments in registers
  // streamed keys a tile: 64, or 32 where float32 at 128 would not fit
  static constexpr int BN = SPLIT && DP == 128 ? 32 : 64;
  static constexpr int LD = DP + 16 / (int)sizeof(T);  // padded row
  // BM rows of Q, 2 stages x 2 x BN rows of K and V, for float32 the lo
  // parts of the current K and V tile
  static constexpr int ROWS = BM + 4 * BN + (SPLIT ? 2 * BN : 0);
  static constexpr size_t bytes = (size_t)ROWS * LD * sizeof(T);
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT, 1) fwd_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_off, const int* __restrict__ k_off,
    T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int Tq,
    int Tk, int D, float scale, int causal) {
  using G = Geo<T, DP>;
  constexpr int LD = G::LD, BN = G::BN, NN = BN / 8, ND = DP / 8;
  constexpr bool SPLIT = G::SPLIT, QREG = G::QREG;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BM * LD;             // [2][BN][LD]
  T* vs = ks + 2 * BN * LD;         // [2][BN][LD]
  float* kl = reinterpret_cast<float*>(vs + 2 * BN * LD);   // float32 only
  float* vl = kl + BN * LD;

  const int nblk = (Tq + BM - 1) / BM;
  const int bh = blockIdx.x / nblk;
  const int t0 = (nblk - 1 - (int)(blockIdx.x % nblk)) * BM;
  const int b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long qo = q_off[0], ko = k_off[0];
  const T* kb = k + (size_t)bkv * Tk * D;
  const T* vb = v + (size_t)bkv * Tk * D;

  zero_cols<T, NT>(qs, G::ROWS, LD, D, DP);
  copy_rows<T, NT>(qs, LD, q + (size_t)bh * Tq * D, D, t0, BM, Tq);
  cp_async_commit();
  int kend = Tk;
  if (causal) {
    const long long last_q = qo + min(t0 + BM, Tq) - 1;
    kend = (int)max(0LL, min((long long)Tk, last_q - ko + 1));
  }
  const int nt = (kend + BN - 1) / BN;
  auto load_kv = [&](int it, int st) {
    copy_rows<T, NT>(ks + st * BN * LD, LD, kb, D, it * BN, BN, Tk);
    copy_rows<T, NT>(vs + st * BN * LD, LD, vb, D, it * BN, BN, Tk);
    cp_async_commit();
  };
  if (nt > 0) load_kv(0, 0);
  if (nt > 0)
    cp_async_wait<1>();          // Q has landed; K / V may not
  else
    cp_async_wait<0>();
  __syncthreads();

  const int wr0 = t0 + 16 * warp;          // the warp's first row
  const int wlast = min(wr0 + 15, Tq - 1);  // the warp's last real row
  // Q's A fragments, split once, where they fit in registers
  uint32_t qh[QREG ? ND : 1][4], ql[QREG ? ND : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      float x[4];
      load_a(qs, LD, 16 * warp, 8 * kk, x);
      make<T>(x, qh[kk], ql[kk]);
    }
  }
  const float sl2 = scale * LOG2E;
  // rows g and g + 8 of the warp: running max of s * scale * log2(e)
  // and this lane's partial sum of P
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int st = it & 1;
    if (it + 1 < nt) {
      load_kv(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = it * BN;
    T* kt = ks + st * BN * LD;
    T* vt = vs + st * BN * LD;
    if constexpr (SPLIT) {
      split_tile<T, NT>(kt, kl, LD, BN, DP);
      split_tile<T, NT>(vt, vl, LD, BN, DP);
      __syncthreads();
    }
    if (wr0 < Tq && (!causal || qo + wlast >= ko + j0)) {
      float s[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
      // S = Q K^T
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        uint32_t ah[4], al[4];
        if constexpr (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = qh[kk][i];
            al[i] = ql[kk][i];
          }
        } else {
          float x[4];
          load_a(qs, LD, 16 * warp, 8 * kk, x);
          make<T>(x, ah, al);
        }
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          uint32_t bh_[2], bl_[2];
          frag_bt(kt, kl, LD, 8 * n, 8 * kk, bh_, bl_);
          mma3_add<SPLIT, SPLIT>(s[n], ah, al, bh_, bl_);
        }
      }
      // the visible pairs (bit 4 n + i), all of them off the edge tiles
      static_assert(4 * NN <= 32, "one bit a pair of the lane's");
      unsigned vis = 4 * NN == 32 ? ~0u : (1u << (4 * NN)) - 1u;
      if (j0 + BN > Tk || (causal && qo + wr0 < ko + j0 + BN - 1)) {
        vis = 0u;
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = j0 + 8 * n + 2 * tq + (i & 1);
            const int t = wr0 + g + 8 * (i >> 1);
            if (j < Tk && (!causal || qo + t >= ko + j))
              vis |= 1u << (4 * n + i);
          }
      }
      // online softmax: the rows' new max over the quad, the rescale of
      // O and of the partial sums, P in place of S
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (vis >> (4 * n + i) & 1u)
            mt[i >> 1] = fmaxf(mt[i >> 1], s[n][i] * sl2);
      float ms[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(mxg::FULL, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(mxg::FULL, mt[r], 2));
        ms[r] = mt[r] == -INFINITY ? 0.f : mt[r];
        corr[r] = exp2_(m[r] - ms[r]);     // 0 while a row saw no key
        m[r] = mt[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = (vis >> (4 * n + i) & 1u)
                              ? exp2_(fmaf(s[n][i], sl2, -ms[i >> 1]))
                              : 0.f;
          s[n][i] = p;
          l[i >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] *= corr[i >> 1];
      // O += P V
#pragma unroll
      for (int kk = 0; kk < NN; ++kk) {
        const float x[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        uint32_t ph[4], pl[4];
        make<float>(x, ph, pl);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bh_[2], bl_[2];
          frag_b_pair(vt, vl, LD, 8 * kk, 8 * n, bh_, bl_);
          mma3_add<true, SPLIT>(acc[n], ph, pl, bh_, bl_);
        }
      }
    }
    __syncthreads();    // the stage is refilled in the next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(mxg::FULL, l[r], 1);
    l[r] += __shfl_xor_sync(mxg::FULL, l[r], 2);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = wr0 + g + 8 * hf;
    if (t >= Tq) continue;
    const size_t row = (size_t)bh * Tq + t;
    const float L = l[hf];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 8 * n + 2 * tq;
      if (c < D)
        store2(o + row * D + c, L == 0.f ? 0.f : acc[n][2 * hf] / L,
               L == 0.f ? 0.f : acc[n][2 * hf + 1] / L);
    }
    if (tq == 0)
      lse[row] = L == 0.f ? -INFINITY : (m[hf] + log2f(L)) * LN2;
  }
}

template <typename T, int DP>
int launch_fwd(const void* q, const void* k, const void* v, const int* qo,
               const int* ko, void* o, float* lse, int B, int H, int Hkv,
               int Tq, int Tk, int D, double scale, int causal,
               cudaStream_t s) {
  const size_t smem = Geo<T, DP>::bytes;
  auto kern = fwd_mma_kernel<T, DP>;
  cudaError_t err = mxg::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((Tq + BM - 1) / BM);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qo, ko, static_cast<T*>(o), lse, H, Hkv, Tq,
      Tk, D, (float)scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// o (B*H, T, D) in the input dtype and lse (B*H, T) float32.
extern "C" int mx_flash_fwd_mma(const void* q, const void* k, const void* v,
                                const void* q_off, const void* k_off,
                                void* o, void* lse, int B, int H, int Hkv,
                                int Tq, int Tk, int D, double scale,
                                int causal, int dtype, void* stream) {
  if (!inputs_ok(B, H, Hkv, Tq, Tk, D, dtype, q, k, v, nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return MXM_DISPATCH(dtype, D, launch_fwd, q, k, v,
                      static_cast<const int*>(q_off),
                      static_cast<const int*>(k_off), o,
                      static_cast<float*>(lse), B, H, Hkv, Tq, Tk, D, scale,
                      causal, s);
}
