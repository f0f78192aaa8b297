// Flash-attention backward on the tensor cores for float16, bfloat16
// and float32 at head_dim 1..128: dq (with the delta pass) and dk/dv.
//
// Replaces, for every input the Hopper kernels of flash_bwd.cu (bf16,
// head_dim 64 or 128) do not take and whose rows cp.async can copy 16
// bytes at a time, the Pallas TPU kernels of
// mxnet_tpu/ops/pallas_ops.py: `_bwd_dq_call` (:149, pallas_call at
// :208) with the delta of `_flash_lse_bwd` (:351), and `_bwd_dkv_call`
// (:227 / :307).  float64, head_dim 129..256 and rows that are not
// 16-byte multiples stay on flash_general.cu's dq / dk/dv kernels.
// The C interface is that of mx_flash_bwd_dq_general /
// mx_flash_bwd_dkv_general, so the Python launcher is shared.
//
// Semantics (those of `_flash_bwd_dense` in ops/cuda_ops.py): P =
// exp(s * scale - lse) with a -inf lse read as 0 and masked pairs 0;
// dS = P o (dP - delta) * scale; dq = dS K, dk = dS^T Q, dv = P^T dO,
// the GQA group's query heads summed; outputs in float32.  A query at
// q_off + t sees a key at k_off + j iff not causal or q_off + t >=
// k_off + j (offsets read on the device).
//
// What bounds it on this card: operations.  At BERT's float32 shape a
// visible (query, key) pair costs 6 D flops for dq and 8 D for dk/dv;
// on the CUDA cores (flash_general.cu) that is 67 TFLOP/s at best.
// The tensor cores run TF32 at 495 TFLOP/s, but TF32 keeps ~3 digits,
// against a limit of 1e-5 of max|plain| on the backward.  So float32
// operands are split into two TF32 parts and each product takes three
// mma (3xTF32, mma.cuh): a floor of 3 x flops / 495 TFLOP/s, 2.5x
// below the float32 FLOP bound.  float16 / bfloat16 inputs are exact
// in TF32; only the float32 P and dS are split.  The tensor cores'
// accumulation is not rounded to nearest, so each k step's mma sum
// starts from zero and is added to its accumulator on the CUDA cores
// (mma.cuh mma3_add).  Measured on an H100 at BERT's shape, the time
// goes to issuing the mma (one pass instead of three halves it), the
// TF32 splits and those adds, with 8 warps on an SM.
//
// Design (mma.sync m16n8k8, not wgmma: TF32 wgmma wants both operands
// K-major, and dq = dS K, dk = dS^T Q, dv = P^T dO read MN-major ones;
// an mma.sync fragment is loaded from shared memory in any layout):
// * dq: a CTA of 4 warps owns 64 query rows of one head, 16 per warp
//   (the mma's m16).  Q and dO are copied in once (cp.async); K and V
//   stream through a 2-stage cp.async ring of 32 keys, the next tile's
//   copy in flight while the current one is computed.  A float32 tile
//   that has landed is split once into TF32 hi (in place) and lo parts
//   (mma.cuh split_tile), which the 4 warps then read.  Per tile and
//   warp: S = Q K^T and dP = dO V^T on the tensor cores; P and dS in
//   the accumulator registers; dQ += dS K, with dS taken from the
//   accumulators as the A operand without any exchange between lanes
//   (mma.cuh: the k slots follow the accumulator's key order).  delta =
//   rowsum(dO o O) - dlse is computed in the same launch when O is
//   given and written out for dk/dv, else read.
// * dk/dv: a CTA owns 64 keys (16 per warp) and keeps K and V; it loops
//   over the `rep` query heads of its GQA group, then over 32-query
//   tiles of Q, dO, lse and delta in a 2-stage ring, split as above:
//   S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.
//   The heads are summed in registers in a fixed order: no atomics, so
//   two calls give the same bits.
// * Causal: dq stops at its CTA's last visible key tile and dk/dv starts
//   at its first visible query; a warp skips a tile none of whose pairs
//   it sees, and masks only tiles that straddle the diagonal or the
//   ragged end.  dq runs its CTAs from the last row block (the most
//   keys) to the first, dk/dv from the first key block.
// * A head dim is padded to an instance of 16, 32, 64 or 128 columns;
//   the pad columns are zeroed once, so they add nothing to S or dP, and
//   are never written out.  Rows are padded by 16 bytes, so each row
//   starts 4 banks after the last and the fragment loads of a warp fall
//   in 32 different banks.
// * Shared memory: 2 x 64 own rows, 4 x 32 streamed rows and, at
//   float32, the 2 x 32 rows of their lo parts: 87,552 B at float32
//   and head_dim 64, 169,472 B at 128.  Registers (255 at most, two
//   CTAs of 4 warps on an SM) bound the occupancy.  On the card a
//   32-row tile ran faster than 64 rows, 3 or 4 CTAs an SM (fewer
//   registers, 16-row tiles) slower than 2, and the S / dP loop over
//   the head dim unrolled by 2 and dV, dK summed one after the other
//   (fewer live registers, fewer spills) faster than fully unrolled.
//
// Layouts (all contiguous): q, o, do, dq (B*H, T, D); k, v, dk, dv
// (B*Hkv, Tk, D); lse, delta, dlse (B*H, T) float32; q_off, k_off one
// int32 each.

#include <limits.h>

#include "general.cuh"
#include "mma.cuh"

namespace {

using namespace mxm;

constexpr int WARPS = 4;
constexpr int NT = WARPS * 32;
constexpr int BM = 16 * WARPS;      // rows a CTA owns: 16 per warp

// An instance: element type T, head dim padded to DP.
template <typename T, int DP> struct Geo {
  static constexpr bool SPLIT = sizeof(T) == 4;        // float32: 3xTF32
  static constexpr int LD = DP + 16 / (int)sizeof(T);  // padded row
  static constexpr int BN = 32;                       // streamed rows
  // 2 x BM own rows, 2 stages x 2 x BN streamed rows, for float32 the
  // lo parts of the current 2 x BN, then 2 x BM floats: dq's lse and
  // delta of its rows, or dk/dv's 2 stages x 2 x BN of the queries'
  static constexpr int ROWS = 2 * BM + 4 * BN + (SPLIT ? 2 * BN : 0);
  static constexpr size_t bytes =
      (size_t)ROWS * LD * sizeof(T) + 2 * BM * sizeof(float);
  static_assert(4 * BN <= 2 * BM, "dk/dv's lse and delta stages");
};

// The float32 lse as the backward reads it: -inf as 0 (pallas_ops.py
// :174, :256), times log2(e) for exp2.
__device__ __forceinline__ float lse_log2(float l) {
  return (isinf(l) && l < 0) ? 0.f : l * LOG2E;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT, 2) dq_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const T* __restrict__ o,
    const float* __restrict__ lse, const float* __restrict__ dlse,
    float* __restrict__ delta, const int* __restrict__ q_off,
    const int* __restrict__ k_off, float* __restrict__ dq, int H, int Hkv,
    int Tq, int Tk, int D, float scale, int causal) {
  using G = Geo<T, DP>;
  constexpr int LD = G::LD, BN = G::BN, NN = BN / 8, ND = DP / 8;
  constexpr bool SPLIT = G::SPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + BM * LD;
  T* ks = dos + BM * LD;            // [2][BN][LD]
  T* vs = ks + 2 * BN * LD;         // [2][BN][LD]
  float* kl = reinterpret_cast<float*>(vs + 2 * BN * LD);   // float32 only
  float* vl = kl + BN * LD;
  float* rowL = reinterpret_cast<float*>(qs + G::ROWS * LD);
  float* rowD = rowL + BM;

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
  copy_rows<T, NT>(dos, LD, dout + (size_t)bh * Tq * D, D, t0, BM, Tq);
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

  // lse and delta of the warp's 16 rows; delta from dO o O when O is
  // given (rounded to float32 as stored, and used as read back)
  if (nt > 0)
    cp_async_wait<1>();          // Q and dO have landed; K / V may not
  else
    cp_async_wait<0>();
  __syncthreads();
  const int wr0 = t0 + 16 * warp;          // the warp's first row
  for (int r = 0; r < 16; ++r) {
    const int t = wr0 + r;
    float L = 0.f, dl = 0.f;
    if (t < Tq) {
      const size_t row = (size_t)bh * Tq + t;
      if (o != nullptr) {
        float part = 0.f;
        for (int d = lane; d < D; d += 32)
          part += to_f(dos[(16 * warp + r) * LD + d]) * to_f(o[row * D + d]);
        dl = mxg::warp_sum(part) - (dlse != nullptr ? dlse[row] : 0.f);
        if (lane == 0) delta[row] = dl;
      } else {
        dl = delta[row];
      }
      L = lse_log2(lse[row]);
    }
    if (lane == 0) {
      rowL[16 * warp + r] = L;
      rowD[16 * warp + r] = dl;
    }
  }
  __syncwarp();
  float Lr[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    Lr[i] = rowL[16 * warp + g + 8 * i];
    Dr[i] = rowD[16 * warp + g + 8 * i];
  }
  const float sl2 = scale * LOG2E;
  const int wlast = min(wr0 + 15, Tq - 1);  // the warp's last real row

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
      float s[NN][4], dp[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
      // S = Q K^T, dP = dO V^T
#pragma unroll 2
      for (int kk = 0; kk < ND; ++kk) {
        float x[4];
        uint32_t qh[4], ql[4], oh[4], ol[4];
        load_a(qs, LD, 16 * warp, 8 * kk, x);
        make<T>(x, qh, ql);
        load_a(dos, LD, 16 * warp, 8 * kk, x);
        make<T>(x, oh, ol);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          uint32_t bh_[2], bl_[2];
          frag_bt(kt, kl, LD, 8 * n, 8 * kk, bh_, bl_);
          mma3_add<SPLIT, SPLIT>(s[n], qh, ql, bh_, bl_);
          frag_bt(vt, vl, LD, 8 * n, 8 * kk, bh_, bl_);
          mma3_add<SPLIT, SPLIT>(dp[n], oh, ol, bh_, bl_);
        }
      }
      // P, then dS in place of S
      const bool edge = j0 + BN > Tk ||
                        (causal && qo + wr0 < ko + j0 + BN - 1);
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = exp2_(fmaf(s[n][i], sl2, -Lr[i >> 1]));
          if (edge) {
            const int j = j0 + 8 * n + 2 * tq + (i & 1);
            const int t = wr0 + g + 8 * (i >> 1);
            if (j >= Tk || (causal && qo + t < ko + j)) p = 0.f;
          }
          s[n][i] = p * (dp[n][i] - Dr[i >> 1]) * scale;
        }
      // dQ += dS K
#pragma unroll
      for (int kk = 0; kk < NN; ++kk) {
        const float x[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        uint32_t ah[4], al[4];
        make<float>(x, ah, al);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bh_[2], bl_[2];
          frag_b_pair(kt, kl, LD, 8 * kk, 8 * n, bh_, bl_);
          mma3_add<true, SPLIT>(acc[n], ah, al, bh_, bl_);
        }
      }
    }
    __syncthreads();    // the stage is refilled in the next iteration
  }

#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = wr0 + g + 8 * hf, c = 8 * n + 2 * tq;
      if (t < Tq && c < D)
        *reinterpret_cast<float2*>(dq + ((size_t)bh * Tq + t) * D + c) =
            make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
    }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT, 2) dkv_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ q_off,
    const int* __restrict__ k_off, float* __restrict__ dk,
    float* __restrict__ dv, int H, int Hkv, int Tq, int Tk, int D,
    float scale, int causal) {
  using G = Geo<T, DP>;
  constexpr int LD = G::LD, BQ = G::BN, NQ = BQ / 8, ND = DP / 8;
  constexpr bool SPLIT = G::SPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BM * LD;
  T* qs = vs + BM * LD;             // [2][BQ][LD]
  T* dos = qs + 2 * BQ * LD;        // [2][BQ][LD]
  float* ql = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // float32 only
  float* dol = ql + BQ * LD;
  float* ls = reinterpret_cast<float*>(ks + G::ROWS * LD);  // [2][BQ]
  float* dls = ls + 2 * BQ;                                 // [2][BQ]

  const int nblk = (Tk + BM - 1) / BM;
  const int bkv = blockIdx.x / nblk;
  const int j0 = (int)(blockIdx.x % nblk) * BM;
  const int b = bkv / Hkv, gh = bkv % Hkv, rep = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long qo = q_off[0], ko = k_off[0];

  zero_cols<T, NT>(ks, G::ROWS, LD, D, DP);
  copy_rows<T, NT>(ks, LD, k + (size_t)bkv * Tk * D, D, j0, BM, Tk);
  copy_rows<T, NT>(vs, LD, v + (size_t)bkv * Tk * D, D, j0, BM, Tk);
  cp_async_commit();
  // causal: the first query that sees the CTA's first key
  const int tstart =
      causal ? (int)min((long long)Tq, max(0LL, ko + j0 - qo)) : 0;
  const int ntq = (Tq - tstart + BQ - 1) / BQ;
  const int total = rep * ntq;
  auto load_q = [&](int it, int st) {
    const int t0 = tstart + (it % ntq) * BQ;
    const size_t bh = (size_t)b * H + gh * rep + it / ntq;
    copy_rows<T, NT>(qs + st * BQ * LD, LD, q + bh * Tq * D, D, t0, BQ, Tq);
    copy_rows<T, NT>(dos + st * BQ * LD, LD, dout + bh * Tq * D, D, t0, BQ,
                     Tq);
    if (threadIdx.x < 2 * BQ) {
      const int i = threadIdx.x % BQ;
      const bool in = t0 + i < Tq;
      const float* src = threadIdx.x < BQ ? lse : delta;
      cp_async4((threadIdx.x < BQ ? ls : dls) + st * BQ + i,
                src + (in ? bh * Tq + t0 + i : 0), in ? 4 : 0);
    }
    cp_async_commit();
  };
  if (total > 0) load_q(0, 0);

  const int wk0 = j0 + 16 * warp;          // the warp's first key
  const float sl2 = scale * LOG2E;
  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) adk[n][i] = adv[n][i] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    if (it + 1 < total) {
      load_q(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = tstart + (it % ntq) * BQ;
    T* qt = qs + st * BQ * LD;
    T* dot = dos + st * BQ * LD;
    if constexpr (SPLIT) {
      split_tile<T, NT>(qt, ql, LD, BQ, DP);
      split_tile<T, NT>(dot, dol, LD, BQ, DP);
      __syncthreads();
    }
    if (wk0 < Tk && (!causal || qo + min(t0 + BQ, Tq) - 1 >= ko + wk0)) {
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
      // S^T = K Q^T, dP^T = V dO^T
#pragma unroll 2
      for (int kk = 0; kk < ND; ++kk) {
        float x[4];
        uint32_t kh[4], kl[4], vh[4], vl[4];
        load_a(ks, LD, 16 * warp, 8 * kk, x);
        make<T>(x, kh, kl);
        load_a(vs, LD, 16 * warp, 8 * kk, x);
        make<T>(x, vh, vl);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t bh_[2], bl_[2];
          frag_bt(qt, ql, LD, 8 * n, 8 * kk, bh_, bl_);
          mma3_add<SPLIT, SPLIT>(s[n], kh, kl, bh_, bl_);
          frag_bt(dot, dol, LD, 8 * n, 8 * kk, bh_, bl_);
          mma3_add<SPLIT, SPLIT>(dp[n], vh, vl, bh_, bl_);
        }
      }
      // P^T into s, dS^T into dp; rows are keys, columns queries
      const bool edge = t0 + BQ > Tq ||
                        (causal && qo + t0 < ko + wk0 + 15);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int c = 8 * n + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + st * BQ + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + st * BQ + c);
        const float L[2] = {lse_log2(l2.x), lse_log2(l2.y)};
        const float Dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = exp2_(fmaf(s[n][i], sl2, -L[i & 1]));
          if (edge) {
            const int t = t0 + c + (i & 1);
            const int j = wk0 + g + 8 * (i >> 1);
            if (t >= Tq || (causal && qo + t < ko + j)) p = 0.f;
          }
          s[n][i] = p;
          dp[n][i] = p * (dp[n][i] - Dl[i & 1]) * scale;
        }
      }
      // dV += P^T dO, then dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        const float xp[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        uint32_t ph[4], pl[4];
        make<float>(xp, ph, pl);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bh_[2], bl_[2];
          frag_b_pair(dot, dol, LD, 8 * kk, 8 * n, bh_, bl_);
          mma3_add<true, SPLIT>(adv[n], ph, pl, bh_, bl_);
        }
      }
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        const float xs[4] = {dp[kk][0], dp[kk][2], dp[kk][1], dp[kk][3]};
        uint32_t sh[4], sl[4];
        make<float>(xs, sh, sl);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bh_[2], bl_[2];
          frag_b_pair(qt, ql, LD, 8 * kk, 8 * n, bh_, bl_);
          mma3_add<true, SPLIT>(adk[n], sh, sl, bh_, bl_);
        }
      }
    }
    __syncthreads();    // the stage is refilled in the next iteration
  }
  cp_async_wait<0>();   // K and V when no query tile ran

#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = wk0 + g + 8 * hf, c = 8 * n + 2 * tq;
      if (j < Tk && c < D) {
        const size_t at = ((size_t)bkv * Tk + j) * D + c;
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(adk[n][2 * hf], adk[n][2 * hf + 1]);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(adv[n][2 * hf], adv[n][2 * hf + 1]);
      }
    }
}

template <typename T, int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* o, const float* lse, const float* dlse,
              float* delta, const int* qo, const int* ko, void* dq, int B,
              int H, int Hkv, int Tq, int Tk, int D, double scale, int causal,
              cudaStream_t s) {
  const size_t smem = Geo<T, DP>::bytes;
  auto kern = dq_mma_kernel<T, DP>;
  cudaError_t err = mxg::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((Tq + BM - 1) / BM);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const T*>(o), lse, dlse, delta, qo, ko,
      static_cast<float*>(dq), H, Hkv, Tq, Tk, D, (float)scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* qo,
               const int* ko, void* dk, void* dv, int B, int H, int Hkv,
               int Tq, int Tk, int D, double scale, int causal,
               cudaStream_t s) {
  const size_t smem = Geo<T, DP>::bytes;
  auto kern = dkv_mma_kernel<T, DP>;
  cudaError_t err = mxg::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * Hkv * ((Tk + BM - 1) / BM);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, qo,
      ko, static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, Tq, Tk,
      D, (float)scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dq (B*H, T, D) float32.  With `o` (non-null) delta = rowsum(dO o O) -
// dlse (`dlse` may be null) is computed for each row and written into
// `delta`; with `o` null `delta` is read.
extern "C" int mx_flash_bwd_dq_mma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* o, const void* lse, const void* dlse, void* delta,
    const void* q_off, const void* k_off, void* dq, int B, int H, int Hkv,
    int Tq, int Tk, int D, double scale, int causal, int dtype,
    void* stream) {
  if (!inputs_ok(B, H, Hkv, Tq, Tk, D, dtype, q, k, v, dout))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return MXM_DISPATCH(dtype, D, launch_dq, q, k, v, dout, o,
                      static_cast<const float*>(lse),
                      static_cast<const float*>(dlse),
                      static_cast<float*>(delta),
                      static_cast<const int*>(q_off),
                      static_cast<const int*>(k_off), dq, B, H, Hkv, Tq, Tk,
                      D, scale, causal, s);
}

// dk, dv (B*Hkv, Tk, D) float32, the GQA group's query heads summed.
extern "C" int mx_flash_bwd_dkv_mma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* q_off, const void* k_off,
    void* dk, void* dv, int B, int H, int Hkv, int Tq, int Tk, int D,
    double scale, int causal, int dtype, void* stream) {
  if (!inputs_ok(B, H, Hkv, Tq, Tk, D, dtype, q, k, v, dout))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tk == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return MXM_DISPATCH(dtype, D, launch_dkv, q, k, v, dout,
                      static_cast<const float*>(lse),
                      static_cast<const float*>(delta),
                      static_cast<const int*>(q_off),
                      static_cast<const int*>(k_off), dk, dv, B, H, Hkv, Tq,
                      Tk, D, scale, causal, s);
}
