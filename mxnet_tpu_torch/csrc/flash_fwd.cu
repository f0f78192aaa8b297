// Flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel `_fwd_call` in
// mxnet_tpu/ops/pallas_ops.py (its pallas_call at :126): causal or
// non-causal attention with an online softmax, returning O in the input
// dtype and the per-row logsumexp in fp32 (-inf, with O = 0, on a row
// that sees no key; the backward kernels depend on both).  GQA: query
// row bh reads kv row bh / rep, so the repeated K/V never exist in
// memory.  The causal mask is built from the runtime offsets q_off[0] /
// k_off[0] (device int32 tensors, read here, because the ring passes
// offsets that change each step), and key tiles wholly in a query
// tile's future are never loaded.
//
// What bounds it on this card: the work is 4*D flops per visible
// (query, key) pair and head against (Q + O + K + V) bytes plus the lse,
// so the intensity grows with T.  With 32 query heads over 8 kv heads
// at D = 128, a causal T = 512 prefill (the serving ladder's top rung)
// is ~2.15 GFLOP over ~10.55 MB, ~204 flop/byte, below the H100's ~295
// flop/byte ridge: the prefill rungs are bound by bytes.  The training
// shape (B = 2, causal T = 1024) and anything longer is bound by
// tensor-core operations.
//
// What the design does about it:
// * K/V arrive by TMA into a ring of NSTAGES tiles in dynamic shared
//   memory, each stage guarded by a "full" and an "empty" mbarrier.  One
//   producer warp (one thread of it) keeps the next tiles' loads in
//   flight while the consumer warpgroup computes; Q comes the same way
//   once.  The tensor maps are 3-D over (heads, rows, D), so a ragged T
//   or Tk edge is zero-filled by the hardware instead of reading the
//   next head's rows.  A tile is D / 64 boxes of 64 rows x 64 columns
//   (128 bytes) in the 128-byte swizzle that wgmma reads.  The maps are
//   encoded on the host in the C entry point; cuTensorMapEncodeTiled is
//   reached through cudaGetDriverEntryPoint, so the build links no
//   -lcuda.  These helpers live in hopper.cuh, shared with flash_bwd.cu.
// * Both products run on wgmma.  S = Q K^T (m64n64k16) reads Q and K
//   from shared memory, both K-major.  O += P V (m64nDk16) takes P from
//   registers as the A operand -- the S accumulator repacked to bf16 in
//   place, as in FlashAttention-2 -- and reads V from shared memory as
//   MN-major with the transpose bit set, so no transposed copy of V is
//   ever made.
// * One consumer warpgroup owns a 64-row query tile.  A 128-row tile
//   (two consumer warpgroups) would give 128 CTAs at the serving shape,
//   fewer than the 132 SMs; with 64 rows the grid is 256 CTAs there and
//   two CTAs share an SM (82 KB of shared memory each), so one CTA's
//   softmax overlaps the other's products.
// * The online softmax runs in exp2f with scale * log2(e) folded into
//   the scores once, and keeps the row statistics in the wgmma
//   accumulator layout (each row lives in one quad of lanes, so a max or
//   sum needs two shuffles; the row sum is reduced once, at the end).
// * Heaviest causal tiles first: the query tile index is the slow grid
//   dimension and runs in reverse, so the tiles with the most keys are
//   dispatched in the first wave and the cheap ones fill the tail.
//
// Shapes: any T and Tk, D in {64, 128}, H % Hkv == 0.  Layouts: q (BH,
// T, D), k/v (BHkv, Tk, D), o (BH, T, D), lse (BH, T), all contiguous
// with 16-byte aligned bases.

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;                     // query rows per CTA
constexpr int BK = 64;                     // keys per K/V tile
constexpr int NSTAGES = 2;                 // K/V ring depth
constexpr int NCONSUMER = 128;             // one warpgroup
constexpr int NTHREADS = NCONSUMER + 32;   // + the producer warp

template <int D>
struct Smem {
  alignas(1024) __nv_bfloat16 q[BQ * D];
  alignas(1024) __nv_bfloat16 k[NSTAGES][BK * D];
  alignas(1024) __nv_bfloat16 v[NSTAGES][BK * D];
  uint64_t q_full, full[NSTAGES], empty[NSTAGES];
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const int* __restrict__ q_off_p,
                 const int* __restrict__ k_off_p,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int rep, int T, int Tk, float scale_log2, int causal) {
  constexpr int NB = D / 64;               // 64-column boxes per row
  constexpr int KV_BYTES = 2 * BK * D * 2; // one stage: a K and a V tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      smem_raw + (((raw + 1023u) & ~1023u) - raw));

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int bkv = bh / rep;
  const int row0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q_off = q_off_p[0], k_off = k_off_p[0];

  // key tiles to visit: all of them, or up to the causal bound of the
  // last real row of this query tile
  const int nk = (Tk + BK - 1) / BK;
  int upper = nk;
  if (causal) {
    const int diff = q_off + min(row0 + BQ, T) - 1 - k_off;
    upper = diff < 0 ? 0 : min(diff / BK + 1, nk);
  }

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < NSTAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCONSUMER / 32) {
    // ---- producer: one thread keeps the ring full
    if (lane == 0 && upper > 0) {
      mbar_expect_tx(&sm.q_full, BQ * D * 2);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        tma_load_3d(sm.q + b * BOX, &tm_q, &sm.q_full, b * 64, row0, bh);
      for (int kt = 0; kt < upper; ++kt) {
        const int st = kt % NSTAGES;
        if (kt >= NSTAGES) mbar_wait(&sm.empty[st], (kt / NSTAGES - 1) & 1);
        mbar_expect_tx(&sm.full[st], KV_BYTES);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(sm.k[st] + b * BOX, &tm_k, &sm.full[st], b * 64,
                      kt * BK, bkv);
          tma_load_3d(sm.v[st] + b * BOX, &tm_v, &sm.full[st], b * 64,
                      kt * BK, bkv);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: rows warp * 16 + g and + 8 of the tile
  const int g = lane >> 2, tig = lane & 3;
  const int qrow[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};   // log2 domain
  float l_i[2] = {0.f, 0.f};               // this thread's share of the row

  if (upper > 0) mbar_wait(&sm.q_full, 0);
  for (int kt = 0; kt < upper; ++kt) {
    const int st = kt % NSTAGES;
    const int key0 = kt * BK;
    mbar_wait(&sm.full[st], (kt / NSTAGES) & 1);

    // S = Q K^T: D / 16 k-steps, 16 columns (32 bytes) each
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * BOX + (kk % 4) * 16;
      wgmma_ss_n64(s, sw128_desc(sm.q + off, 16, 1024),
                   sw128_desc(sm.k[st] + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // scale into the log2 domain, mask the causal and ragged edges.
    // Accumulator element i: row half h = (i >> 1) & 1, key
    // 8 * (i >> 2) + 2 * tig + (i & 1).
    const bool edge = key0 + BK > Tk ||
                      (causal && k_off + key0 + BK - 1 > q_off + row0);
    float mcur[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      float val = s[i] * scale_log2;
      if (edge) {
        const int key = key0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        bool ok = key < Tk;
        if (causal) ok = ok && (q_off + qrow[h] >= k_off + key);
        val = ok ? val : -INFINITY;
      }
      s[i] = val;
      mcur[h] = fmaxf(mcur[h], val);
    }
    float alpha[2], msafe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mcur[h] = fmaxf(mcur[h], __shfl_xor_sync(0xffffffff, mcur[h], 1));
      mcur[h] = fmaxf(mcur[h], __shfl_xor_sync(0xffffffff, mcur[h], 2));
      const float mnew = fmaxf(m_i[h], mcur[h]);
      msafe[h] = mnew == -INFINITY ? 0.f : mnew;
      alpha[h] = m_i[h] == -INFINITY ? 0.f : exp2f(m_i[h] - msafe[h]);
      m_i[h] = mnew;
      l_i[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      const float p = exp2f(s[i] - msafe[h]);   // 0 on a masked key
      s[i] = p;
      l_i[h] += p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: accumulator n-tiles 2kk, 2kk + 1 of S are the bf16 A
    // fragment of k-step kk; V's keys 16kk .. 16kk + 15 start 16 rows
    // (2048 bytes) further into the stage
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<D>(acc, pa[kk],
                  sw128_desc(sm.v[st] + kk * 16 * 64, BOX * 2, 1024));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(&sm.empty[st]);   // this stage may be refilled
  }

  // epilogue: O = acc / l (0 on a fully masked row), lse = m + log(l)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_i[h];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    const int r = qrow[h];
    if (r >= T) continue;
    const float inv = l == 0.f ? 0.f : 1.f / l;
    __nv_bfloat16* orow = o + ((size_t)bh * T + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(&orow[8 * j + 2 * tig]) =
          pack_bf16(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    if (tig == 0)
      lse[(size_t)bh * T + r] =
          l == 0.f ? -INFINITY : m_i[h] * LN2 + logf(l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* qo,
           const int* ko, __nv_bfloat16* o, float* lse, int BH, int BHkv,
           int T, int Tk, float scale, int causal, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, BH, T, D) || !make_map(&tk, k, BHkv, Tk, D) ||
      !make_map(&tv, v, BHkv, Tk, D))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem<D>) + 1024;   // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (T + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, s>>>(
      tq, tk, tv, qo, ko, o, lse, BH / BHkv, T, Tk, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            const void* q_off, const void* k_off, void* o,
                            void* lse, int BH, int BHkv, int T, int Tk,
                            int D, float scale, int causal, void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || T <= 0 || Tk <= 0 ||
      (T + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto qo = static_cast<const int*>(q_off);
  auto ko = static_cast<const int*>(k_off);
  auto op = static_cast<__nv_bfloat16*>(o);
  auto lp = static_cast<float*>(lse);
  if (D == 128)
    return launch<128>(q, k, v, qo, ko, op, lp, BH, BHkv, T, Tk, scale,
                       causal, s);
  if (D == 64)
    return launch<64>(q, k, v, qo, ko, op, lp, BH, BHkv, T, Tk, scale,
                      causal, s);
  return (int)cudaErrorInvalidValue;
}
