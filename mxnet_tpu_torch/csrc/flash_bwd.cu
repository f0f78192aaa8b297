// Flash-attention backward for Hopper (sm_90a): two recompute kernels,
// bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas TPU kernels `_bwd_dq_call` and `_bwd_dkv_call` in
// mxnet_tpu/ops/pallas_ops.py (their pallas_calls at :208 and :307), and
// the delta pass of `_flash_lse_bwd` (:356-359), which mx_flash_bwd_dq
// computes in the same launch.  The forward stashed only O and the
// per-row logsumexp; both kernels re-form each score tile from Q and K:
//
//   P  = exp(S * scale - lse)      (lse = -inf read as 0; masked -> 0)
//   dP = dO V^T
//   dS = P o (dP - delta) * scale  (delta = rowsum(dO o O) - dlse, fp32)
//   dQ = dS K            -- mx_flash_bwd_dq (and delta, when given O)
//   dV = P^T dO, dK = dS^T Q, summed over the rep query heads of a kv
//                           group -- mx_flash_bwd_dkv
//
// GQA: query row bh reads kv row bh / rep, as in the forward.  The causal
// mask comes from the runtime offsets q_off[0] / k_off[0] (device int32),
// so the ring backward can pass block offsets that change each step.
//
// What bounds them on this card: dq does 6*D flops per visible (query,
// key) pair and dkv 8*D, against reads of Q, dO, K, V, lse and delta
// (and O for the fused delta) and writes of dq (or dk, dv).  At the
// training shape -- q (2, 32, 1024, 128) causal over k/v (2, 8, 1024,
// 128) -- that is 33.6 M visible pairs: 25.8 GFLOP (dq) and 34.4 GFLOP
// (dkv) over ~59-76 MB, ~340-580 flop/byte, above the H100's ~295
// ridge: both are bound by tensor-core operations.
//
// What the design does about it (helpers in hopper.cuh, as the forward):
// * Every product runs on wgmma, each Q, dO, K and V tile read once from
//   shared memory in the 128-byte swizzle TMA wrote, with no transposed
//   copy:
//     dq:  S = Q K^T, dP = dO V^T     (A and B K-major in shared memory)
//          dQ += dS K                 (dS from registers, K MN-major)
//     dkv: S^T = K Q^T, dP^T = V dO^T (K, V resident in shared memory)
//          dV += P^T dO, dK += dS^T Q (from registers, dO / Q MN-major)
//   S^T and dP^T come out in the accumulator layout whose bf16 repack is
//   the A operand of the next product, so P^T and dS^T never leave
//   registers; neither do dS, or the fp32 dQ, dK and dV accumulators.
// * Tiles arrive by TMA (3-D maps over heads x rows x D, zero-filled
//   past T or Tk per head) into a 2-stage ring guarded by mbarriers.
//   dq: one producer warp streams the K/V tiles, full / empty barriers
//   per stage, as the forward.  dkv: thread 0 of the consumer warpgroup
//   issues the next (Q, dO) tile while the warpgroup computes this one,
//   and every thread copies one lse or delta value of it with cp.async,
//   counted by the same full barrier; a warpgroup barrier before each
//   refill is its "empty".  dkv keeps dK, dV (2 x D/2) and S^T, dP^T
//   (2 x 32) accumulators live at once: with a producer warp (160
//   threads) two CTAs per SM would cap it at 200 registers, with 128
//   threads they may use 255.
// * The delta pass is folded into dq.  Given O (and dlse, or null), each
//   quad of consumer threads sums dO o O over its row in fp32 -- dO from
//   the swizzled tile TMA brought, O from global -- subtracts dlse,
//   uses it and writes it to `delta`, which dkv reads: the wrapper
//   launches dkv after dq on the same stream.  Without O (the ring
//   primitive's precomputed global delta) dq reads `delta`.
// * Balance.  dq: one CTA per (b*h, 64-row query tile), the query tile
//   the slow grid dimension in reverse, so the tiles with the most keys
//   go first.  dkv: one CTA per (b*hkv, 64-key tile); the rep query heads
//   x visible query tiles are one flattened stream inside the CTA (the
//   TPU kernel's sequential third grid axis and its VMEM scratch), so
//   there are no atomics and two calls give the same bits.  At the
//   training shape a 64 x 64 step is the unit: each kernel has 8,704
//   steps, 66 per SM.  dq's heaviest CTA makes 16 steps (1,024 CTAs, ~3.9
//   waves at 2 per SM, dispatched as others finish).  dkv's 256 CTAs are
//   all resident at once, 2 per SM, and its heaviest (key tile 0) makes
//   64 steps.  With key tiles in plain order the first 132 CTAs are
//   tiles 0-8 and the next 124, which share their SMs, tiles 8-15: up to
//   64 + 32 = 96 steps on an SM.  So the slow grid dimension runs key
//   tiles 0..7 first, then 15 down to 8, and each SM's second CTA is
//   a light one: 68 steps at most against the mean of 66 (10% off dkv's
//   time on the H100, PERF.md).
//
// Shapes: any T and Tk (ragged edges masked and zero-filled), D in {64,
// 128}, H % Hkv == 0.  Layouts: q, dout, o, dq (BH, T, D); k, v, dk, dv
// (BHkv, Tk, D); lse, dlse, delta (BH, T) fp32; all contiguous with
// 16-byte aligned bases.

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;                      // query rows per tile
constexpr int BK = 64;                      // keys per tile
constexpr int NSTAGES = 2;                  // ring depth
constexpr int NCONSUMER = 128;              // one warpgroup
constexpr int DQ_THREADS = NCONSUMER + 32;  // + dq's producer warp

template <int D>
struct DqSmem {
  alignas(1024) __nv_bfloat16 q[BQ * D];
  alignas(1024) __nv_bfloat16 dout[BQ * D];
  alignas(1024) __nv_bfloat16 k[NSTAGES][BK * D];
  alignas(1024) __nv_bfloat16 v[NSTAGES][BK * D];
  uint64_t q_full, full[NSTAGES], empty[NSTAGES];
};

template <int D>
struct DkvSmem {
  alignas(1024) __nv_bfloat16 k[BK * D];
  alignas(1024) __nv_bfloat16 v[BK * D];
  alignas(1024) __nv_bfloat16 q[NSTAGES][BQ * D];
  alignas(1024) __nv_bfloat16 dout[NSTAGES][BQ * D];
  float lse[NSTAGES][BQ], delta[NSTAGES][BQ];
  uint64_t kv_full, full[NSTAGES];
};

template <class S>
__device__ __forceinline__ S& aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return *reinterpret_cast<S*>(raw + (((a + 1023u) & ~1023u) - a));
}

__device__ __forceinline__ float lse_log2(float l) {
  return l == -INFINITY ? 0.f : l * LOG2E;
}

// sum of the products of 8 bf16 pairs, in fp32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

template <int D>
__device__ __forceinline__ void zero(float (&r)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) r[i] = 0.f;
}

// rows row0 + warp * 16 + g (+ 8) of a (rows, D) bf16 output, from the
// wgmma accumulator layout
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2],
                                           int row0, int rows, int warp,
                                           int g, int tig) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + g + 8 * h;
    if (r >= rows) continue;
    __nv_bfloat16* orow = out + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(&orow[8 * j + 2 * tig]) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __nv_bfloat16* __restrict__ o,
                    const float* __restrict__ lse,
                    const float* __restrict__ dlse,
                    float* __restrict__ delta,
                    const int* __restrict__ q_off_p,
                    const int* __restrict__ k_off_p,
                    __nv_bfloat16* __restrict__ dq, int rep, int T, int Tk,
                    float scale, int causal) {
  constexpr int NB = D / 64;               // 64-column boxes per row
  constexpr int KV_BYTES = 2 * BK * D * 2; // one stage: a K and a V tile
  extern __shared__ unsigned char smem_raw[];
  DqSmem<D>& sm = aligned_smem<DqSmem<D>>(smem_raw);

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int bkv = bh / rep;
  const int row0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q_off = q_off_p[0], k_off = k_off_p[0];

  // key tiles up to the causal bound of the last real row of the tile
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
    // ---- producer: Q and dO once (delta needs dO even with no key
    // tile), then the K/V ring
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, 2 * BQ * D * 2);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(sm.q + b * BOX, &tm_q, &sm.q_full, b * 64, row0, bh);
        tma_load_3d(sm.dout + b * BOX, &tm_do, &sm.q_full, b * 64, row0, bh);
      }
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
  int qrow[2];
  float lse2[2], dl[2];
  mbar_wait(&sm.q_full, 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    qrow[h] = row0 + r;
    const bool in = qrow[h] < T;
    const size_t idx = (size_t)bh * T + qrow[h];
    lse2[h] = in ? lse_log2(lse[idx]) : 0.f;
    if (o != nullptr) {
      // delta = rowsum(dO o O) - dlse: this thread's quarter of the row
      float sum = 0.f;
      if (in) {
        const __nv_bfloat16* orow = o + idx * D;
#pragma unroll
        for (int c = tig * (D / 4); c < (tig + 1) * (D / 4); c += 8)
          sum += dot8(*reinterpret_cast<const uint4*>(orow + c),
                      *reinterpret_cast<const uint4*>(sm.dout +
                                                      swizzled(r, c)));
      }
      sum += __shfl_xor_sync(0xffffffff, sum, 1);
      sum += __shfl_xor_sync(0xffffffff, sum, 2);
      if (in && dlse != nullptr) sum -= dlse[idx];
      if (in && tig == 0) delta[idx] = sum;
      dl[h] = sum;
    } else {
      dl[h] = in ? delta[idx] : 0.f;
    }
  }

  const float scale_log2 = scale * LOG2E;
  float acc[D / 2];
  zero(acc);
  for (int kt = 0; kt < upper; ++kt) {
    const int st = kt % NSTAGES;
    const int key0 = kt * BK;
    mbar_wait(&sm.full[st], (kt / NSTAGES) & 1);

    // S = Q K^T and dP = dO V^T, two commit groups: P is formed while
    // the tensor cores still work on dP
    float s[BK / 2], dp[BK / 2];
    zero(s);
    zero(dp);
    wgmma_fence();
    wgmma_abt<D>(s, sm.q, sm.k[st]);
    wgmma_commit();
    wgmma_abt<D>(dp, sm.dout, sm.v[st]);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P into s, then dS = P o (dP - delta) * scale.  Accumulator element
    // i: row half h = (i >> 1) & 1, key 8 * (i >> 2) + 2 * tig + (i & 1).
    const bool edge = key0 + BK > Tk ||
                      (causal && k_off + key0 + BK - 1 > q_off + row0);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2f(s[i] * scale_log2 - lse2[h]);
      if (edge) {
        const int key = key0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        bool ok = key < Tk;
        if (causal) ok = ok && (q_off + qrow[h] >= k_off + key);
        p = ok ? p : 0.f;
      }
      s[i] = p;
    }
    wgmma_wait0();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      s[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * scale;

    // dQ += dS K: K read MN-major from its K-major tile
    uint32_t a[BK / 16][4];
    pack_a(a, s);
    fence_regs(acc);
    wgmma_fence();
    wgmma_ab_rows<D>(acc, a, sm.k[st]);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(&sm.empty[st]);   // this stage may be refilled
  }
  store_rows<D>(dq + (size_t)bh * T * D, acc, row0, T, warp, g, tig);
}

template <int D>
__global__ void __launch_bounds__(NCONSUMER)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ q_off_p,
                     const int* __restrict__ k_off_p,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int rep, int T, int Tk,
                     float scale, int causal) {
  constexpr int NB = D / 64;
  constexpr int TILE_BYTES = 2 * BQ * D * 2;   // a Q and a dO tile
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<D>& sm = aligned_smem<DkvSmem<D>>(smem_raw);

  const int bkv = blockIdx.x;
  // key tiles 0 .. h - 1 (the most causal work first), then nk - 1 down
  // to h: the second CTA to land on an SM takes the least work
  const int h = (gridDim.y + 1) / 2, y = blockIdx.y;
  const int key0 = (y < h ? y : gridDim.y - 1 - (y - h)) * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q_off = q_off_p[0], k_off = k_off_p[0];

  // query tiles from the first that can see this key tile, for each of
  // the rep heads: one stream of n tiles
  const int nq = (T + BQ - 1) / BQ;
  int lower = 0;
  if (causal) {
    const int diff = k_off + key0 - q_off;
    lower = diff <= 0 ? 0 : min(diff / BQ, nq);
  }
  const int per = nq - lower;
  const int n = rep * per;

  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < NSTAGES; ++s)
      mbar_init(&sm.full[s], 1 + NCONSUMER);   // TMA + each cp.async
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile i into stage i % NSTAGES: Q and dO by TMA (thread 0), the lse
  // (threads 0..63) and delta (64..127) of its rows by cp.async, zero
  // past T
  auto load_tile = [&](int i) {
    const int st = i % NSTAGES;
    const int bh = bkv * rep + i / per;
    const int q0 = (lower + i % per) * BQ;
    if (tid == 0) {
      mbar_expect_tx(&sm.full[st], TILE_BYTES);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(sm.q[st] + b * BOX, &tm_q, &sm.full[st], b * 64, q0,
                    bh);
        tma_load_3d(sm.dout[st] + b * BOX, &tm_do, &sm.full[st], b * 64,
                    q0, bh);
      }
    }
    const int r = tid & (BQ - 1);
    const bool in = q0 + r < T;
    const float* src = (tid < BQ ? lse : delta) + (size_t)bh * T +
                       (in ? q0 + r : 0);
    cp_async4((tid < BQ ? sm.lse[st] : sm.delta[st]) + r, src, in);
    cp_async_arrive(&sm.full[st]);
  };

  if (n > 0) {
    if (tid == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * BK * D * 2);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(sm.k + b * BOX, &tm_k, &sm.kv_full, b * 64, key0, bkv);
        tma_load_3d(sm.v + b * BOX, &tm_v, &sm.kv_full, b * 64, key0, bkv);
      }
    }
    load_tile(0);
    mbar_wait(&sm.kv_full, 0);
  }

  const float scale_log2 = scale * LOG2E;
  int krow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) krow[h] = key0 + warp * 16 + g + 8 * h;
  float dka[D / 2], dva[D / 2];
  zero(dka);
  zero(dva);
  for (int i = 0; i < n; ++i) {
    const int st = i % NSTAGES;
    if (i + 1 < n) {
      warpgroup_sync(NCONSUMER);   // every thread is done with tile i - 1
      load_tile(i + 1);            // ... whose stage this refills
    }
    const int q0 = (lower + i % per) * BQ;
    mbar_wait(&sm.full[st], (i / NSTAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, two commit groups
    float s[BQ / 2], dp[BQ / 2];
    zero(s);
    zero(dp);
    wgmma_fence();
    wgmma_abt<D>(s, sm.k, sm.q[st]);
    wgmma_commit();
    wgmma_abt<D>(dp, sm.v, sm.dout[st]);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P^T into s while dP^T is computed.  Element j: key half h = (j >>
    // 1) & 1, query column 8 * (j >> 2) + 2 * tig + (j & 1) of the tile.
    const bool edge = q0 + BQ > T || key0 + BK > Tk ||
                      (causal && k_off + key0 + BK - 1 > q_off + q0);
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) {
      const int h = (j >> 1) & 1;
      const int c = 8 * (j >> 2) + 2 * tig + (j & 1);
      float p = exp2f(s[j] * scale_log2 - lse_log2(sm.lse[st][c]));
      if (edge) {
        bool ok = q0 + c < T && krow[h] < Tk;
        if (causal) ok = ok && (q_off + q0 + c >= k_off + krow[h]);
        p = ok ? p : 0.f;
      }
      s[j] = p;
    }

    // dV += P^T dO (dO read MN-major) while dS^T is formed
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
    pack_a(pa, s);
    fence_regs(dva);
    wgmma_fence();
    wgmma_ab_rows<D>(dva, pa, sm.dout[st]);
    wgmma_commit();
    wgmma_wait<1>();   // dP^T has landed; dV may still be in flight
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) {
      const int c = 8 * (j >> 2) + 2 * tig + (j & 1);
      dp[j] = s[j] * (dp[j] - sm.delta[st][c]) * scale;
    }

    // dK += dS^T Q (Q read MN-major)
    pack_a(sa, dp);
    fence_regs(dka);
    wgmma_fence();
    wgmma_ab_rows<D>(dka, sa, sm.q[st]);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dva);
    fence_regs(dka);
  }
  store_rows<D>(dk + (size_t)bkv * Tk * D, dka, key0, Tk, warp, g, tig);
  store_rows<D>(dv + (size_t)bkv * Tk * D, dva, key0, Tk, warp, g, tig);
}

bool shapes_ok(int BH, int BHkv, int T, int Tk) {
  return BH > 0 && BHkv > 0 && BH % BHkv == 0 && T > 0 && Tk > 0 &&
         (T + BQ - 1) / BQ <= 65535 && (Tk + BK - 1) / BK <= 65535;
}

bool make_maps(CUtensorMap (&m)[4], const void* q, const void* k,
               const void* v, const void* dout, int BH, int BHkv, int T,
               int Tk, int D) {
  return make_map(&m[0], q, BH, T, D) && make_map(&m[1], k, BHkv, Tk, D) &&
         make_map(&m[2], v, BHkv, Tk, D) && make_map(&m[3], dout, BH, T, D);
}

template <class Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_dq(const CUtensorMap (&m)[4], const void* o, const float* lse,
              const float* dlse, float* delta, const int* qo, const int* ko,
              __nv_bfloat16* dq, int BH, int BHkv, int T, int Tk,
              float scale, int causal, cudaStream_t s) {
  const int smem = (int)sizeof(DqSmem<D>) + 1024;   // + alignment slack
  if (int err = set_smem(flash_bwd_dq_kernel<D>, smem)) return err;
  const dim3 grid(BH, (T + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D><<<grid, DQ_THREADS, smem, s>>>(
      m[0], m[1], m[2], m[3], static_cast<const __nv_bfloat16*>(o), lse,
      dlse, delta, qo, ko, dq, BH / BHkv, T, Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const CUtensorMap (&m)[4], const float* lse,
               const float* delta, const int* qo, const int* ko,
               __nv_bfloat16* dk, __nv_bfloat16* dv, int BH, int BHkv, int T,
               int Tk, float scale, int causal, cudaStream_t s) {
  const int smem = (int)sizeof(DkvSmem<D>) + 1024;
  if (int err = set_smem(flash_bwd_dkv_kernel<D>, smem)) return err;
  const dim3 grid(BHkv, (Tk + BK - 1) / BK);
  flash_bwd_dkv_kernel<D><<<grid, NCONSUMER, smem, s>>>(
      m[0], m[1], m[2], m[3], lse, delta, qo, ko, dk, dv, BH / BHkv, T, Tk,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dq; with o non-null also delta = rowsum(dO o O) - dlse (dlse may be
// null), written to `delta` for mx_flash_bwd_dkv, launched after this on
// the same stream.  With o null, `delta` is read.
extern "C" int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* o,
                               const void* lse, const void* dlse,
                               void* delta, const void* q_off,
                               const void* k_off, void* dq, int BH, int BHkv,
                               int T, int Tk, int D, float scale, int causal,
                               void* stream) {
  CUtensorMap m[4];
  if (!shapes_ok(BH, BHkv, T, Tk) || (D != 64 && D != 128) ||
      !make_maps(m, q, k, v, dout, BH, BHkv, T, Tk, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto lp = static_cast<const float*>(lse);
  auto dl = static_cast<const float*>(dlse);
  auto tp = static_cast<float*>(delta);
  auto qo = static_cast<const int*>(q_off);
  auto ko = static_cast<const int*>(k_off);
  auto out = static_cast<__nv_bfloat16*>(dq);
  if (D == 128)
    return launch_dq<128>(m, o, lp, dl, tp, qo, ko, out, BH, BHkv, T, Tk,
                          scale, causal, s);
  return launch_dq<64>(m, o, lp, dl, tp, qo, ko, out, BH, BHkv, T, Tk, scale,
                       causal, s);
}

extern "C" int mx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* q_off,
                                const void* k_off, void* dk, void* dv,
                                int BH, int BHkv, int T, int Tk, int D,
                                float scale, int causal, void* stream) {
  CUtensorMap m[4];
  if (!shapes_ok(BH, BHkv, T, Tk) || (D != 64 && D != 128) ||
      !make_maps(m, q, k, v, dout, BH, BHkv, T, Tk, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto lp = static_cast<const float*>(lse);
  auto tp = static_cast<const float*>(delta);
  auto qo = static_cast<const int*>(q_off);
  auto ko = static_cast<const int*>(k_off);
  auto dkp = static_cast<__nv_bfloat16*>(dk);
  auto dvp = static_cast<__nv_bfloat16*>(dv);
  if (D == 128)
    return launch_dkv<128>(m, lp, tp, qo, ko, dkp, dvp, BH, BHkv, T, Tk,
                           scale, causal, s);
  return launch_dkv<64>(m, lp, tp, qo, ko, dkp, dvp, BH, BHkv, T, Tk, scale,
                        causal, s);
}
