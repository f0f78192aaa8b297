// Flash-attention backward for Hopper (sm_90a): two recompute kernels,
// bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas TPU kernels `_bwd_dq_call` and `_bwd_dkv_call` in
// mxnet_tpu/ops/pallas_ops.py (their pallas_calls at :208 and :307).
// The forward stashed only O and the per-row logsumexp; both kernels
// re-form each score tile from Q and K:
//
//   P  = exp(S * scale - lse)      (lse = -inf read as 0; masked -> 0)
//   dP = dO V^T
//   dS = P o (dP - delta) * scale  (delta = rowsum(dO o O) - dlse, fp32,
//                                   computed by the caller)
//   dQ = dS K            -- mx_flash_bwd_dq
//   dV = P^T dO, dK = dS^T Q, summed over the rep query heads of a kv
//                           group -- mx_flash_bwd_dkv
//
// GQA: query row bh reads kv row bh / rep, as in the forward.  The causal
// mask comes from the runtime offsets q_off[0] / k_off[0] (device int32),
// so the ring backward can pass block offsets that change each step.
//
// What bounds them on this card: dq does 6*D flops per visible (query,
// key) pair and dkv 8*D, against reads of Q, dO, K, V, lse and delta and
// writes of dq (or dk, dv).  At the training shape -- q (2, 32, 1024,
// 128) causal over k/v (2, 8, 1024, 128) -- that is 33.6 M visible pairs:
// 25.8 GFLOP (dq) and 34.4 GFLOP (dkv) over ~59 MB, ~440-580 flop/byte,
// above the H100's ~295 ridge: both are bound by tensor-core operations.
//
// What the design does about it: every product runs on the tensor cores
// through mma.sync m16n8k16 (bf16 in, fp32 accumulate); the score, P and
// dS tiles never leave registers (the fp32 accumulator fragment of a
// product is repacked in registers as the bf16 A operand of the next);
// the B operands that need a transpose (K for dS K, dO and Q for the
// P^T / dS^T products) are read from row-major shared memory with
// ldmatrix .trans, so no transposed copy is stored; key tiles beyond the
// causal bound (dq) and query tiles before it (dkv) are never loaded.
// The dkv kernel computes S^T = K Q^T directly, so P^T and dS^T come out
// as accumulator fragments already in the A layout their products need.
// No atomics: dkv loops over the rep query heads of a group inside the
// CTA (the TPU kernel's sequential third grid axis and its VMEM scratch),
// so dk/dv are the same bits run to run.  This is the simple form: no
// cp.async / TMA double buffering and no wgmma -- a later change can add
// them.
//
// Registers: at D = 128 each warp of the dq kernel keeps its Q and dO
// A fragments (2 x 32) and its 16 x 128 dQ accumulator (64) in
// registers, with 32-key tiles so the two score tiles take 2 x 16; each
// warp of the dkv kernel keeps its 16-key dK and dV accumulators (2 x 64)
// with 32-row query tiles (score tiles 2 x 16) and reads its K / V A
// fragments from shared memory.  Shared memory: dq stages Q, then dO,
// then each K and V tile through one 17 KB buffer; dkv holds its K and V
// tiles for the whole CTA plus one Q / dO tile (52 KB at D = 128, dynamic).
//
// Shapes: any T and Tk (ragged edges masked and zero-filled), D in {64,
// 128}, H % Hkv == 0.  Layouts: q, dout, dq (BH, T, D); k, v, dk, dv
// (BHkv, Tk, D); lse, delta (BH, T) fp32; all contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;   // 4 warps
constexpr int DQ_BQ = 64;       // query rows per dq CTA (16 per warp)
constexpr int DQ_BK = 32;       // keys per K/V tile of the dq kernel
constexpr int KV_BK = 64;       // keys per dkv CTA (16 per warp)
constexpr int KV_BQ = 32;       // query rows per tile of the dkv kernel
constexpr int VEC = 8;          // bf16 per 16-byte load

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row (l & 7) of matrix (l >> 3); register i receives elements
// [2 * (lane & 3)] and [2 * (lane & 3) + 1] of column (lane >> 2) of
// matrix i -- the B fragment of m16n8k16 when the rows are its k index.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// rows [row0, row0 + ROWS) of a row-major (n, D) slab into shared memory
// with row stride D + 8; rows at or past n are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n, int tid) {
  constexpr int S = D + 8;
  for (int i = tid; i < ROWS * D / VEC; i += NTHREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(&dst[r * S + c]) = val;
  }
}

// the A fragment of k-step kk for rows r, r + 8 of a shared-memory tile
template <int D>
__device__ __forceinline__ void afrag(uint32_t (&a)[4],
                                      const __nv_bfloat16* sm, int r, int kk,
                                      int tig) {
  constexpr int S = D + 8;
  const int c = kk * 16 + tig * 2;
  a[0] = ld_u32(&sm[r * S + c]);
  a[1] = ld_u32(&sm[(r + 8) * S + c]);
  a[2] = ld_u32(&sm[r * S + c + 8]);
  a[3] = ld_u32(&sm[(r + 8) * S + c + 8]);
}

// the accumulator fragments of n-tiles 2kk, 2kk+1 as the bf16 A fragment
// of k-step kk
__device__ __forceinline__ void repack(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// acc[n] += A * B over all n-tiles of D, where B[k][n] is row k of a
// row-major shared-memory tile (k = the 16 rows from row k0)
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4],
                                         const uint32_t (&a)[4],
                                         const __nv_bfloat16* sm, int k0,
                                         int lane) {
  constexpr int S = D + 8;
  const int mi = lane >> 3, rr = lane & 7;
  const __nv_bfloat16* base = sm + (k0 + rr + (mi & 1) * 8) * S +
                              (mi >> 1) * 8;
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t b[4];
    ldsm_x4_t(b, base + np * 16);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ float lse_or_zero(float l) {
  return l == -INFINITY ? 0.f : l;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ q_off_p,
                    const int* __restrict__ k_off_p,
                    __nv_bfloat16* __restrict__ dq, int rep, int T, int Tk,
                    float scale, int causal) {
  constexpr int S = D + 8;       // padded row stride (elements)
  constexpr int NKT = D / 16;    // k-steps over D
  constexpr int NDT = D / 8;     // n-tiles of the dQ accumulator
  constexpr int NST = DQ_BK / 8; // n-tiles of a score tile
  // stages Q, then dO (DQ_BQ rows), then each K tile (rows 0..31) and V
  // tile (rows 32..63)
  __shared__ __align__(16) __nv_bfloat16 buf[DQ_BQ * S];
  __nv_bfloat16* Ks = buf;
  __nv_bfloat16* Vs = buf + DQ_BK * S;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int bkv = bh / rep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q_off = q_off_p[0], k_off = k_off_p[0];
  const int row0 = qt * DQ_BQ;
  const int wr = warp * 16 + g;  // this thread's first row in the tile

  const __nv_bfloat16* kb = k + ((size_t)bkv * Tk) * D;
  const __nv_bfloat16* vb = v + ((size_t)bkv * Tk) * D;

  // Q and dO A fragments, kept in registers for the whole CTA
  uint32_t qf[NKT][4], df[NKT][4];
  load_tile<D, DQ_BQ>(buf, q + ((size_t)bh * T) * D, row0, T, tid);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk) afrag<D>(qf[kk], buf, wr, kk, tig);
  __syncthreads();
  load_tile<D, DQ_BQ>(buf, dout + ((size_t)bh * T) * D, row0, T, tid);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk) afrag<D>(df[kk], buf, wr, kk, tig);

  // this thread's two rows (g and g + 8 of its warp)
  const int qrow[2] = {row0 + wr, row0 + wr + 8};
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = qrow[h] < T;
    lse_r[h] = in ? lse_or_zero(lse[(size_t)bh * T + qrow[h]]) : 0.f;
    dl_r[h] = in ? delta[(size_t)bh * T + qrow[h]] : 0.f;
  }

  float acc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // key tiles up to the causal bound of the last real row of the tile
  const int nk = (Tk + DQ_BK - 1) / DQ_BK;
  int upper = nk;
  if (causal) {
    const int diff = q_off + min(row0 + DQ_BQ, T) - 1 - k_off;
    upper = diff < 0 ? 0 : min(diff / DQ_BK + 1, nk);
  }

  for (int kt = 0; kt < upper; ++kt) {
    const int key0 = kt * DQ_BK;
    __syncthreads();  // previous tile (or the dO staging) fully consumed
    load_tile<D, DQ_BK>(Ks, kb, key0, Tk, tid);
    load_tile<D, DQ_BK>(Vs, vb, key0, Tk, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 32 keys
    float s[NST][4], dp[NST][4];
#pragma unroll
    for (int n = 0; n < NST; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      const int kr = n * 8 + g;
#pragma unroll
      for (int kk = 0; kk < NKT; ++kk) {
        const int c = kk * 16 + tig * 2;
        mma_bf16(s[n], qf[kk], ld_u32(&Ks[kr * S + c]),
                 ld_u32(&Ks[kr * S + c + 8]));
        mma_bf16(dp[n], df[kk], ld_u32(&Vs[kr * S + c]),
                 ld_u32(&Vs[kr * S + c + 8]));
      }
    }

    // dS = P o (dP - delta) * scale, into s
#pragma unroll
    for (int n = 0; n < NST; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = key0 + n * 8 + tig * 2 + (e & 1);
        bool ok = key < Tk && qrow[h] < T;
        if (causal) ok = ok && (q_off + qrow[h] >= k_off + key);
        const float p = ok ? expf(s[n][e] * scale - lse_r[h]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl_r[h]) * scale;
      }
    }

    // dQ += dS K: K read transposed from its row-major tile
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
      uint32_t a[4];
      repack(a, s[2 * kk], s[2 * kk + 1]);
      mma_rows<D>(acc, a, Ks, kk * 16, lane);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= T) continue;
    __nv_bfloat16* out = dq + ((size_t)bh * T + qrow[h]) * D;
#pragma unroll
    for (int n = 0; n < NDT; ++n)
      *reinterpret_cast<uint32_t*>(&out[n * 8 + tig * 2]) =
          pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * KV_BK + 2 * KV_BQ) * (D + 8) * 2 + 2 * KV_BQ * 4;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ q_off_p,
                     const int* __restrict__ k_off_p,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int rep, int T, int Tk,
                     float scale, int causal) {
  constexpr int S = D + 8;
  constexpr int NKT = D / 16;     // k-steps over D
  constexpr int NDT = D / 8;      // n-tiles of the dK / dV accumulators
  constexpr int NQT = KV_BQ / 8;  // n-tiles of a transposed score tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // KV_BK rows
  __nv_bfloat16* Vs = Ks + KV_BK * S;                           // KV_BK rows
  __nv_bfloat16* Qs = Vs + KV_BK * S;                           // KV_BQ rows
  __nv_bfloat16* Ds = Qs + KV_BQ * S;                           // dO tile
  float* Ls = reinterpret_cast<float*>(Ds + KV_BQ * S);  // lse (-inf -> 0)
  float* Dl = Ls + KV_BQ;                                // delta

  const int kt = blockIdx.x;
  const int bkv = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q_off = q_off_p[0], k_off = k_off_p[0];
  const int key0 = kt * KV_BK;
  const int wr = warp * 16 + g;  // this thread's first key in the tile
  const int krow[2] = {key0 + wr, key0 + wr + 8};

  load_tile<D, KV_BK>(Ks, k + ((size_t)bkv * Tk) * D, key0, Tk, tid);
  load_tile<D, KV_BK>(Vs, v + ((size_t)bkv * Tk) * D, key0, Tk, tid);

  float dka[NDT][4], dva[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  // query tiles from the first that can see this key tile
  const int nq = (T + KV_BQ - 1) / KV_BQ;
  int lower = 0;
  if (causal) {
    const int diff = k_off + key0 - q_off;
    lower = diff <= 0 ? 0 : min(diff / KV_BQ, nq);
  }

  for (int r = 0; r < rep; ++r) {
    const int bh = bkv * rep + r;
    const __nv_bfloat16* qb = q + ((size_t)bh * T) * D;
    const __nv_bfloat16* db = dout + ((size_t)bh * T) * D;
    for (int qt = lower; qt < nq; ++qt) {
      const int q0 = qt * KV_BQ;
      __syncthreads();  // previous query tile fully consumed
      load_tile<D, KV_BQ>(Qs, qb, q0, T, tid);
      load_tile<D, KV_BQ>(Ds, db, q0, T, tid);
      if (tid < KV_BQ) {
        const int row = q0 + tid;
        const bool in = row < T;
        Ls[tid] = in ? lse_or_zero(lse[(size_t)bh * T + row]) : 0.f;
        Dl[tid] = in ? delta[(size_t)bh * T + row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 32 rows
      float st[NQT][4], dpt[NQT][4];
#pragma unroll
      for (int n = 0; n < NQT; ++n) {
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < NKT; ++kk) {
        uint32_t ka[4], va[4];
        afrag<D>(ka, Ks, wr, kk, tig);
        afrag<D>(va, Vs, wr, kk, tig);
        const int c = kk * 16 + tig * 2;
#pragma unroll
        for (int n = 0; n < NQT; ++n) {
          const int qr = n * 8 + g;
          mma_bf16(st[n], ka, ld_u32(&Qs[qr * S + c]),
                   ld_u32(&Qs[qr * S + c + 8]));
          mma_bf16(dpt[n], va, ld_u32(&Ds[qr * S + c]),
                   ld_u32(&Ds[qr * S + c + 8]));
        }
      }

      // P^T into st, dS^T into dpt
#pragma unroll
      for (int n = 0; n < NQT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = krow[e >> 1];
          const int ql = n * 8 + tig * 2 + (e & 1);
          bool ok = q0 + ql < T && key < Tk;
          if (causal) ok = ok && (q_off + q0 + ql >= k_off + key);
          const float p = ok ? expf(st[n][e] * scale - Ls[ql]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - Dl[ql]) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q: dO and Q read transposed
#pragma unroll
      for (int kk = 0; kk < KV_BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        repack(pa, st[2 * kk], st[2 * kk + 1]);
        repack(sa, dpt[2 * kk], dpt[2 * kk + 1]);
        mma_rows<D>(dva, pa, Ds, kk * 16, lane);
        mma_rows<D>(dka, sa, Qs, kk * 16, lane);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] >= Tk) continue;
    const size_t off = ((size_t)bkv * Tk + krow[h]) * D;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      *reinterpret_cast<uint32_t*>(&dk[off + n * 8 + tig * 2]) =
          pack_bf16(dka[n][2 * h], dka[n][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(&dv[off + n * 8 + tig * 2]) =
          pack_bf16(dva[n][2 * h], dva[n][2 * h + 1]);
    }
  }
}

bool shapes_ok(int BH, int BHkv, int T, int Tk) {
  return BH > 0 && BHkv > 0 && BH % BHkv == 0 && T > 0 && Tk > 0 &&
         BH <= 65535;
}

template <int D>
int launch_dkv(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const __nv_bfloat16* dout,
               const float* lse, const float* delta, const int* qo,
               const int* ko, __nv_bfloat16* dk, __nv_bfloat16* dv, int BH,
               int BHkv, int T, int Tk, float scale, int causal,
               cudaStream_t s) {
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tk + KV_BK - 1) / KV_BK, BHkv);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, bytes, s>>>(
      q, k, v, dout, lse, delta, qo, ko, dk, dv, BH / BHkv, T, Tk, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* q_off,
                               const void* k_off, void* dq, int BH, int BHkv,
                               int T, int Tk, int D, float scale, int causal,
                               void* stream) {
  if (!shapes_ok(BH, BHkv, T, Tk)) return (int)cudaErrorInvalidValue;
  dim3 grid((T + DQ_BQ - 1) / DQ_BQ, BH);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int rep = BH / BHkv;
  auto qp = static_cast<const __nv_bfloat16*>(q);
  auto kp = static_cast<const __nv_bfloat16*>(k);
  auto vp = static_cast<const __nv_bfloat16*>(v);
  auto dp = static_cast<const __nv_bfloat16*>(dout);
  auto lp = static_cast<const float*>(lse);
  auto tp = static_cast<const float*>(delta);
  auto qo = static_cast<const int*>(q_off);
  auto ko = static_cast<const int*>(k_off);
  auto out = static_cast<__nv_bfloat16*>(dq);
  if (D == 128)
    flash_bwd_dq_kernel<128><<<grid, NTHREADS, 0, s>>>(
        qp, kp, vp, dp, lp, tp, qo, ko, out, rep, T, Tk, scale, causal);
  else if (D == 64)
    flash_bwd_dq_kernel<64><<<grid, NTHREADS, 0, s>>>(
        qp, kp, vp, dp, lp, tp, qo, ko, out, rep, T, Tk, scale, causal);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int mx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* q_off,
                                const void* k_off, void* dk, void* dv,
                                int BH, int BHkv, int T, int Tk, int D,
                                float scale, int causal, void* stream) {
  if (!shapes_ok(BH, BHkv, T, Tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto qp = static_cast<const __nv_bfloat16*>(q);
  auto kp = static_cast<const __nv_bfloat16*>(k);
  auto vp = static_cast<const __nv_bfloat16*>(v);
  auto dp = static_cast<const __nv_bfloat16*>(dout);
  auto lp = static_cast<const float*>(lse);
  auto tp = static_cast<const float*>(delta);
  auto qo = static_cast<const int*>(q_off);
  auto ko = static_cast<const int*>(k_off);
  auto dkp = static_cast<__nv_bfloat16*>(dk);
  auto dvp = static_cast<__nv_bfloat16*>(dv);
  if (D == 128)
    return launch_dkv<128>(qp, kp, vp, dp, lp, tp, qo, ko, dkp, dvp, BH,
                           BHkv, T, Tk, scale, causal, s);
  if (D == 64)
    return launch_dkv<64>(qp, kp, vp, dp, lp, tp, qo, ko, dkp, dvp, BH,
                          BHkv, T, Tk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
