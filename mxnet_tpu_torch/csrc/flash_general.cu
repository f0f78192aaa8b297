// General flash attention: forward, dq and dk/dv for every dtype and
// head_dim the reference takes.
//
// Replaces, for every input the Hopper kernels (flash_fwd.cu,
// flash_bwd.cu: bf16, head_dim 64 or 128) do not take, the Pallas TPU
// kernels of mxnet_tpu/ops/pallas_ops.py: `_fwd_call` (:62, pallas_call
// at :126), `_bwd_dq_call` (:149 / :208) with the delta of
// `_flash_lse_bwd` (:351), and `_bwd_dkv_call` (:227 / :307), and with
// them the dense and chunked fallbacks the reference takes for other
// dtypes and head dims (:503-538).  Inputs are float16, bfloat16,
// float32 or float64, any head_dim D in 1..256, any T and Tk, any
// H % Hkv == 0 (GQA and MQA), causal or not, with the global position
// offsets read on the device.  Scores, softmax and sums run in float32
// (float64 for float64 inputs); the lse and delta are float32, as in the
// Hopper kernels; dq, dk and dv are written in the accumulation type.
//
// Semantics (those of the plain versions in ops/cuda_ops.py): a query
// at q_off + t sees a key at k_off + j iff not causal or q_off + t >=
// k_off + j.  A row that sees no key has output 0 and lse -inf; the
// backward reads an lse of -inf as 0 (pallas_ops.py:174, :256).
//
// What bounds it on this card: neither bytes nor the tensor cores --
// these kernels run on the CUDA cores, so at float32 and D 64 a score
// costs 2 D FMAs and the output D more, against the 67 TFLOP/s float32
// peak.  They are the simple first version the port needs so that no
// CUDA call is refused; tensor cores (TF32 / fp16 mma, wgmma) and TMA
// are later work.
//
// Design:
// * One warp per output row (a query row for forward and dq, a key row
//   for dk/dv), eight rows per CTA, all of one (batch, head).
// * The other side's rows are staged 32 at a time in shared memory,
//   shared by the CTA's eight warps.  Lane l scores staged row l (a full
//   D-long dot product against the warp's own row, kept in shared
//   memory in the accumulation type); then every lane adds the 32
//   weighted rows to the D / 32 output elements it owns, the weights
//   passed by warp shuffles.  Rows are padded (general.cuh row_stride)
//   so the per-lane row reads do not collide in the banks.
// * Forward: online softmax with a warp-uniform running max; each lane
//   keeps a partial row sum, reduced once at the end.
// * dq computes delta = rowsum(dO o O) - dlse for its own row when given
//   O (writing it out for dk/dv, as the Hopper dq does), else reads it.
// * dk/dv: one warp per key row sums over every query row and every
//   query head of its GQA group in a fixed order inside the CTA: no
//   atomics, so two calls give the same bits.
// * Causal: the forward and dq stop at the CTA's last visible key, dk/dv
//   start at the CTA's first visible query.
// * Shared memory grows with D and the element size: 2 x 32 padded
//   staged rows plus the warps' own rows, at most 164,608 bytes (dk/dv
//   at D 256 in float64); the launch raises the limit above 48 KB.
//
// Layouts (all contiguous): q, o, do, dq (B*H, T, D); k, v, dk, dv
// (B*Hkv, Tk, D); lse, delta, dlse (B*H, T) float32; q_off, k_off one
// int32 each.

#include "general.cuh"

namespace {

using namespace mxg;

template <typename T> struct FwdSmem {
  using A = typename Acc<T>::type;
  __host__ __device__ static size_t tile(int D) { return align16((size_t)TILE * row_stride<T>(D) * sizeof(T)); }
  __host__ __device__ static size_t bytes(int D) { return 2 * tile(D) + (size_t)WARPS * D * sizeof(A); }
};

template <typename T, int NE>
__global__ void __launch_bounds__(NT)
    fwd_general_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_off,
                       const int* __restrict__ k_off, T* __restrict__ o,
                       float* __restrict__ lse, int H, int Hkv, int Tq,
                       int Tk, int D, double scale_d, int causal) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = row_stride<T>(D);
  const size_t tile = FwdSmem<T>::tile(D);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + tile);
  A* qs = reinterpret_cast<A*>(smem + 2 * tile);
  const A scale = (A)scale_d;
  const A NEG = -INFINITY;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.y * WARPS, t = t0 + warp;
  const bool row_ok = t < Tq;
  const long long qo = q_off[0], ko = k_off[0];
  A* myq = qs + warp * D;
  if (row_ok)
    for (int d = lane; d < D; d += 32)
      myq[d] = to_acc(q[((size_t)bh * Tq + t) * D + d]);

  int kend = Tk;
  if (causal) {
    const long long last_q = qo + min(t0 + WARPS, Tq) - 1;
    kend = (int)max(0LL, min((long long)Tk, last_q - ko + 1));
  }
  const T* kb = k + (size_t)bkv * Tk * D;
  const T* vb = v + (size_t)bkv * Tk * D;
  A m = NEG, lpart = 0, acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = 0;

  for (int j0 = 0; j0 < kend; j0 += TILE) {
    const int n = min(TILE, kend - j0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * D; i += NT) {
      const int r = i / D, c = i - r * D;
      ks[r * Dp + c] = kb[(size_t)j0 * D + i];
      vs[r * Dp + c] = vb[(size_t)j0 * D + i];
    }
    __syncthreads();
    if (!row_ok) continue;
    A s = NEG;
    if (lane < n && (!causal || qo + t >= ko + j0 + lane)) {
      const T* kr = ks + lane * Dp;
      A dot = 0;
      for (int d = 0; d < D; ++d) dot += myq[d] * to_acc(kr[d]);
      s = dot * scale;
    }
    const A m_new = max_(m, warp_max(s));
    if (m_new == NEG) continue;               // warp-uniform
    const A corr = (m == NEG) ? (A)0 : exp_(m - m_new);
    const A p = (s == NEG) ? (A)0 : exp_(s - m_new);
    lpart = lpart * corr + p;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[e] *= corr;
    for (int jj = 0; jj < n; ++jj) {
      const A pj = __shfl_sync(FULL, p, jj);
      const T* vr = vs + jj * Dp;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int d = lane + 32 * e;
        if (d < D) acc[e] += pj * to_acc(vr[d]);
      }
    }
    m = m_new;
  }
  if (!row_ok) return;
  const A l = warp_sum(lpart);
  T* orow = o + ((size_t)bh * Tq + t) * D;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int d = lane + 32 * e;
    if (d < D) orow[d] = from_acc<T>(l == 0 ? (A)0 : acc[e] / l);
  }
  if (lane == 0)
    lse[(size_t)bh * Tq + t] = l == 0 ? -INFINITY : (float)(m + log_(l));
}

template <typename T> struct DqSmem {
  using A = typename Acc<T>::type;
  __host__ __device__ static size_t tile(int D) { return FwdSmem<T>::tile(D); }
  __host__ __device__ static size_t bytes(int D) {
    return 2 * tile(D) + 2 * (size_t)WARPS * D * sizeof(A);
  }
};

template <typename T, int NE>
__global__ void __launch_bounds__(NT) dq_general_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const T* __restrict__ o,
    const float* __restrict__ lse, const float* __restrict__ dlse,
    float* __restrict__ delta, const int* __restrict__ q_off,
    const int* __restrict__ k_off, typename Acc<T>::type* __restrict__ dq,
    int H, int Hkv, int Tq, int Tk, int D, double scale_d, int causal) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = row_stride<T>(D);
  const size_t tile = DqSmem<T>::tile(D);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + tile);
  A* qs = reinterpret_cast<A*>(smem + 2 * tile);
  const A scale = (A)scale_d;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.y * WARPS, t = t0 + warp;
  const bool row_ok = t < Tq;
  const long long qo = q_off[0], ko = k_off[0];
  const size_t row = (size_t)bh * Tq + t;
  A* myq = qs + warp * 2 * D;
  A* mydo = myq + D;
  A L = 0, dlt = 0;
  if (row_ok) {
    A part = 0;
    for (int d = lane; d < D; d += 32) {
      myq[d] = to_acc(q[row * D + d]);
      mydo[d] = to_acc(dout[row * D + d]);
      if (o != nullptr) part += mydo[d] * to_acc(o[row * D + d]);
    }
    if (o != nullptr) {
      // rounded to float32 as stored, and used as read back
      const float dl = (float)(warp_sum(part) -
                               (dlse != nullptr ? (A)dlse[row] : (A)0));
      if (lane == 0) delta[row] = dl;
      dlt = (A)dl;
    } else {
      dlt = (A)delta[row];
    }
    const float lf = lse[row];
    L = (isinf(lf) && lf < 0) ? (A)0 : (A)lf;
  }

  int kend = Tk;
  if (causal) {
    const long long last_q = qo + min(t0 + WARPS, Tq) - 1;
    kend = (int)max(0LL, min((long long)Tk, last_q - ko + 1));
  }
  const T* kb = k + (size_t)bkv * Tk * D;
  const T* vb = v + (size_t)bkv * Tk * D;
  A acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = 0;

  for (int j0 = 0; j0 < kend; j0 += TILE) {
    const int n = min(TILE, kend - j0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * D; i += NT) {
      const int r = i / D, c = i - r * D;
      ks[r * Dp + c] = kb[(size_t)j0 * D + i];
      vs[r * Dp + c] = vb[(size_t)j0 * D + i];
    }
    __syncthreads();
    if (!row_ok) continue;
    A ds = 0;
    if (lane < n && (!causal || qo + t >= ko + j0 + lane)) {
      const T* kr = ks + lane * Dp;
      const T* vr = vs + lane * Dp;
      A s = 0, dp = 0;
      for (int d = 0; d < D; ++d) {
        s += myq[d] * to_acc(kr[d]);
        dp += mydo[d] * to_acc(vr[d]);
      }
      const A p = exp_(s * scale - L);
      ds = p * (dp - dlt) * scale;
    }
    for (int jj = 0; jj < n; ++jj) {
      const A dsj = __shfl_sync(FULL, ds, jj);
      const T* kr = ks + jj * Dp;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int d = lane + 32 * e;
        if (d < D) acc[e] += dsj * to_acc(kr[d]);
      }
    }
  }
  if (!row_ok) return;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int d = lane + 32 * e;
    if (d < D) dq[row * D + d] = acc[e];
  }
}

template <typename T> struct DkvSmem {
  using A = typename Acc<T>::type;
  __host__ __device__ static size_t tile(int D) { return FwdSmem<T>::tile(D); }
  __host__ __device__ static size_t rows(int D) {
    return align16(2 * (size_t)TILE * sizeof(float));   // lse, delta
  }
  __host__ __device__ static size_t bytes(int D) {
    return 2 * tile(D) + rows(D) + 2 * (size_t)WARPS * D * sizeof(A);
  }
};

template <typename T, int NE>
__global__ void __launch_bounds__(NT) dkv_general_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ q_off,
    const int* __restrict__ k_off, typename Acc<T>::type* __restrict__ dk,
    typename Acc<T>::type* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
    int D, double scale_d, int causal) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = row_stride<T>(D);
  const size_t tile = DkvSmem<T>::tile(D);
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + tile);
  float* ls = reinterpret_cast<float*>(smem + 2 * tile);
  float* dls = ls + TILE;
  A* kvs = reinterpret_cast<A*>(smem + 2 * tile + DkvSmem<T>::rows(D));
  const A scale = (A)scale_d;

  const int bkv = blockIdx.x, b = bkv / Hkv, g = bkv % Hkv;
  const int rep = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0c = blockIdx.y * WARPS, j = j0c + warp;
  const bool row_ok = j < Tk;
  const long long qo = q_off[0], ko = k_off[0];
  A* myk = kvs + warp * 2 * D;
  A* myv = myk + D;
  if (row_ok)
    for (int d = lane; d < D; d += 32) {
      myk[d] = to_acc(k[((size_t)bkv * Tk + j) * D + d]);
      myv[d] = to_acc(v[((size_t)bkv * Tk + j) * D + d]);
    }
  // causal: the first query that sees the CTA's first key
  int tstart = 0;
  if (causal)
    tstart = (int)min((long long)Tq, max(0LL, ko + j0c - qo));

  A adk[NE], adv[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) adk[e] = adv[e] = 0;

  for (int r = 0; r < rep; ++r) {
    const int bh = b * H + g * rep + r;
    const T* qb = q + (size_t)bh * Tq * D;
    const T* db = dout + (size_t)bh * Tq * D;
    for (int t0 = tstart; t0 < Tq; t0 += TILE) {
      const int n = min(TILE, Tq - t0);
      __syncthreads();
      for (int i = threadIdx.x; i < n * D; i += NT) {
        const int rr = i / D, c = i - rr * D;
        qs[rr * Dp + c] = qb[(size_t)t0 * D + i];
        dos[rr * Dp + c] = db[(size_t)t0 * D + i];
      }
      if (threadIdx.x < n) {
        ls[threadIdx.x] = lse[(size_t)bh * Tq + t0 + threadIdx.x];
        dls[threadIdx.x] = delta[(size_t)bh * Tq + t0 + threadIdx.x];
      }
      __syncthreads();
      if (!row_ok) continue;
      A p = 0, ds = 0;
      if (lane < n && (!causal || qo + t0 + lane >= ko + j)) {
        const T* qr = qs + lane * Dp;
        const T* dr = dos + lane * Dp;
        A s = 0, dp = 0;
        for (int d = 0; d < D; ++d) {
          s += to_acc(qr[d]) * myk[d];
          dp += to_acc(dr[d]) * myv[d];
        }
        const float lf = ls[lane];
        const A L = (isinf(lf) && lf < 0) ? (A)0 : (A)lf;
        p = exp_(s * scale - L);
        ds = p * (dp - (A)dls[lane]) * scale;
      }
      for (int tt = 0; tt < n; ++tt) {
        const A pt = __shfl_sync(FULL, p, tt);
        const A dst = __shfl_sync(FULL, ds, tt);
        const T* qr = qs + tt * Dp;
        const T* dr = dos + tt * Dp;
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const int d = lane + 32 * e;
          if (d < D) {
            adv[e] += pt * to_acc(dr[d]);
            adk[e] += dst * to_acc(qr[d]);
          }
        }
      }
    }
  }
  if (!row_ok) return;
  const size_t row = (size_t)bkv * Tk + j;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int d = lane + 32 * e;
    if (d < D) {
      dk[row * D + d] = adk[e];
      dv[row * D + d] = adv[e];
    }
  }
}

bool shapes_ok(int B, int H, int Hkv, int Tq, int Tk, int D) {
  return B >= 0 && H > 0 && Hkv > 0 && H % Hkv == 0 && Tq >= 0 && Tk >= 0 &&
         D >= 1 && D <= MAX_D && (Tq + WARPS - 1) / WARPS <= 65535 &&
         (Tk + WARPS - 1) / WARPS <= 65535;
}

template <typename T, int NE>
int launch_fwd(const void* q, const void* k, const void* v, const int* qo,
               const int* ko, void* o, float* lse, int B, int H, int Hkv,
               int Tq, int Tk, int D, double scale, int causal,
               cudaStream_t s) {
  const size_t smem = FwdSmem<T>::bytes(D);
  auto kern = fwd_general_kernel<T, NE>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + WARPS - 1) / WARPS);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qo, ko, static_cast<T*>(o), lse, H, Hkv, Tq,
      Tk, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int NE>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* o, const float* lse, const float* dlse,
              float* delta, const int* qo, const int* ko, void* dq, int B,
              int H, int Hkv, int Tq, int Tk, int D, double scale,
              int causal, cudaStream_t s) {
  using A = typename Acc<T>::type;
  const size_t smem = DqSmem<T>::bytes(D);
  auto kern = dq_general_kernel<T, NE>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + WARPS - 1) / WARPS);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const T*>(o), lse, dlse, delta, qo, ko,
      static_cast<A*>(dq), H, Hkv, Tq, Tk, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int NE>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* qo,
               const int* ko, void* dk, void* dv, int B, int H, int Hkv,
               int Tq, int Tk, int D, double scale, int causal,
               cudaStream_t s) {
  using A = typename Acc<T>::type;
  const size_t smem = DkvSmem<T>::bytes(D);
  auto kern = dkv_general_kernel<T, NE>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hkv, (Tk + WARPS - 1) / WARPS);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, qo,
      ko, static_cast<A*>(dk), static_cast<A*>(dv), H, Hkv, Tq, Tk, D, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// o (B*H, T, D) in the input dtype and lse (B*H, T) float32.
extern "C" int mx_flash_fwd_general(const void* q, const void* k,
                                    const void* v, const void* q_off,
                                    const void* k_off, void* o, void* lse,
                                    int B, int H, int Hkv, int Tq, int Tk,
                                    int D, double scale, int causal,
                                    int dtype, void* stream) {
  if (!shapes_ok(B, H, Hkv, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return MXG_DISPATCH(dtype, D, launch_fwd, q, k, v,
                      static_cast<const int*>(q_off),
                      static_cast<const int*>(k_off), o,
                      static_cast<float*>(lse), B, H, Hkv, Tq, Tk, D, scale,
                      causal, s);
}

// dq (B*H, T, D) in the accumulation type.  With `o` (non-null) delta =
// rowsum(dO o O) - dlse (`dlse` may be null) is computed for each row and
// written into `delta`; with `o` null `delta` is read.
extern "C" int mx_flash_bwd_dq_general(
    const void* q, const void* k, const void* v, const void* dout,
    const void* o, const void* lse, const void* dlse, void* delta,
    const void* q_off, const void* k_off, void* dq, int B, int H, int Hkv,
    int Tq, int Tk, int D, double scale, int causal, int dtype,
    void* stream) {
  if (!shapes_ok(B, H, Hkv, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return MXG_DISPATCH(dtype, D, launch_dq, q, k, v, dout, o,
                      static_cast<const float*>(lse),
                      static_cast<const float*>(dlse),
                      static_cast<float*>(delta),
                      static_cast<const int*>(q_off),
                      static_cast<const int*>(k_off), dq, B, H, Hkv, Tq, Tk,
                      D, scale, causal, s);
}

// dk, dv (B*Hkv, Tk, D) in the accumulation type, the GQA group's query
// heads summed.
extern "C" int mx_flash_bwd_dkv_general(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* q_off, const void* k_off,
    void* dk, void* dv, int B, int H, int Hkv, int Tq, int Tk, int D,
    double scale, int causal, int dtype, void* stream) {
  if (!shapes_ok(B, H, Hkv, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tk == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return MXG_DISPATCH(dtype, D, launch_dkv, q, k, v, dout,
                      static_cast<const float*>(lse),
                      static_cast<const float*>(delta),
                      static_cast<const int*>(q_off),
                      static_cast<const int*>(k_off), dk, dv, B, H, Hkv, Tq,
                      Tk, D, scale, causal, s);
}
