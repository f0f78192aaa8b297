// General paged decode attention for every dtype, head_dim, page size and
// GQA ratio the reference takes.
//
// Replaces, for every input the Hopper kernel (paged_decode.cu: bf16,
// head_dim 64 or 128, a page size that is a multiple of 16, at most 8
// query heads per kv head) does not take, the Pallas TPU kernel
// `_paged_kernel_call` of mxnet_tpu/ops/pallas_ops.py (:621, pallas_call
// at :696) and the dense fallback the reference takes for other page
// sizes and head dims (`_paged_dense`).  One query token per batch slot
// attends over that slot's first `lengths[s]` cached positions, which
// live in pages of a shared pool addressed through a page table; the
// rep = H / Hkv query heads of a kv head read the same pages.  Inputs
// are float16, bfloat16, float32 or float64, any head_dim D in 1..256,
// any page size >= 1, any rep; sums in float32 (float64 for float64).
// A slot with length 0 returns zeros.  Page ids and lengths are trusted,
// except that a length past the table's MP * page_size positions stops
// there, as the plain version's mask does.
//
// What bounds it on this card: bytes, at serving sizes -- each live K/V
// element is used for 2 * rep multiply-adds -- but this first version
// runs on the CUDA cores with one CTA per (slot, kv head, group of 8
// query heads) and no split over the keys; splitting, cp.async and
// tensor cores are later work.
//
// Design: the CTA's 8 warps each take one query head of the group.
// Keys are staged 32 positions at a time in shared memory (each
// position's page looked up in the table, so any page size works,
// 1 included), shared by the warps.  Lane l scores staged key l, the
// warp keeps an online softmax with a warp-uniform running max, and each
// lane accumulates the D / 32 output elements it owns, the weights
// passed by warp shuffles (as in flash_general.cu).
//
// Layouts (all contiguous): q, out (S, H, D); pools (P, Hkv, psz, D);
// page_table (S, MP) int32; lengths (S,) int32.

#include "general.cuh"

namespace {

using namespace mxg;

template <typename T> struct PagedSmem {
  using A = typename Acc<T>::type;
  __host__ __device__ static size_t tile(int D) {
    return align16((size_t)TILE * row_stride<T>(D) * sizeof(T));
  }
  __host__ __device__ static size_t bytes(int D) {
    return 2 * tile(D) + (size_t)WARPS * D * sizeof(A);
  }
};

template <typename T, int NE>
__global__ void __launch_bounds__(NT) paged_general_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ page_table,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int Hkv,
    int psz, int D, int MP, double scale_d) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = row_stride<T>(D);
  const size_t tile = PagedSmem<T>::tile(D);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + tile);
  A* qs = reinterpret_cast<A*>(smem + 2 * tile);
  const A scale = (A)scale_d;
  const A NEG = -INFINITY;

  const int s = blockIdx.x / Hkv, g = blockIdx.x % Hkv;
  const int rep = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.y * WARPS + warp;
  const bool head_ok = r < rep;
  const int h = g * rep + r;
  A* myq = qs + warp * D;
  if (head_ok)
    for (int d = lane; d < D; d += 32)
      myq[d] = to_acc(q[((size_t)s * H + h) * D + d]);
  const long long cap = (long long)MP * psz;
  const int len = (int)max(0LL, min((long long)lengths[s], cap));
  const int* pt = page_table + (size_t)s * MP;

  A m = NEG, lpart = 0, acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = 0;

  for (int p0 = 0; p0 < len; p0 += TILE) {
    const int n = min(TILE, len - p0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * D; i += NT) {
      const int rr = i / D, c = i - rr * D;
      const int pos = p0 + rr;
      const size_t src =
          (((size_t)pt[pos / psz] * Hkv + g) * psz + pos % psz) * D + c;
      ks[rr * Dp + c] = kp[src];
      vs[rr * Dp + c] = vp[src];
    }
    __syncthreads();
    if (!head_ok) continue;
    A sc = NEG;
    if (lane < n) {
      const T* kr = ks + lane * Dp;
      A dot = 0;
      for (int d = 0; d < D; ++d) dot += myq[d] * to_acc(kr[d]);
      sc = dot * scale;
    }
    const A m_new = max_(m, warp_max(sc));
    const A corr = (m == NEG) ? (A)0 : exp_(m - m_new);
    const A p = (sc == NEG) ? (A)0 : exp_(sc - m_new);
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
  if (!head_ok) return;
  const A l = warp_sum(lpart);
  T* orow = out + ((size_t)s * H + h) * D;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int d = lane + 32 * e;
    if (d < D) orow[d] = from_acc<T>(l == 0 ? (A)0 : acc[e] / l);
  }
}

template <typename T, int NE>
int launch(const void* q, const void* kp, const void* vp, const int* pt,
           const int* ln, void* out, int S, int H, int Hkv, int psz, int D,
           int MP, double scale, cudaStream_t st) {
  const size_t smem = PagedSmem<T>::bytes(D);
  auto kern = paged_general_kernel<T, NE>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int rep = H / Hkv;
  dim3 grid(S * Hkv, (rep + WARPS - 1) / WARPS);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, ln, static_cast<T*>(out), H, Hkv, psz,
      D, MP, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mx_paged_decode_general(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const void* page_table,
                                       const void* lengths, void* out, int S,
                                       int H, int Hkv, int psz, int D, int MP,
                                       double scale, int dtype,
                                       void* stream) {
  if (S < 0 || Hkv <= 0 || H <= 0 || H % Hkv != 0 || psz <= 0 || MP <= 0 ||
      (H / Hkv + WARPS - 1) / WARPS > 65535)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return MXG_DISPATCH(dtype, D, launch, q, k_pages, v_pages,
                      static_cast<const int*>(page_table),
                      static_cast<const int*>(lengths), out, S, H, Hkv, psz,
                      D, MP, scale, st);
}
