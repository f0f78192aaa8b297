// General paged decode attention for every dtype, head_dim, page size and
// GQA ratio the reference takes, split over the keys.
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
// What bounds it on this card: bytes.  Each live K/V element is used
// for 2 * rep multiply-adds (rep 4 at the serving shape: 8 flops per 4
// bytes of float32), far below the card's flop / byte ridge, so the
// floor is the live K/V bytes over 3.35 TB/s: a few microseconds at
// serving lengths.  What counts is latency: enough CTAs in flight, each
// K/V byte read once, and loads that do not wait on each other.
//
// What the design does about it (flash-decoding, as paged_decode.cu):
// * Split.  Each (slot, kv head) is split over `nsplit` CTAs, each on a
//   contiguous range of `kps` key positions.  The plan comes from the
//   host (`cuda_ops.paged_general_plan`) and depends on the shapes only,
//   never on `lengths`, so sizing the grid needs no device-to-host read.
//   A range may cross pages: each position's page is looked up, so any
//   page size works, 1 included.  A CTA whose range starts past its
//   slot's length exits at once.
// * One CTA scores all query heads of its kv head (up to 32; a larger
//   group is cut into CTAs of 32) against each staged K/V row, so K/V
//   is read once for the group.  Warp w takes heads w, w + W, ... with
//   W = ceil(heads / ceil(heads / 8)) warps, so no warp idles (rep 4:
//   4 warps, one head each; rep 32: 8 warps, four heads each).
// * Double buffering.  Tiles of 32 positions (16 for rows above 1,040
//   bytes) are copied by cp.async into two K/V stages, tile i + 1 in
//   flight while tile i is computed, the query rows with the first: 16
//   bytes a copy where rows are 16-byte multiples on 16-byte pointers,
//   else 8 or 4, else one element.  Each thread copies one row of a
//   tile, so a row's page is looked up once, not once per element; the
//   first row's page and the slot's length are read together.
// * Per tile and head: lane l scores staged key l (a dot product read
//   16 bytes at a time from a row padded to an odd number of 16-byte
//   units, so 8 lanes' reads fall in 32 different banks), the warp keeps
//   an online softmax with a warp-uniform running max, and each lane
//   adds the weighted V rows to the D / 32 output elements it owns, the
//   weights passed by warp shuffles.
// * Deterministic merge.  Each split writes its unnormalised (m, l,
//   acc) to scratch the wrapper allocates; a second kernel merges the
//   live splits of each (slot, head) in split order, with no atomics, so
//   two calls give the same bits.  The wrapper counts the pair as one
//   launch.
// * Measured on an H100 at the float32 serving shape (8 slots, lengths
//   51-347, 32/8 heads of 128, pages of 128; PERF.md): the split kernel
//   takes ~13.5 us, of which ~5 us go to the K/V bytes and ~1.4 us to
//   the arithmetic, the rest to dependent reads on a cold cache over two
//   waves of CTAs; one stage (all CTAs in one wave), fewer and longer
//   splits, and a split-major grid each ran slower.
//
// Layouts (all contiguous): q, out (S, H, D); pools (P, Hkv, psz, D);
// page_table (S, MP) int32; lengths (S,) int32; scratch acc (S, H,
// nsplit, D) and ml (S, H, nsplit, 2) in the accumulation type.

#include <limits.h>

#include "general.cuh"

namespace {

using namespace mxg;

constexpr int MAX_HEADS = 32;   // query heads a CTA scores
constexpr int ROUNDS = MAX_HEADS / WARPS;   // heads a warp takes, at most

// A staged row: D elements of T padded to an odd number of 16-byte
// units, `ld` elements apart.
template <typename T> __host__ __device__ inline int staged_ld(int D) {
  int units = (D * (int)sizeof(T) + 15) / 16;
  if (units % 2 == 0) ++units;
  return units * 16 / (int)sizeof(T);
}

template <typename T> __host__ __device__ inline int tile_rows(int D) {
  return staged_ld<T>(D) * (int)sizeof(T) <= 1040 ? 32 : 16;
}

// 2 stages x (K, V) x rows, then the CTA's query heads, all staged rows
template <typename T> inline size_t smem_bytes(int D, int heads) {
  return (size_t)(4 * tile_rows<T>(D) + heads) * staged_ld<T>(D) *
         sizeof(T);
}

// 16 bytes of a staged key row times the matching 16 bytes of the
// staged query row, added to four partial sums (in the accumulation
// type), so the dot product is four short chains of multiply-adds, not
// one long one.
__device__ __forceinline__ void dot16(const float* k, const float* q,
                                      float (&s)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(k);
  const float4 y = *reinterpret_cast<const float4*>(q);
  s[0] += x.x * y.x;
  s[1] += x.y * y.y;
  s[2] += x.z * y.z;
  s[3] += x.w * y.w;
}
__device__ __forceinline__ void dot16(const double* k, const double* q,
                                      double (&s)[4]) {
  const double2 x = *reinterpret_cast<const double2*>(k);
  const double2 y = *reinterpret_cast<const double2*>(q);
  s[0] += x.x * y.x;
  s[1] += x.y * y.y;
}
__device__ __forceinline__ float2 to_f2(uint32_t w, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}
__device__ __forceinline__ float2 to_f2(uint32_t w, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
template <typename T>
__device__ __forceinline__ void dot16(const T* k, const T* q,
                                      float (&s)[4]) {
  const uint4 kr = *reinterpret_cast<const uint4*>(k);
  const uint4 qr = *reinterpret_cast<const uint4*>(q);
  const uint32_t kw[4] = {kr.x, kr.y, kr.z, kr.w};
  const uint32_t qw[4] = {qr.x, qr.y, qr.z, qr.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = to_f2(kw[i], T()), y = to_f2(qw[i], T());
    s[i] += x.x * y.x + x.y * y.y;
  }
}

// N bytes from global to shared memory, asynchronously (N = 4, 8, 16)
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(N)
                 : "memory");
}

// A row of D elements, N bytes a copy (0: element by element,
// synchronously), by `tpr` threads of which this is `sub`.
template <int N, typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int D,
                                         int sub, int tpr) {
  if constexpr (N == 0) {
    for (int c = sub; c < D; c += tpr) dst[c] = src[c];
  } else {
    constexpr int E = N > (int)sizeof(T) ? N / (int)sizeof(T) : 1;
    for (int c = sub * E; c < D; c += tpr * E) cp_async<N>(dst + c, src + c);
  }
}

template <typename T>
__device__ __forceinline__ void copy_row(int bytes, T* dst, const T* src,
                                         int D, int sub, int tpr) {
  switch (bytes) {
    case 16: copy_row<16>(dst, src, D, sub, tpr); break;
    case 8: copy_row<8>(dst, src, D, sub, tpr); break;
    case 4: copy_row<4>(dst, src, D, sub, tpr); break;
    default: copy_row<0>(dst, src, D, sub, tpr);
  }
}

template <typename T, int NE>
__global__ void __launch_bounds__(NT) paged_general_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ page_table,
    const int* __restrict__ lengths, typename Acc<T>::type* __restrict__ pacc,
    typename Acc<T>::type* __restrict__ pml, int H, int Hkv, int psz, int D,
    int MP, int nsplit, int kps, int ngrp, int copy_bytes, double scale_d) {
  using A = typename Acc<T>::type;
  constexpr int VEC = 16 / (int)sizeof(T);   // elements per 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = staged_ld<T>(D), TK = tile_rows<T>(D);
  T* ks = reinterpret_cast<T*>(smem);           // [2][TK][ld]
  T* vs = ks + 2 * TK * ld;                     // [2][TK][ld]
  T* qs = vs + 2 * TK * ld;                     // [heads][ld]
  const A scale = (A)scale_d;
  const A NEG = -INFINITY;

  // blockIdx.x = ((slot * Hkv + g) * ngrp + grp) * nsplit + split
  int rest = blockIdx.x;
  const int split = rest % nsplit;
  rest /= nsplit;
  const int grp = rest % ngrp;
  rest /= ngrp;
  const int g = rest % Hkv, slot = rest / Hkv;
  const int rep = H / Hkv;
  const int h0 = g * rep + grp * MAX_HEADS;     // the CTA's first head
  const int heads = min(MAX_HEADS, rep - grp * MAX_HEADS);
  const long long cap = (long long)MP * psz;
  const int k_begin = split * kps;
  const int* pt = page_table + (size_t)slot * MP;
  const int nthr = blockDim.x, nw = nthr >> 5;
  // thread -> (row of a tile, first copy of the row)
  const int tpr = nthr / TK, row = threadIdx.x / tpr, sub = threadIdx.x % tpr;
  // read together: the page of this thread's row of the first tile (every
  // entry of the table holds a page id) and the slot's length
  const int page0 = pt[min((long long)k_begin + row, cap - 1) / psz];
  const int len = (int)max(0LL, min((long long)lengths[slot], cap));
  if (k_begin >= len) return;                   // the merge skips it
  const int k_end = (int)min((long long)k_begin + kps, (long long)len);
  const int ntile = (k_end - k_begin + TK - 1) / TK;
  const int dlim = (D + VEC - 1) / VEC * VEC;   // D in whole 16 bytes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  auto load_tile = [&](int it, int st) {
    const int pos = k_begin + it * TK + row;
    if (pos < k_end) {
      const int page = it == 0 ? page0 : pt[pos / psz];
      const size_t src = (((size_t)page * Hkv + g) * psz + pos % psz) * D;
      const size_t at = ((size_t)st * TK + row) * ld;
      copy_row(copy_bytes, ks + at, kp + src, D, sub, tpr);
      copy_row(copy_bytes, vs + at, vp + src, D, sub, tpr);
    }
    if (it == 0)                      // the query rows with the first tile
      for (int r = row; r < heads; r += TK)
        copy_row(copy_bytes, qs + (size_t)r * ld,
                 q + ((size_t)slot * H + h0 + r) * D, D, sub, tpr);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_tile(0, 0);
  // while it lands: zero the pad columns of every staged row
  for (int i = threadIdx.x; i < (4 * TK + heads) * (ld - D); i += nthr) {
    const int r = i / (ld - D);
    ks[(size_t)r * ld + D + (i - r * (ld - D))] = from_acc<T>((A)0);
  }

  // warp w: heads w + nw * r of the CTA, r < ROUNDS
  A m[ROUNDS], lpart[ROUNDS], acc[ROUNDS][NE];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    m[r] = NEG;
    lpart[r] = 0;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[r][e] = 0;
  }

  for (int it = 0; it < ntile; ++it) {
    const int st = it & 1;
    if (it + 1 < ntile) {
      load_tile(it + 1, st ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int n = min(TK, k_end - (k_begin + it * TK));
    const T* kt = ks + (size_t)st * TK * ld;
    const T* vt = vs + (size_t)st * TK * ld;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int hl = warp + nw * r;
      if (hl >= heads) continue;                // warp-uniform
      const T* qr = qs + (size_t)hl * ld;
      A sc = NEG;
      if (lane < n) {
        const T* kr = kt + (size_t)lane * ld;
        A part[4] = {0, 0, 0, 0};
#pragma unroll 4
        for (int c = 0; c < dlim; c += VEC) dot16(kr + c, qr + c, part);
        sc = ((part[0] + part[1]) + (part[2] + part[3])) * scale;
      }
      const A m_new = max_(m[r], warp_max(sc));
      const A corr = (m[r] == NEG) ? (A)0 : exp_(m[r] - m_new);
      const A p = (lane < n) ? exp_(sc - m_new) : (A)0;
      lpart[r] = lpart[r] * corr + p;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[r][e] *= corr;
#pragma unroll 8
      for (int jj = 0; jj < n; ++jj) {
        const A pj = __shfl_sync(FULL, p, jj);
        const T* vr = vt + (size_t)jj * ld;
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const int d = lane + 32 * e;
          if (d < D) acc[r][e] += pj * to_acc(vr[d]);
        }
      }
      m[r] = m_new;
    }
    __syncthreads();    // the stage is refilled in the next iteration
  }

  // this split's unnormalised (m, l, acc)
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int hl = warp + nw * r;
    if (hl >= heads) continue;
    const A l = warp_sum(lpart[r]);
    const size_t at = ((size_t)slot * H + h0 + hl) * nsplit + split;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) pacc[at * D + d] = acc[r][e];
    }
    if (lane == 0) {
      pml[2 * at] = m[r];
      pml[2 * at + 1] = l;
    }
  }
}

// One CTA per (slot, head), a thread per output element: the live
// splits merged in split order, so the result does not depend on which
// split finished first.  Every split's partials are read, MB at a time,
// in parallel with the slot's length (scratch past the live splits is
// read but never used), so the merge waits on one round of loads.
template <typename T>
__global__ void paged_general_merge_kernel(
    const typename Acc<T>::type* __restrict__ pacc,
    const typename Acc<T>::type* __restrict__ pml,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int psz,
    int D, int MP, int nsplit, int kps) {
  using A = typename Acc<T>::type;
  constexpr int MB = 16;
  const int sh = blockIdx.x;                 // slot * H + head
  const int d = threadIdx.x;
  if (d >= D) return;
  const long long cap = (long long)MP * psz;
  const int slen = lengths[sh / H];
  const A* ml = pml + (size_t)sh * nsplit * 2;
  const A* pa = pacc + (size_t)sh * nsplit * D + d;
  A m = -INFINITY, l = 0, a = 0;
  for (int i0 = 0; i0 < nsplit; i0 += MB) {
    A mi[MB], li[MB], ai[MB];
#pragma unroll
    for (int j = 0; j < MB; ++j)
      if (i0 + j < nsplit) {
        mi[j] = ml[2 * (i0 + j)];
        li[j] = ml[2 * (i0 + j) + 1];
        ai[j] = pa[(size_t)(i0 + j) * D];
      }
    const long long len = max(0LL, min((long long)slen, cap));
    const int live = (int)((len + kps - 1) / kps);   // splits with a key
    // each live split holds a key, so its m is finite
#pragma unroll
    for (int j = 0; j < MB; ++j)
      if (i0 + j < live) {
        const A mn = max_(m, mi[j]);
        const A c = exp_(m - mn), w = exp_(mi[j] - mn);
        l = l * c + w * li[j];
        a = a * c + w * ai[j];
        m = mn;
      }
  }
  out[(size_t)sh * D + d] = from_acc<T>(l == 0 ? (A)0 : a / l);
}

template <typename T, int NE>
int launch(const void* q, const void* kp, const void* vp, const int* pt,
           const int* ln, void* out, void* pacc, void* pml, int S, int H,
           int Hkv, int psz, int D, int MP, int nsplit, int kps,
           double scale, cudaStream_t st) {
  using A = typename Acc<T>::type;
  const int rep = H / Hkv;
  const int ngrp = (rep + MAX_HEADS - 1) / MAX_HEADS;
  const int heads = min(rep, MAX_HEADS);
  const size_t smem = smem_bytes<T>(D, heads);
  auto kern = paged_general_split_kernel<T, NE>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int rounds = (heads + WARPS - 1) / WARPS;
  const int warps = (heads + rounds - 1) / rounds;
  const long long blocks = (long long)S * Hkv * ngrp * nsplit;
  if (blocks > INT_MAX || (long long)S * H > INT_MAX)
    return (int)cudaErrorInvalidValue;
  // the widest copy (16, 8 or 4 bytes, at least one element) that
  // divides every row and the alignment of q and both pools; else
  // element by element
  const size_t row = (size_t)D * sizeof(T);
  const uintptr_t base = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(kp) |
                         reinterpret_cast<uintptr_t>(vp);
  int copy_bytes = 0;
  for (int n = 16; n >= (int)sizeof(T) && n >= 4 && !copy_bytes; n /= 2)
    if (row % n == 0 && base % n == 0) copy_bytes = n;
  kern<<<(unsigned)blocks, 32 * warps, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, ln, static_cast<A*>(pacc),
      static_cast<A*>(pml), H, Hkv, psz, D, MP, nsplit, kps, ngrp,
      copy_bytes, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_general_merge_kernel<T><<<(unsigned)((long long)S * H),
                                  (D + 31) / 32 * 32, 0, st>>>(
      static_cast<const A*>(pacc), static_cast<const A*>(pml), ln,
      static_cast<T*>(out), H, psz, D, MP, nsplit, kps);
  return (int)cudaGetLastError();
}

}  // namespace

// out (S, H, D) in the input dtype; part_acc (S, H, nsplit, D) and
// part_ml (S, H, nsplit, 2) scratch in the accumulation type (float64
// for float64, else float32).  Split i covers key positions [i * kps,
// (i + 1) * kps) of the MP * psz a slot can hold.
extern "C" int mx_paged_decode_general(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* part_acc,
    void* part_ml, int S, int H, int Hkv, int psz, int D, int MP, int nsplit,
    int kps, double scale, int dtype, void* stream) {
  if (S < 0 || Hkv <= 0 || H <= 0 || H % Hkv != 0 || psz <= 0 || MP <= 0 ||
      nsplit <= 0 || kps <= 0 ||
      (long long)nsplit * kps < (long long)MP * psz ||
      (long long)(nsplit - 1) * kps >= (long long)MP * psz)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return MXG_DISPATCH(dtype, D, launch, q, k_pages, v_pages,
                      static_cast<const int*>(page_table),
                      static_cast<const int*>(lengths), out, part_acc,
                      part_ml, S, H, Hkv, psz, D, MP, nsplit, kps, scale, st);
}
