// Paged decode attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel `_paged_kernel_call` in
// mxnet_tpu/ops/pallas_ops.py (its pallas_call at :696): one query
// token per batch slot attends over that slot's KV cache, which lives in
// fixed-size pages of a shared pool addressed through a page table.  An
// online softmax runs across pages; keys past the slot's length are
// never read; a slot of length 0 returns zeros.  GQA: the rep query
// heads of one kv head form one tile, so each K/V byte is read once for
// all of them.
//
// What bounds it on this card: bytes.  Each live K/V element (bf16) is
// used for 2 * rep flops of scores and 2 * rep of P V -- 8 flops per
// 2 bytes at rep = 4, far below the H100's ~295 flop/byte ridge -- so
// the floor is the live pages' bytes over 3.35 TB/s.  At serving sizes
// (8 slots of a few hundred tokens) that floor is a few microseconds,
// so what counts is latency: enough CTAs in flight, and loads that do
// not wait on each other.
//
// What the design does about it (flash-decoding):
// * Split.  Each (slot, kv head) is split over `nsplit` CTAs, each on a
//   contiguous range of `kps` key positions (a whole number of chunks
//   of `ch` keys; a chunk never straddles a page).  The plan comes from
//   the host (`cuda_ops.paged_split_plan`) and depends on S, Hkv, MP and
//   the page size only, never on `lengths`, so sizing the grid needs no
//   device-to-host read.  A CTA whose range starts past its slot's
//   length exits at once.
// * Double buffering.  A CTA walks its chunks with 16-byte cp.async
//   into two K/V buffers: chunk i + 1 is in flight while chunk i is
//   computed.  Rows are padded by 16 bytes (D + 8 elements), which keeps
//   them 16-byte aligned for cp.async and the score fragment loads
//   conflict free.
// * Scores on the tensor cores.  S = Q K^T runs as mma.sync m16n8k16
//   with the rep query heads padded to 16 rows (rows >= rep are zero),
//   K fragments read straight from the padded rows.  Softmax and P V
//   stay in fp32 on the CUDA cores: P is NOT rounded to bf16 before
//   P V, where the JAX kernel rounds it (pallas_ops.py:669); the port
//   keeps fp32, so its output differs from the plain version only by
//   the final bf16 rounding.
// * Deterministic merge.  Each split writes its unnormalised fp32
//   (m, l, acc) to scratch the wrapper allocates; a second small kernel
//   merges the live splits of each (slot, head) in split order, so two
//   calls give the same bits.  The wrapper counts the pair as one
//   launch.
// Scores are kept in the log2 domain (scale * log2(e) folded in once)
// so the softmax uses exp2f.
//
// Shapes: page_size a multiple of 16, D in {64, 128}, H % Hkv == 0,
// rep = H / Hkv <= 8.  Layouts (all contiguous): q (S, H, D); pools
// (P, Hkv, page_size, D); page_table (S, MP) int32; lengths (S,) int32;
// out (S, H, D); scratch acc (S, H, nsplit, D) and ml (S, H, nsplit, 2)
// float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXCH = 64;       // most keys per chunk
constexpr int NTHREADS = 128;   // 4 warps
constexpr int MAX_REP = 8;      // query heads per kv head
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
constexpr int smem_bytes() {
  return 4 * MAXCH * (D + 8) * 2 + MAXCH * MAX_REP * 4;
}

// Issue the cp.async copies of the live rows of one chunk into buffer
// `buf` and commit them as one group.
template <int D>
__device__ __forceinline__ void load_chunk(
    __nv_bfloat16* Ks, __nv_bfloat16* Vs, const __nv_bfloat16* kp,
    const __nv_bfloat16* vp, const int* pt_row, int kvh, int Hkv, int psz,
    int pos, int nv, int buf) {
  constexpr int RS = D + 8;
  const int page = pt_row[pos / psz];
  const size_t base =
      (((size_t)page * Hkv + kvh) * psz + (size_t)(pos % psz)) * D;
  __nv_bfloat16* kd = Ks + buf * MAXCH * RS;
  __nv_bfloat16* vd = Vs + buf * MAXCH * RS;
  for (int e = threadIdx.x; e < nv * (D / 8); e += NTHREADS) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    cp_async16(kd + r * RS + c, kp + base + (size_t)r * D + c);
    cp_async16(vd + r * RS + c, vp + base + (size_t)r * D + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ kp,
                          const __nv_bfloat16* __restrict__ vp,
                          const int* __restrict__ page_table,
                          const int* __restrict__ lengths,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int H, int Hkv,
                          int psz, int MP, int nsplit, int kps, int ch,
                          float scale_log2) {
  constexpr int RS = D + 8;                  // smem row stride (elements)
  constexpr int NRG = NTHREADS / (D / 2);    // row groups in the P V pass
  constexpr int RPT = MAX_REP / NRG;         // rows per thread (P V)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + 2 * MAXCH * RS;
  float* ps = reinterpret_cast<float*>(Vs + 2 * MAXCH * RS);  // [key][row]
  __shared__ float m_s[MAX_REP], l_s[MAX_REP], a_s[MAX_REP];

  const int split = blockIdx.x, kvh = blockIdx.y, slot = blockIdx.z;
  const int rep = H / Hkv;
  const int len = min(lengths[slot], MP * psz);  // as the plain mask does
  const int k_begin = split * kps;
  if (k_begin >= len) return;                    // the merge skips it
  const int k_end = min(k_begin + kps, len);
  const int nch = (k_end - k_begin + ch - 1) / ch;
  const int* pt_row = page_table + (size_t)slot * MP;

  load_chunk<D>(Ks, Vs, kp, vp, pt_row, kvh, Hkv, psz, k_begin,
                min(ch, k_end - k_begin), 0);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  if (tid < MAX_REP) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  // Q as mma A fragments: row g is query head g of the group (zero past
  // rep), rows g + 8 are padding and stay zero
  const __nv_bfloat16* qb = q + ((size_t)slot * H + (size_t)kvh * rep) * D;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = g < rep ? ld_u32(qb + g * D + c) : 0u;
    qf[kk][2] = g < rep ? ld_u32(qb + g * D + c + 8) : 0u;
    qf[kk][1] = qf[kk][3] = 0u;
  }
  // P V accumulator: thread owns columns 2 cp, 2 cp + 1 of rows
  // rh * RPT .. rh * RPT + RPT - 1
  const int cp = tid % (D / 2), rh = tid / (D / 2);
  float acc[RPT][2];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j][0] = acc[j][1] = 0.f;

  for (int i = 0; i < nch; ++i) {
    const int buf = i & 1;
    const int pos = k_begin + i * ch;
    const int nv = min(ch, k_end - pos);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // chunk i has landed for every thread, and chunk i - 1's buffer and
    // P are no longer read: the next load may overwrite it
    __syncthreads();
    if (i + 1 < nch)
      load_chunk<D>(Ks, Vs, kp, vp, pt_row, kvh, Hkv, psz, pos + ch,
                    min(ch, k_end - pos - ch), buf ^ 1);

    // scores: warp w takes the 8-key tiles w, w + 4 of the chunk
    const __nv_bfloat16* kb = Ks + buf * MAXCH * RS;
    for (int nt = warp; nt < ch / 8; nt += NTHREADS / 32) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* krow = kb + (nt * 8 + g) * RS + tig * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(c, qf[kk], ld_u32(krow + kk * 16), ld_u32(krow + kk * 16 + 8));
      if (g < rep) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = nt * 8 + tig * 2 + e;
          ps[key * MAX_REP + g] = key < nv ? c[e] * scale_log2 : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 4; lanes take keys
    for (int r = warp; r < rep; r += NTHREADS / 32) {
      const float s0 = lane < ch ? ps[lane * MAX_REP + r] : -INFINITY;
      const float s1 = lane + 32 < ch ? ps[(lane + 32) * MAX_REP + r] : -INFINITY;
      float mc = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffff, mc, off));
      const float mprev = m_s[r];
      const float mnew = fmaxf(mprev, mc);
      const float msafe = mnew == -INFINITY ? 0.f : mnew;
      const float p0 = exp2f(s0 - msafe), p1 = exp2f(s1 - msafe);
      float ls = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ls += __shfl_xor_sync(0xffffffff, ls, off);
      if (lane < ch) ps[lane * MAX_REP + r] = p0;
      if (lane + 32 < ch) ps[(lane + 32) * MAX_REP + r] = p1;
      if (lane == 0) {
        const float alpha = mprev == -INFINITY ? 0.f : exp2f(mprev - msafe);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + ls;
        m_s[r] = mnew;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over the live keys of the chunk (rows past
    // nv were never loaded, so they are never read)
    const __nv_bfloat16* vb = Vs + buf * MAXCH * RS + 2 * cp;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const float a = rh * RPT + j < rep ? a_s[rh * RPT + j] : 0.f;
      acc[j][0] *= a;
      acc[j][1] *= a;
    }
    for (int c = 0; c < nv; ++c) {
      const float2 v2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vb + c * RS));
      const float* pr = ps + c * MAX_REP + rh * RPT;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        acc[j][0] += pr[j] * v2.x;
        acc[j][1] += pr[j] * v2.y;
      }
    }
  }

  // this split's unnormalised (m, l, acc), m in the log2 domain
  const size_t row0 = (size_t)slot * H + (size_t)kvh * rep;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = rh * RPT + j;
    if (r < rep) {
      float* dst = part_acc + ((row0 + r) * nsplit + split) * D + 2 * cp;
      *reinterpret_cast<float2*>(dst) = make_float2(acc[j][0], acc[j][1]);
    }
  }
  if (tid < rep) {
    float* ml = part_ml + ((row0 + tid) * nsplit + split) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// One CTA of D threads per (slot, head): merge the live splits in split
// order, so the result does not depend on which split finished first.
template <int D>
__global__ void __launch_bounds__(D)
paged_decode_merge_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ lengths,
                          __nv_bfloat16* __restrict__ out, int H, int psz,
                          int MP, int nsplit, int kps) {
  const int sh = blockIdx.x;                 // slot * H + head
  const int d = threadIdx.x;
  const int len = min(lengths[sh / H], MP * psz);
  const int live = (len + kps - 1) / kps;    // splits that hold a key
  const float* ml = part_ml + (size_t)sh * nsplit * 2;
  const float* pa = part_acc + (size_t)sh * nsplit * D + d;
  float m = -INFINITY;
  for (int i = 0; i < live; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f, a = 0.f;
  for (int i = 0; i < live; ++i) {
    const float w = exp2f(ml[2 * i] - m);
    l += w * ml[2 * i + 1];
    a += w * pa[(size_t)i * D];
  }
  out[(size_t)sh * D + d] = __float2bfloat16(l == 0.f ? 0.f : a / l);
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* kp,
           const __nv_bfloat16* vp, const int* pt, const int* ln,
           __nv_bfloat16* out, float* pacc, float* pml, int S, int H, int Hkv,
           int psz, int MP, int nsplit, int kps, int ch, float scale,
           cudaStream_t s) {
  constexpr int SMEM = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_split_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  paged_decode_split_kernel<D><<<dim3(nsplit, Hkv, S), NTHREADS, SMEM, s>>>(
      q, kp, vp, pt, ln, pacc, pml, H, Hkv, psz, MP, nsplit, kps, ch,
      scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge_kernel<D><<<S * H, D, 0, s>>>(pacc, pml, ln, out, H, psz,
                                                   MP, nsplit, kps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mx_paged_decode(const void* q, const void* k_pages,
                               const void* v_pages, const void* page_table,
                               const void* lengths, void* out, void* part_acc,
                               void* part_ml, int S, int H, int Hkv, int psz,
                               int D, int MP, int nsplit, int kps, int ch,
                               float scale, void* stream) {
  if (S <= 0 || S > 65535 || Hkv <= 0 || Hkv > 65535 || H % Hkv != 0 ||
      H / Hkv > MAX_REP || psz <= 0 || psz % 16 != 0 || MP <= 0 ||
      (ch != 16 && ch != 32 && ch != MAXCH) || psz % ch != 0 || kps <= 0 ||
      kps % ch != 0 || nsplit <= 0 || (long long)nsplit * kps < (long long)MP * psz ||
      (long long)(nsplit - 1) * kps >= (long long)MP * psz)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto qp = static_cast<const __nv_bfloat16*>(q);
  auto kp = static_cast<const __nv_bfloat16*>(k_pages);
  auto vp = static_cast<const __nv_bfloat16*>(v_pages);
  auto pt = static_cast<const int*>(page_table);
  auto ln = static_cast<const int*>(lengths);
  auto op = static_cast<__nv_bfloat16*>(out);
  auto pa = static_cast<float*>(part_acc);
  auto pm = static_cast<float*>(part_ml);
  if (D == 128)
    return launch<128>(qp, kp, vp, pt, ln, op, pa, pm, S, H, Hkv, psz, MP,
                       nsplit, kps, ch, scale, s);
  if (D == 64)
    return launch<64>(qp, kp, vp, pt, ln, op, pa, pm, S, H, Hkv, psz, MP,
                      nsplit, kps, ch, scale, s);
  return (int)cudaErrorInvalidValue;
}
