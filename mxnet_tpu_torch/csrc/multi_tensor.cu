// Multi-tensor optimizer updates: one launch over a list of tensors.
//
// Replaces the JAX package's compiled update: `Optimizer._compiled`
// (mxnet_tpu/optimizer/optimizer.py:135-146) jits each rule once with
// buffer donation, and `TrainStep` fuses the whole update into its one
// XLA program (mxnet_tpu/parallel/train_step.py:170-206); and the
// multi-tensor update ops of mxnet_tpu/ndarray/op_updates.py:342-600
// (`multi_sgd_update`, `multi_mp_sgd_*`, `multi_adamw_update`,
// `multi_lamb_update`, ...).  No Pallas kernel is involved.  Four
// kernels:
//   (a) sgd_kernel:   plain SGD, momentum, Nesterov (NAG);
//   (b) adam_kernel:  Adam (wd coupled into g) or AdamW (decoupled),
//                     bias correction as per-tensor reciprocals;
//   (c) lamb1_kernel: LAMB phase 1: m and v in place, the direction r
//                     into fp32 scratch, per-chunk partial sums of w^2
//                     and r^2;
//   (d) lamb2_kernel: LAMB phase 2: each tensor's partials reduced in a
//                     fixed order, the trust ratio with the reference's
//                     bounds and zero guards, w -= lr * ratio * r.
// Each takes float16, bfloat16 or float32 weights and gradients (a
// gradient is read in its own dtype: no separate float cast pass),
// float32 states and, optionally, a float32 master copy of each weight
// (multi_precision): then the rule reads and writes the master and the
// weight gets its rounding.  Gradients are rescaled, then clipped, then
// the rule runs, in the order of the JAX body (optimizer.py:139-143)
// and of the ops (op_updates.py:56-63, `_lamb_one` :446).  Each
// operation rounds once, in the order of the plain version
// (ops/multi_tensor.py), through the _rn intrinsics, which the compiler
// never contracts into an FMA: the kernels agree with it bit for bit
// (LAMB up to its trust ratio's sums), whichever path an element takes.
//
// What bounds it on this card: bytes.  A rule does a few flops per
// element against 10-26 bytes moved (AdamW on bf16 weights: w read and
// written 4, g read 2, m and v read and written 16), far below the
// flop / byte ridge; the floor is those bytes over 3.35 TB/s.  What the
// design does about it: every operand is read once and written once in
// place (no temporaries, no second pass), with 16-byte loads and stores
// where all of a tensor's pointers are 16-byte aligned (8 elements a
// thread), and one launch covers up to TABLE tensors, so a step of ~200
// small tensors pays one launch, not a dozen per tensor.
//
// The table (pointers, element counts, per-tensor scalars, each
// tensor's first chunk) is one kernel parameter passed by value
// (__grid_constant__, up to 32 KB of parameters since CUDA 12.1): no
// host-to-device copy, and the launch can be captured by a CUDA graph.
// Each tensor is cut into chunks of CHUNK elements; a block walks the
// chunks grid-stride and finds each chunk's tensor by a binary search
// over the chunk prefix.  No atomics: LAMB's norms are per-chunk partial
// sums in float64 reduced in a fixed order, so every result is bitwise
// repeatable.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace mxmt {

constexpr int TABLE = 256;        // tensors per launch
constexpr int CHUNK = 16384;      // elements per chunk, a multiple of VEC
constexpr int NT = 256;           // threads per block
constexpr int VEC = 8;            // elements per thread on the vector path
constexpr int BLOCKS_PER_SM = 8;

enum { F16 = 0, BF16 = 1, F32 = 2 };                    // dtype codes
enum { SGD = 0, ADAM = 1, LAMB1 = 2, LAMB2 = 3 };       // kernel codes
enum {                                                  // Scalars.flags
  NESTEROV = 1, DECOUPLED = 2, HAS_CLIP = 4, HAS_LOWER = 8, HAS_UPPER = 16
};

// The per-launch table; `multi_tensor.py` builds the same layout with a
// numpy structured dtype (align=True) and the launcher checks its size.
struct Table {
  void* w[TABLE];           // weights (WT)
  const void* g[TABLE];     // gradients (GT)
  float* s0[TABLE];         // momentum / mean (null: SGD without state)
  float* s1[TABLE];         // variance
  float* w32[TABLE];        // float32 master weights, or null
  float* r[TABLE];          // LAMB's direction (fp32 scratch)
  long long n[TABLE];       // elements
  float lr[TABLE], wd[TABLE], eta[TABLE];
  float ic1[TABLE], ic2[TABLE];    // 1 / (1 - beta^t) (1: no correction)
  int chunk_begin[TABLE + 1];      // first chunk of each tensor
  int index[TABLE];                // its position in the caller's list
  int ntensors;
  unsigned char aligned[TABLE];    // every pointer 16-byte aligned
};

struct Scalars {
  const float* rescale_dev;  // rescale read on the device, or null
  double* partials;          // LAMB: (sum w^2, sum r^2) per chunk
  float* ratios;             // LAMB: each tensor's trust ratio, or null
  float rescale, clip, beta1, beta2, omb1, omb2, eps, momentum;
  float lower, upper;
  int flags, nchunks;
};

template <int K> struct IC { static constexpr int value = K; };

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half cvt<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// K elements from p into o (K = VEC: 16-byte accesses, p aligned)
template <int K, typename T>
__device__ __forceinline__ void ld(const T* p, float* o) {
  if constexpr (K == 1) {
    o[0] = f32(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = f32(h[j]);
  }
}

template <int K, typename T>
__device__ __forceinline__ void st(T* p, const float* v) {
  if constexpr (K == 1) {
    p[0] = cvt<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 u;
    T* h = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = cvt<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// the tensor of chunk c: the last one whose first chunk is <= c (tensors
// with no elements are left out of the table, so the prefix rises)
__device__ __forceinline__ int find_tensor(const Table& t, int c) {
  int lo = 0, hi = t.ntensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_begin[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Calls f(IC<VEC>, i) for each aligned group of VEC elements of chunk c
// of tensor ti, then f(IC<1>, i) for the rest, element by element.
template <typename F>
__device__ __forceinline__ void walk(const Table& t, int ti, int c, F&& f) {
  const long long start = (long long)(c - t.chunk_begin[ti]) * CHUNK;
  const long long end = min(start + (long long)CHUNK, t.n[ti]);
  long long tail = start;
  if (t.aligned[ti]) {
    tail = start + (end - start) / VEC * VEC;
    for (long long i = start + (long long)VEC * threadIdx.x; i < tail;
         i += (long long)VEC * NT)
      f(IC<VEC>(), i);
  }
  for (long long i = tail + threadIdx.x; i < end; i += NT) f(IC<1>(), i);
}

// one rounding each, never contracted into an FMA
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}

// rescale, then clip (a NaN stays NaN, as in jnp.clip / torch.clamp)
__device__ __forceinline__ float prep(float g, float rescale,
                                      const Scalars& s) {
  g = mul(g, rescale);
  if (s.flags & HAS_CLIP) g = g < -s.clip ? -s.clip : (g > s.clip ? s.clip : g);
  return g;
}

__device__ __forceinline__ float rescale_of(const Scalars& s) {
  return s.rescale_dev ? *s.rescale_dev : s.rescale;
}

// the weight as the rule reads it: the master copy where there is one
template <int K, typename WT>
__device__ __forceinline__ void ld_w(const Table& t, int ti, long long i,
                                     float* o) {
  if (t.w32[ti]) ld<K>(t.w32[ti] + i, o);
  else ld<K>(static_cast<const WT*>(t.w[ti]) + i, o);
}

template <int K, typename WT>
__device__ __forceinline__ void st_w(const Table& t, int ti, long long i,
                                     const float* v) {
  if (t.w32[ti]) st<K>(t.w32[ti] + i, v);
  st<K>(static_cast<WT*>(t.w[ti]) + i, v);
}

// (a) g += wd * w; with a momentum state m = momentum * m - lr * g and
// w += m (w += momentum * m - lr * g for Nesterov), else w -= lr * g
template <typename WT, typename GT>
__global__ void __launch_bounds__(NT)
sgd_kernel(const __grid_constant__ Table t, const Scalars s) {
  const float rs = rescale_of(s);
  const bool nag = s.flags & NESTEROV;
  for (int c = blockIdx.x; c < s.nchunks; c += gridDim.x) {
    const int ti = find_tensor(t, c);
    const float lr = t.lr[ti], wd = t.wd[ti];
    float* mom = t.s0[ti];
    walk(t, ti, c, [&](auto k, long long i) {
      constexpr int K = decltype(k)::value;
      float w[K], g[K], m[K];
      ld_w<K, WT>(t, ti, i, w);
      ld<K>(static_cast<const GT*>(t.g[ti]) + i, g);
      if (mom) ld<K>(mom + i, m);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float gj = add(prep(g[j], rs, s), mul(wd, w[j]));
        if (mom) {
          m[j] = sub(mul(s.momentum, m[j]), mul(lr, gj));
          w[j] = nag ? sub(add(w[j], mul(s.momentum, m[j])), mul(lr, gj))
                     : add(w[j], m[j]);
        } else {
          w[j] = sub(w[j], mul(lr, gj));
        }
      }
      if (mom) st<K>(mom + i, m);
      st_w<K, WT>(t, ti, i, w);
    });
  }
}

// (b) m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2 (g += wd * w first
// unless decoupled), then w -= eta * (lr * m ic1 / (sqrt(v ic2) + eps)
// [+ wd * w when decoupled])
template <typename WT, typename GT>
__global__ void __launch_bounds__(NT)
adam_kernel(const __grid_constant__ Table t, const Scalars s) {
  const float rs = rescale_of(s);
  const bool decoupled = s.flags & DECOUPLED;
  for (int c = blockIdx.x; c < s.nchunks; c += gridDim.x) {
    const int ti = find_tensor(t, c);
    const float lr = t.lr[ti], wd = t.wd[ti], eta = t.eta[ti];
    const float ic1 = t.ic1[ti], ic2 = t.ic2[ti];
    float* mp = t.s0[ti];
    float* vp = t.s1[ti];
    walk(t, ti, c, [&](auto k, long long i) {
      constexpr int K = decltype(k)::value;
      float w[K], g[K], m[K], v[K];
      ld_w<K, WT>(t, ti, i, w);
      ld<K>(static_cast<const GT*>(t.g[ti]) + i, g);
      ld<K>(mp + i, m);
      ld<K>(vp + i, v);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float gj = prep(g[j], rs, s);
        if (!decoupled) gj = add(gj, mul(wd, w[j]));
        m[j] = add(mul(s.beta1, m[j]), mul(s.omb1, gj));
        v[j] = add(mul(s.beta2, v[j]), mul(mul(s.omb2, gj), gj));
        const float upd = div(mul(lr, mul(m[j], ic1)),
                              add(__fsqrt_rn(mul(v[j], ic2)), s.eps));
        w[j] = decoupled ? sub(w[j], mul(eta, add(upd, mul(wd, w[j]))))
                         : sub(w[j], mul(eta, upd));
      }
      st<K>(mp + i, m);
      st<K>(vp + i, v);
      st_w<K, WT>(t, ti, i, w);
    });
  }
}

// the sum of v over the block, in a fixed order, in every thread
__device__ __forceinline__ double block_sum(double v, double* sh) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                       // sh is free again
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) total += sh[i];
  return total;
}

// (c) m, v as Adam's; r = m ic1 / (sqrt(v ic2) + eps) + wd * w into the
// scratch; per chunk, the sums of w^2 and r^2
template <typename WT, typename GT>
__global__ void __launch_bounds__(NT)
lamb1_kernel(const __grid_constant__ Table t, const Scalars s) {
  __shared__ double sh[NT / 32];
  const float rs = rescale_of(s);
  for (int c = blockIdx.x; c < s.nchunks; c += gridDim.x) {
    const int ti = find_tensor(t, c);
    const float wd = t.wd[ti], ic1 = t.ic1[ti], ic2 = t.ic2[ti];
    float* mp = t.s0[ti];
    float* vp = t.s1[ti];
    float* rp = t.r[ti];
    double sw = 0.0, sr = 0.0;
    walk(t, ti, c, [&](auto k, long long i) {
      constexpr int K = decltype(k)::value;
      float w[K], g[K], m[K], v[K], r[K];
      ld_w<K, WT>(t, ti, i, w);
      ld<K>(static_cast<const GT*>(t.g[ti]) + i, g);
      ld<K>(mp + i, m);
      ld<K>(vp + i, v);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float gj = prep(g[j], rs, s);
        m[j] = add(mul(s.beta1, m[j]), mul(s.omb1, gj));
        v[j] = add(mul(s.beta2, v[j]), mul(mul(s.omb2, gj), gj));
        r[j] = add(div(mul(m[j], ic1), add(__fsqrt_rn(mul(v[j], ic2)), s.eps)),
                   mul(wd, w[j]));
        sw += (double)w[j] * w[j];
        sr += (double)r[j] * r[j];
      }
      st<K>(mp + i, m);
      st<K>(vp + i, v);
      st<K>(rp + i, r);
    });
    sw = block_sum(sw, sh);
    sr = block_sum(sr, sh);
    if (threadIdx.x == 0) {
      s.partials[2 * (long long)c] = sw;
      s.partials[2 * (long long)c + 1] = sr;
    }
  }
}

// (d) ratio = ||w|| (bounded) / ||r|| where both are > 0, else 1;
// w -= lr * ratio * r
template <typename WT>
__global__ void __launch_bounds__(NT)
lamb2_kernel(const __grid_constant__ Table t, const Scalars s) {
  __shared__ double sh[NT / 32];
  int cached = -1;
  float lrr = 0.f;
  for (int c = blockIdx.x; c < s.nchunks; c += gridDim.x) {
    const int ti = find_tensor(t, c);
    if (ti != cached) {   // uniform over the block
      double sw = 0.0, sr = 0.0;
      for (int k = t.chunk_begin[ti] + threadIdx.x;
           k < t.chunk_begin[ti + 1]; k += NT) {
        sw += s.partials[2 * (long long)k];
        sr += s.partials[2 * (long long)k + 1];
      }
      sw = block_sum(sw, sh);
      sr = block_sum(sr, sh);
      float wn = (float)sqrt(sw);
      const float rn = (float)sqrt(sr);
      if (s.flags & HAS_LOWER) wn = fmaxf(wn, s.lower);
      if (s.flags & HAS_UPPER) wn = fminf(wn, s.upper);
      const float ratio = (wn > 0.f && rn > 0.f) ? div(wn, rn) : 1.f;
      lrr = mul(t.lr[ti], ratio);
      cached = ti;
      if (s.ratios && threadIdx.x == 0 && c == t.chunk_begin[ti])
        s.ratios[t.index[ti]] = ratio;
    }
    const float* rp = t.r[ti];
    walk(t, ti, c, [&](auto k, long long i) {
      constexpr int K = decltype(k)::value;
      float w[K], r[K];
      ld_w<K, WT>(t, ti, i, w);
      ld<K>(rp + i, r);
#pragma unroll
      for (int j = 0; j < K; ++j) w[j] = sub(w[j], mul(lrr, r[j]));
      st_w<K, WT>(t, ti, i, w);
    });
  }
}

int blocks_cap() {
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
  return sms[dev] * BLOCKS_PER_SM;
}

template <typename WT, typename GT>
int launch(int kind, const Table& t, const Scalars& s, cudaStream_t st) {
  const int grid = s.nchunks < blocks_cap() ? s.nchunks : blocks_cap();
  switch (kind) {
    case SGD: sgd_kernel<WT, GT><<<grid, NT, 0, st>>>(t, s); break;
    case ADAM: adam_kernel<WT, GT><<<grid, NT, 0, st>>>(t, s); break;
    case LAMB1: lamb1_kernel<WT, GT><<<grid, NT, 0, st>>>(t, s); break;
    case LAMB2: lamb2_kernel<WT><<<grid, NT, 0, st>>>(t, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename WT>
int by_grad(int kind, int gdtype, const Table& t, const Scalars& s,
            cudaStream_t st) {
  if (kind == LAMB2) return launch<WT, float>(kind, t, s, st);
  switch (gdtype) {
    case F16: return launch<WT, __half>(kind, t, s, st);
    case BF16: return launch<WT, __nv_bfloat16>(kind, t, s, st);
    case F32: return launch<WT, float>(kind, t, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace mxmt

// The bytes of one table and of the launch scalars, for the host's check
// of its layout.
extern "C" int mx_multi_tensor_sizes(int* table, int* scalars) {
  *table = (int)sizeof(mxmt::Table);
  *scalars = (int)sizeof(mxmt::Scalars);
  return 0;
}

// Launch kernel `kind` (SGD, ADAM, LAMB1, LAMB2) over one table.  Returns
// a CUDA error code: the launch's own (cudaGetLastError), or
// cudaErrorInvalidValue for a table or scalars of the wrong size, an
// unknown kind or dtype.
extern "C" int mx_multi_tensor(int kind, const void* table, int table_bytes,
                               const void* scalars, int scalar_bytes,
                               int wdtype, int gdtype, void* stream) {
  using namespace mxmt;
  if (table_bytes != (int)sizeof(Table) ||
      scalar_bytes != (int)sizeof(Scalars))
    return (int)cudaErrorInvalidValue;
  thread_local Table t;     // 20 KB: off the caller's stack
  Scalars s;
  memcpy(&t, table, sizeof(Table));
  memcpy(&s, scalars, sizeof(Scalars));
  if (t.ntensors <= 0 || t.ntensors > TABLE || s.nchunks <= 0 ||
      t.chunk_begin[t.ntensors] != s.nchunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (wdtype) {
    case F16: return by_grad<__half>(kind, gdtype, t, s, st);
    case BF16: return by_grad<__nv_bfloat16>(kind, gdtype, t, s, st);
    case F32: return by_grad<float>(kind, gdtype, t, s, st);
  }
  return (int)cudaErrorInvalidValue;
}
