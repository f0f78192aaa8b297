// Peak issue rate of mma.sync.aligned.m16n8k8 TF32 (the instruction of
// mxnet_tpu_torch/csrc/flash_bwd_mma.cu) on one NVIDIA Hopper card, for
// comparison with the published dense TF32 rate, which wgmma reaches.
//
// Build and run on the card:
//   nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_peak \
//        tools/mma_peak.cu && ./mma_peak
//
// Each warp issues CH independent chains of mma on registers, 4 CTAs an
// SM; one m16n8k8 is 16 * 8 * 8 multiply-adds, 2048 flops.
#include <cuda_runtime.h>
#include <stdint.h>
#include <cstdio>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3},{%4,%5,%6,%7},{%8,%9},{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int CH>
__global__ void peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float d[CH][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CH; ++c) mma(d[c], a, b);
  float s = 0;
  for (int c = 0; c < CH; ++c)
    for (int i = 0; i < 4; ++i) s += d[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms, khz;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const int ctas = sms * 4, iters = 4096;
  float* out;
  cudaMalloc(&out, (size_t)ctas * 1024 * sizeof(float));
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  double best = 0;
  for (int warps : {4, 8, 16, 32}) {
    for (int ch : {1, 4, 8}) {
      auto run = [&]() {
        if (ch == 1) peak<1><<<ctas, warps * 32>>>(out, iters);
        if (ch == 4) peak<4><<<ctas, warps * 32>>>(out, iters);
        if (ch == 8) peak<8><<<ctas, warps * 32>>>(out, iters);
      };
      run();
      cudaEventRecord(a);
      run();
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      double n = (double)ctas * warps * iters * ch;  // mma per run
      double tflops = n * 2048 / (ms * 1e-3) / 1e12;
      best = tflops > best ? tflops : best;
      // cycles at the card's maximum clock, per mma on one of the 4
      // sub-partitions of an SM
      printf("warps/CTA %2d, %d chains: %.1f TFLOP/s, %.2f cycles/mma/SMSP "
             "at %.3f GHz\n", warps, ch, tflops,
             ms * 1e-3 * khz * 1e3 / (n / (4.0 * sms)), khz * 1e-6);
    }
  }
  int err = (int)cudaGetLastError();
  printf("mma.sync m16n8k8 TF32 peak %.1f TFLOP/s on %d SMs; error %d\n",
         best, sms, err);
  return err != 0;
}
