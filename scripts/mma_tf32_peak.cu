// The ceiling of mma.sync.m16n8k8 TF32 on the card: warps that issue only
// independent products (no memory traffic), at 4 to 32 warps an SM, and
// once with a cvt.rna.tf32 before each round as a 3xTF32 kernel has.
// 3xTF32 runs three such products for each fp32 one, so at best a third
// of the rate printed here.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_tf32_peak \
//        scripts/mma_tf32_peak.cu && build/mma_tf32_peak
//
// scripts/smm_variants.py builds and runs it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

constexpr int kSMs = 132;  // H100 SXM

// each warp: `iters` rounds of Acc independent m16n8k8 products
template <int Acc, bool Convert>
__global__ void mma_loop(float* out, int iters, float seed) {
  float d[Acc][4];
  for (int i = 0; i < Acc; ++i)
    for (int q = 0; q < 4; ++q) d[i][q] = 0.f;
  const float base = seed + threadIdx.x * 1e-3f;
  uint32_t a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(base + q);
  for (int q = 0; q < 2; ++q) b[q] = __float_as_uint(2.f * base + q);
  for (int it = 0; it < iters; ++it) {
    if (Convert) {
      uint32_t r;
      asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r)
          : "f"(__uint_as_float(a[0]) + 1e-7f));
      a[0] = r;
    }
#pragma unroll
    for (int i = 0; i < Acc; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int i = 0; i < Acc; ++i)
    for (int q = 0; q < 4; ++q) s += d[i][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the products
}

template <int Acc, bool Convert>
void run(int warps_per_block, int blocks_per_sm) {
  const int blocks = kSMs * blocks_per_sm, threads = warps_per_block * 32;
  const int iters = 4096;
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  mma_loop<Acc, Convert><<<blocks, threads>>>(out, 16, 1.f);  // warm-up
  cudaEventRecord(start);
  mma_loop<Acc, Convert><<<blocks, threads>>>(out, iters, 1.f);
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  float ms;
  cudaEventElapsedTime(&ms, start, end);
  const double flops = 2.0 * 16 * 8 * 8 * Acc * (double)iters * blocks *
                       warps_per_block;
  printf("independent products %2d, cvt %d, warps an SM %2d: %.3f ms, "
         "%.1f TFLOP/s TF32\n",
         Acc, Convert, warps_per_block * blocks_per_sm, ms,
         flops / ms / 1e9);
  cudaFree(out);
  cudaEventDestroy(start);
  cudaEventDestroy(end);
}

int main() {
  run<16, false>(4, 1);
  run<16, false>(8, 1);
  run<16, false>(8, 2);
  run<16, false>(16, 2);
  run<4, false>(8, 1);
  run<8, false>(8, 1);
  run<32, false>(8, 1);
  run<16, true>(8, 1);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
