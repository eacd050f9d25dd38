// Pieces shared by the ACDC kernels (acdc_cascade.cu, acdc_bwd.cu,
// acdc_cascade_bwd.cu): dtype conversion, the row-block matmul that
// streams an N x N fp32 transform from L2 against a BM x N row block in
// shared memory, the row-block tiling, and the fixed-order reduction of
// per-block partial sums.
//
// Tiling (all three kernels): one block of kThreads threads owns BM rows;
// each thread owns up to CPT = ceil(N / 256) columns for all BM rows and
// accumulates them in registers with fp32 FMAs.  Two BM x N fp32 buffers
// live in dynamic shared memory, so BM is sized from the 227 KB a block
// may use: BM = 32 up to N = 256 (64 KB), BM = 16 up to N = 1024 (128 KB).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace acdc {

constexpr int kThreads = 256;
constexpr int kMaxN = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
  return __float2bfloat16(v);
}

// acc[r][cc] = sum_k src[r][k] * W(k, tid + cc*256) with W(k, j) =
// W[k*N + j], or W[j*N + k] when TRANS (a contraction against W's second
// axis: each thread walks a row of W, so a warp's loads are strided by N
// and each cache line serves 32 consecutive k from L1).
template <int BM, int CPT, bool TRANS = false>
__device__ __forceinline__ void row_block_matmul(const float* src,
                                                 const float* __restrict__ W,
                                                 int N, float (&acc)[BM][CPT]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[r][cc] = 0.f;
#pragma unroll 4
  for (int k = 0; k < N; ++k) {
    float wv[CPT];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int j = tid + cc * kThreads;
      const long long at = TRANS ? (long long)j * N + k : (long long)k * N + j;
      wv[cc] = (j < N) ? W[at] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const float hv = src[r * N + k];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc)
        acc[r][cc] = fmaf(hv, wv[cc], acc[r][cc]);
    }
  }
}

// out[i] = sum over blocks b = 0, 1, ... of part[b * stride + i] for
// i < len, in block order: the cross-block half of the diagonal-gradient
// reductions, with no float atomics, so two runs give identical bits.
// Each block's partials take `stride` floats; only the first `len` are
// summed (the dbias third is skipped without a bias).
__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ part, float* __restrict__ out,
             int nblocks, int stride, int len) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += part[(long long)b * stride + i];
  out[i] = s;
}

inline cudaError_t launch_sum_partials(const float* part, float* out,
                                       int nblocks, int stride, int len,
                                       cudaStream_t stream) {
  sum_partials<<<(len + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, out, nblocks, stride, len);
  return cudaGetLastError();
}

// Rows per block for an N <= kMaxN row block (see the tiling note).
inline int rows_per_block(int N) { return N <= 256 ? 32 : 16; }

}  // namespace acdc
