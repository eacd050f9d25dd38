// Whole-cascade ACDC forward (and, at K=1 with no mid matrix, the
// single fused layer):
//
//   h <- ((h * a_i) @ C * d_i + bias_i) @ (ct_mid for i < K-1, else C^T)
//
// with ReLU between layers (not after the last), the activation kept in
// fp32 across all K layers, x read once and y written once.
//
// Replaces: src/repro/kernels/acdc_cascade_fused.py, _cascade_kernel via
// acdc_cascade_pallas, and (K=1) src/repro/kernels/acdc_fused.py,
// _acdc_kernel via acdc_fused_pallas.  ct_mid = C^T[:, riffle] folds the
// riffle permutation into the mid-cascade inverse transform exactly as
// ops.py does, so no gather runs in the kernel.
//
// What bounds it on the H100: per layer 4*M*N^2 flops against 8N bytes of
// activation per row plus the N x N fp32 matrices.  The matrices (3 x
// 4 MB at N=1024) do not fit in a block's 227 KB of shared memory as
// they fit the TPU's VMEM, so they are streamed from device memory / the
// 50 MB L2 by every block; at the serving shapes (M of a few rows, N of
// 128-1024) the kernel is bound by those matrix bytes and by latency,
// with fp32 FMA throughput (67 TFLOP/s) the limit only for large M.
//
// Design, simple first: one block of 256 threads owns BM rows and keeps
// h and h2 (BM x N fp32 each) in dynamic shared memory (cudaFuncSetAttribute
// above 48 KB).  BM is sized from the 227 KB budget: 2 * BM * 4N bytes,
// so BM = 16 at N = 1024 (128 KB) and BM = 32 up to N = 256 (64 KB).  Each
// thread owns up to CPT = ceil(N/256) output columns for all BM rows and
// accumulates them in registers with fp32 FMAs; the C / C^T / ct_mid row k
// it needs is read coalesced from global memory while h[r][k] is a shared
// memory broadcast.  The D scale, bias, ReLU and the next layer's A scale
// are applied in the epilogues.  No tensor cores (TF32 would cost digits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

constexpr int kThreads = 256;

// acc[r][cc] = sum_k src[r][k] * W[k][tid + cc*256]
template <int BM, int CPT>
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
      wv[cc] = (j < N) ? W[(long long)k * N + j] : 0.f;
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

template <typename T, int BM, int CPT>
__global__ void __launch_bounds__(kThreads)
cascade_kernel(const T* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ d, const float* __restrict__ bias,
               const float* __restrict__ c, const float* __restrict__ ct,
               const float* __restrict__ ct_mid, T* __restrict__ y, int M,
               int N, int K, int relu) {
  extern __shared__ float smem[];
  float* h = smem;             // layer input, already scaled by a_i
  float* h2 = smem + BM * N;   // transform-domain (h @ C) * d_i + bias_i
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, M - m0);
  const float* mid = ct_mid != nullptr ? ct_mid : ct;

  for (int e = tid; e < BM * N; e += kThreads) {
    const int r = e / N, k = e % N;
    h[e] = r < rows ? to_f(x[(long long)(m0 + r) * N + k]) * a[k] : 0.f;
  }
  __syncthreads();

  float acc[BM][CPT];
  for (int i = 0; i < K; ++i) {
    const bool last = i == K - 1;
    row_block_matmul<BM, CPT>(h, c, N, acc);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int j = tid + cc * kThreads;
      if (j >= N) continue;
      const float dj = d[(long long)i * N + j];
      const float bj = bias != nullptr ? bias[(long long)i * N + j] : 0.f;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        // __fmul_rn/__fadd_rn: round after each step like the reference
        // (no fused multiply-add contraction of the D scale and bias)
        float v = __fmul_rn(acc[r][cc], dj);
        if (bias != nullptr) v = __fadd_rn(v, bj);
        h2[r * N + j] = v;
      }
    }
    __syncthreads();
    row_block_matmul<BM, CPT>(h2, last ? ct : mid, N, acc);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int j = tid + cc * kThreads;
      if (j >= N) continue;
      if (last) {
#pragma unroll
        for (int r = 0; r < BM; ++r)
          if (r < rows) y[(long long)(m0 + r) * N + j] = from_f<T>(acc[r][cc]);
      } else {
        const float an = a[(long long)(i + 1) * N + j];
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          float v = acc[r][cc];
          if (relu) v = fmaxf(v, 0.f);
          h[r * N + j] = v * an;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int BM, int CPT>
cudaError_t launch(const void* x, const float* a, const float* d,
                   const float* bias, const float* c, const float* ct,
                   const float* ct_mid, void* y, int M, int N, int K,
                   int relu, cudaStream_t stream) {
  const size_t smem = 2ull * BM * N * sizeof(float);
  auto kern = cascade_kernel<T, BM, CPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + BM - 1) / BM;
  kern<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), a, d, bias, c, ct, ct_mid,
      static_cast<T*>(y), M, N, K, relu);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* x, const float* a, const float* d,
                     const float* bias, const float* c, const float* ct,
                     const float* ct_mid, void* y, int M, int N, int K,
                     int relu, cudaStream_t stream) {
  if (N <= 256)
    return launch<T, 32, 1>(x, a, d, bias, c, ct, ct_mid, y, M, N, K, relu,
                            stream);
  if (N <= 512)
    return launch<T, 16, 2>(x, a, d, bias, c, ct, ct_mid, y, M, N, K, relu,
                            stream);
  if (N <= 1024)
    return launch<T, 16, 4>(x, a, d, bias, c, ct, ct_mid, y, M, N, K, relu,
                            stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M, N) fp32 or bf16; a, d, bias (K, N) fp32 (bias may be NULL);
// c, ct, ct_mid (N, N) fp32 row-major (ct_mid NULL = no riffle); y (M, N)
// in x's dtype.  N <= 1024.  Launches on `stream`, allocates nothing,
// returns the first CUDA error (cudaGetLastError() after the launch).
extern "C" int acdc_cascade_launch(const void* x, const void* a,
                                   const void* d, const void* bias,
                                   const void* c, const void* ct,
                                   const void* ct_mid, void* y, int M, int N,
                                   int K, int relu, int x_is_bf16,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto af = static_cast<const float*>(a);
  auto df = static_cast<const float*>(d);
  auto bf = static_cast<const float*>(bias);
  auto cf = static_cast<const float*>(c);
  auto tf = static_cast<const float*>(ct);
  auto mf = static_cast<const float*>(ct_mid);
  cudaError_t err = cudaSuccess;
  if (M > 0 && K > 0) {
    err = x_is_bf16
              ? dispatch<__nv_bfloat16>(x, af, df, bf, cf, tf, mf, y, M, N, K,
                                        relu, s)
              : dispatch<float>(x, af, df, bf, cf, tf, mf, y, M, N, K, relu,
                                s);
  }
  cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
