// Single ACDC layer backward, the paper's eqs. (10)-(14), in one pass per
// row block:
//
//   gc  = g @ C                 db = sum_rows gc
//   h2  = (x * a) @ C           dd = sum_rows h2 * gc   (h2 recomputed)
//   dh1 = (gc * d) @ C^T        da = sum_rows x * dh1
//   dx  = a * dh1
//
// Replaces: src/repro/kernels/acdc_bwd.py, _acdc_bwd_kernel via
// acdc_bwd_pallas (N <= 1024; larger N runs the two-call backward of
// kernels/ops.py on scaled_matmul).
//
// What bounds it on the H100: 6*M*N^2 fp32 flops (three N x N products)
// against 12N bytes per row (x and g read, dx written) plus the two fp32
// N x N matrices; at the training shapes (M = a few hundred rows, N <=
// 1024) the fp32 FMA rate (67 TFLOP/s, no tensor cores: TF32 would cost
// digits) and the L2 stream of C / C^T that every block reads bound it.
//
// Design: the tiling of acdc_common.cuh (one block of 256 threads per BM
// rows, two BM x N fp32 buffers in shared memory, C / C^T streamed from
// L2).  Buffer s0 holds g, then x * a; buffer s1 holds gc, then gc * d;
// every intermediate stays on chip and only dx leaves.  Each thread owns
// whole columns, so its share of the row sums needs no exchange between
// threads.  The TPU kernel carries da / dd / db across its sequential grid
// in scratch; CUDA blocks run concurrently, so each block writes its
// partial sums to a (blocks, 3, N) fp32 workspace and a second kernel sums
// them in block order: no float atomics, and two runs give identical bits.
// Workspace: 12 * N * ceil(M / BM) bytes (384 KB at M = 512, N = 1024).

#include "acdc_common.cuh"

namespace {

using acdc::from_f;
using acdc::kThreads;
using acdc::row_block_matmul;
using acdc::to_f;

template <typename T, int BM, int CPT>
__global__ void __launch_bounds__(kThreads)
acdc_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                const float* __restrict__ a, const float* __restrict__ d,
                const float* __restrict__ c, const float* __restrict__ ct,
                T* __restrict__ dx, float* __restrict__ part, int M, int N,
                int with_bias) {
  extern __shared__ float smem[];
  float* s0 = smem;            // g, then x * a   (matmul sources)
  float* s1 = smem + BM * N;   // gc, then gc * d
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, M - m0);
  float* pa = part + (long long)blockIdx.x * 3 * N;
  float* pd = pa + N;
  float* pb = pa + 2 * N;

  for (int e = tid; e < BM * N; e += kThreads) {
    const int r = e / N, k = e % N;
    s0[e] = r < rows ? to_f(g[(long long)(m0 + r) * N + k]) : 0.f;
  }
  __syncthreads();

  float acc[BM][CPT];
  row_block_matmul<BM, CPT>(s0, c, N, acc);  // gc = g @ C
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int j = tid + cc * kThreads;
    if (j >= N) continue;
    float sb = 0.f;
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      s1[r * N + j] = acc[r][cc];
      sb = __fadd_rn(sb, acc[r][cc]);
    }
    if (with_bias) pb[j] = sb;
  }
  __syncthreads();

  for (int e = tid; e < BM * N; e += kThreads) {
    const int r = e / N, k = e % N;
    s0[e] = r < rows ? to_f(x[(long long)(m0 + r) * N + k]) * a[k] : 0.f;
  }
  __syncthreads();

  row_block_matmul<BM, CPT>(s0, c, N, acc);  // h2 = (x * a) @ C
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int j = tid + cc * kThreads;
    if (j >= N) continue;
    const float dj = d[j];
    float sd = 0.f;
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const float gcv = s1[r * N + j];
      sd = __fadd_rn(sd, __fmul_rn(acc[r][cc], gcv));
      s1[r * N + j] = __fmul_rn(gcv, dj);
    }
    pd[j] = sd;
  }
  __syncthreads();

  row_block_matmul<BM, CPT>(s1, ct, N, acc);  // dh1 = (gc * d) @ C^T
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int j = tid + cc * kThreads;
    if (j >= N) continue;
    const float aj = a[j];
    float sa = 0.f;
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      if (r < rows) {
        const long long at = (long long)(m0 + r) * N + j;
        sa = __fadd_rn(sa, __fmul_rn(to_f(x[at]), acc[r][cc]));
        dx[at] = from_f<T>(__fmul_rn(aj, acc[r][cc]));
      }
    }
    pa[j] = sa;
  }
}

template <typename T, int BM, int CPT>
cudaError_t launch(const void* x, const void* g, const float* a,
                   const float* d, const float* c, const float* ct, void* dx,
                   float* part, float* out, int M, int N, int with_bias,
                   cudaStream_t stream) {
  const size_t smem = 2ull * BM * N * sizeof(float);
  auto kern = acdc_bwd_kernel<T, BM, CPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + BM - 1) / BM;
  kern<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), a, d, c, ct,
      static_cast<T*>(dx), part, M, N, with_bias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return acdc::launch_sum_partials(part, out, blocks, 3 * N,
                                   (with_bias ? 3 : 2) * N, stream);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, const float* a,
                     const float* d, const float* c, const float* ct,
                     void* dx, float* part, float* out, int M, int N,
                     int with_bias, cudaStream_t stream) {
  if (N <= 256)
    return launch<T, 32, 1>(x, g, a, d, c, ct, dx, part, out, M, N,
                            with_bias, stream);
  if (N <= 512)
    return launch<T, 16, 2>(x, g, a, d, c, ct, dx, part, out, M, N,
                            with_bias, stream);
  if (N <= acdc::kMaxN)
    return launch<T, 16, 4>(x, g, a, d, c, ct, dx, part, out, M, N,
                            with_bias, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Rows per block at size N: the wrapper sizes the partial-sum workspace
// as (ceil(M / rows), 3, N) fp32.
extern "C" int acdc_bwd_rows_per_block(int N) {
  return acdc::rows_per_block(N);
}

// x, g (M, N) fp32 or bf16 (same dtype); a, d (N,) fp32; c, ct (N, N)
// fp32 row-major; dx (M, N) in x's dtype; part the (blocks, 3, N) fp32
// workspace; out (3, N) fp32 receives da, dd, db (db left unwritten
// without bias).  N <= 1024.  Launches on `stream`, allocates nothing,
// returns the first CUDA error.
extern "C" int acdc_bwd_launch(const void* x, const void* g, const void* a,
                               const void* d, const void* c, const void* ct,
                               void* dx, void* part, void* out, int M, int N,
                               int with_bias, int x_is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto af = static_cast<const float*>(a);
  auto df = static_cast<const float*>(d);
  auto cf = static_cast<const float*>(c);
  auto tf = static_cast<const float*>(ct);
  auto pf = static_cast<float*>(part);
  auto of = static_cast<float*>(out);
  cudaError_t err = cudaSuccess;
  if (M > 0) {
    err = x_is_bf16 ? dispatch<__nv_bfloat16>(x, g, af, df, cf, tf, dx, pf,
                                              of, M, N, with_bias, s)
                    : dispatch<float>(x, g, af, df, cf, tf, dx, pf, of, M, N,
                                      with_bias, s);
  }
  cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
