// Scaled matmul  y = ((x * pre) @ w) * post + bias   (fp32 accumulate,
// output in x's dtype).
//
// Replaces: src/repro/kernels/scaled_matmul.py, _smm_kernel via
// scaled_matmul_pallas (the TPU's "multiple call" building block).  Two
// calls make one large-N ACDC layer: h2 = scaled_matmul(x, C, pre=a),
// y = scaled_matmul(h2, C^T, pre=d[, bias=bias C^T]) (ops.py two-call path).
//
// What bounds it on the H100: on the decode path M (the number of slots)
// is 4, so each call reads the whole fp32 w (K*N*4 bytes: 151 MB at
// N=6144) and does only 2*M*K*N flops -- it is bound by device-memory
// bytes (3.35 TB/s).  Prefill (M = the prompt window, 64) is still
// byte-bound at fp32 SIMT rates only for small M; larger M turns
// operation-bound (67 TFLOP/s fp32 without tensor cores).
//
// Design, simple first: a classic shared-memory SIMT GEMM.  A block owns
// a BM x BN output tile; per BK-deep step it stages x (scaled by pre as it
// loads, transposed so the inner loop reads it by broadcast) and w into
// shared memory, then each of the 256 threads accumulates a TM x TN
// micro-tile in fp32 registers with FMAs (no TF32 tensor cores).  Each
// thread sums one BK-deep slice into a fresh register and adds it to its
// running total once per slice (two-level summation): a rounding error
// then grows with about BK + K/BK terms instead of K (K = 6144 on the
// main path; chip_smoke.py reads each side's fp32 error against fp64 as
// fp32_err_vs_fp64).  post and bias are applied in the epilogue.  Ragged M/N/K edges are masked on
// load and store, never padded by copies.  Two tile shapes: a skinny one
// (16 x 32) for M <= 16 so the decode call still spreads over the SMs, a
// square one (64 x 64) otherwise.  Every w element is read from device
// memory once per row tile; tensor cores, TMA and split-K are later work.

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
  return __float2bfloat16(v);  // round to nearest even, as torch/XLA
}

constexpr int kThreads = 256;

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
smm_kernel(const T* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ pre, const float* __restrict__ post,
           const float* __restrict__ bias, T* __restrict__ y, int M, int N,
           int K) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile/thread mismatch");
  __shared__ float xs[BK][BM + 1];  // transposed x tile (+1: no conflicts)
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.f;
      if (gm < M && gk < K) {
        v = to_f(x[(long long)gm * K + gk]);
        if (pre != nullptr) v *= pre[gk];
      }
      xs[c][r] = v;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N) ? w[(long long)gk * N + gn] : 0.f;
    }
    __syncthreads();
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      // separate roundings, as the reference (no FMA contraction)
      if (post != nullptr) v = __fmul_rn(v, post[gn]);
      if (bias != nullptr) v = __fadd_rn(v, bias[gn]);
      y[(long long)gm * N + gn] = from_f<T>(v);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, const float* w, const float* pre,
            const float* post, const float* bias, void* y, int M, int N,
            int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  smm_kernel<T, BM, BN, BK, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, pre, post, bias, static_cast<T*>(y), M,
      N, K);
}

template <typename T>
void dispatch(const void* x, const float* w, const float* pre,
              const float* post, const float* bias, void* y, int M, int N,
              int K, cudaStream_t stream) {
  if (M <= 16)
    launch<T, 16, 32, 32, 1, 2>(x, w, pre, post, bias, y, M, N, K, stream);
  else
    launch<T, 64, 64, 16, 4, 4>(x, w, pre, post, bias, y, M, N, K, stream);
}

}  // namespace

// x (M, K) fp32 or bf16 (x_is_bf16); w (K, N) fp32; pre (K,), post (N,),
// bias (N,) fp32 or NULL; y (M, N) in x's dtype.  All row-major and
// contiguous.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int smm_launch(const void* x, const void* w, const void* pre,
                          const void* post, const void* bias, void* y,
                          int M, int N, int K, int x_is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  auto pf = static_cast<const float*>(pre);
  auto qf = static_cast<const float*>(post);
  auto bf = static_cast<const float*>(bias);
  if (M > 0 && N > 0) {
    if (x_is_bf16)
      dispatch<__nv_bfloat16>(x, wf, pf, qf, bf, y, M, N, K, s);
    else
      dispatch<float>(x, wf, pf, qf, bf, y, M, N, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}
