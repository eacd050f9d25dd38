// Reverse-sweep backward of a whole order-K ACDC cascade (K >= 2), one
// pass per row block:
//
// 1. forward re-walk: the x block goes through layers 0 .. K-2 as in the
//    forward kernel (fp32 activation, ReLU, riffle folded into
//    ct_mid = C^T[:, riffle]); each layer input h_1 .. h_{K-1} is stashed;
// 2. reverse sweep, layer K-1 down to 0, the cotangent resident in shared
//    memory: eqs. (10)-(14) per layer,
//
//      gc  = gcur @ C   (layer K-1)
//          = mask(gcur) contracted against ct_mid's second axis (below)
//      db_i = sum_rows gc,  h2 = (h_i * a_i) @ C,  dd_i = sum_rows h2 * gc
//      dh1 = (gc * d_i) @ C^T,  da_i = sum_rows h_i * dh1,  gcur = a_i * dh1
//
//    The ReLU mask is taken in h-space against the stashed next input,
//    (z_i > 0)[:, p] == (h_{i+1} > 0), and the un-permute is folded into
//    the transform, w[:, p^-1] @ C == w @ C[p, :] == w @ ct_mid^T, so the
//    kernel runs no gather and holds no fourth matrix.
//
// Replaces: src/repro/kernels/acdc_cascade_bwd.py, _cascade_bwd_kernel via
// acdc_cascade_bwd_pallas.  Which cascades come here (the reference's
// VMEM gate, copied as arithmetic) is decided in kernels/ops.py.
//
// What bounds it on the H100: (2 + 3) N x N products per layer (two in the
// re-walk of layers 0 .. K-2, three in the sweep of every layer), i.e.
// 2*M*N^2 * (5K - 2) fp32 flops, against 12N bytes per row of x, g and dx
// independent of K, plus the fp32 matrices streamed from L2 by every
// block.  No tensor cores (TF32 would cost digits): the fp32 FMA rate
// (67 TFLOP/s) and the L2 stream bound it.
//
// Design: the tiling of acdc_common.cuh (one block of 256 threads per BM
// rows, two BM x N fp32 buffers in shared memory: s0 the matmul source,
// s1 the transform-domain row block in the re-walk and the resident
// cotangent in the sweep).  The TPU kernel keeps the (K-1, bm, N) stash
// in VMEM; a block's shared memory cannot hold it next to the two buffers
// (15 x 64 KB at K = 16, N = 1024), so it lives in a global workspace of
// 4 * (K-1) * M * N bytes that mostly hits the 50 MB L2 (0.26 MB at
// M = 256, N = 256, K = 2; 31.5 MB at M = 512, N = 1024, K = 16).  As in
// acdc_bwd.cu, the (K, N) diagonal gradients are summed per block into a
// (blocks, 3, K, N) fp32 workspace (12 * K * N bytes per block) and
// reduced across blocks in block order by a second kernel: no float
// atomics, and two runs give identical bits.

#include "acdc_common.cuh"

namespace {

using acdc::from_f;
using acdc::kThreads;
using acdc::row_block_matmul;
using acdc::to_f;

template <typename T, int BM, int CPT>
__global__ void __launch_bounds__(kThreads)
cascade_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ a, const float* __restrict__ d,
                   const float* __restrict__ bias,
                   const float* __restrict__ c, const float* __restrict__ ct,
                   const float* __restrict__ ct_mid, T* __restrict__ dx,
                   float* __restrict__ stash, float* __restrict__ part, int M,
                   int N, int K, int relu) {
  extern __shared__ float smem[];
  float* s0 = smem;            // matmul source (h_i * a_i)
  float* s1 = smem + BM * N;   // re-walk: h2; sweep: the cotangent
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, M - m0);
  const float* mid = ct_mid != nullptr ? ct_mid : ct;
  // h_i(r, j): the input of layer i for row r of this block (x for i = 0,
  // the stash for i >= 1; zero beyond the last row)
  auto h_at = [&](int i, int r, int j) -> float {
    if (r >= rows) return 0.f;
    const long long row = m0 + r;
    return i == 0 ? to_f(x[row * N + j])
                  : stash[((long long)(i - 1) * M + row) * N + j];
  };
  float acc[BM][CPT];

  // ---- forward re-walk: stash h_1 .. h_{K-1} -------------------------
  for (int e = tid; e < BM * N; e += kThreads)
    s0[e] = h_at(0, e / N, e % N) * a[e % N];
  __syncthreads();
  for (int i = 0; i < K - 1; ++i) {
    row_block_matmul<BM, CPT>(s0, c, N, acc);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int j = tid + cc * kThreads;
      if (j >= N) continue;
      const float dj = d[(long long)i * N + j];
      const float bj = bias != nullptr ? bias[(long long)i * N + j] : 0.f;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        float v = __fmul_rn(acc[r][cc], dj);
        if (bias != nullptr) v = __fadd_rn(v, bj);
        s1[r * N + j] = v;
      }
    }
    __syncthreads();
    row_block_matmul<BM, CPT>(s1, mid, N, acc);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int j = tid + cc * kThreads;
      if (j >= N) continue;
      const float an = a[(long long)(i + 1) * N + j];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        float v = acc[r][cc];
        if (relu) v = fmaxf(v, 0.f);
        if (r < rows) stash[((long long)i * M + m0 + r) * N + j] = v;
        s0[r * N + j] = v * an;
      }
    }
    __syncthreads();
  }

  // ---- reverse sweep: the cotangent stays in s1 -----------------------
  for (int e = tid; e < BM * N; e += kThreads) {
    const int r = e / N, k = e % N;
    s1[e] = r < rows ? to_f(g[(long long)(m0 + r) * N + k]) : 0.f;
  }
  __syncthreads();
  for (int i = K - 1; i >= 0; --i) {
    float* pa = part + ((long long)blockIdx.x * 3 * K + i) * N;
    float* pd = pa + (long long)K * N;
    float* pb = pa + 2ll * K * N;
    if (i == K - 1) {
      row_block_matmul<BM, CPT>(s1, c, N, acc);
    } else {
      if (relu) {
        // mask in h-space against the stashed next input h_{i+1}
        for (int e = tid; e < BM * N; e += kThreads)
          if (!(h_at(i + 1, e / N, e % N) > 0.f)) s1[e] = 0.f;
        __syncthreads();
      }
      if (ct_mid != nullptr)
        row_block_matmul<BM, CPT, true>(s1, ct_mid, N, acc);
      else
        row_block_matmul<BM, CPT>(s1, c, N, acc);
    }
    __syncthreads();   // every thread is done reading the cotangent
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int j = tid + cc * kThreads;
      if (j >= N) continue;
      float sb = 0.f;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        s1[r * N + j] = acc[r][cc];   // gc
        sb = __fadd_rn(sb, acc[r][cc]);
      }
      if (bias != nullptr) pb[j] = sb;
    }
    for (int e = tid; e < BM * N; e += kThreads)
      s0[e] = h_at(i, e / N, e % N) * a[(long long)i * N + e % N];
    __syncthreads();

    row_block_matmul<BM, CPT>(s0, c, N, acc);   // h2 = (h_i * a_i) @ C
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int j = tid + cc * kThreads;
      if (j >= N) continue;
      const float dj = d[(long long)i * N + j];
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

    row_block_matmul<BM, CPT>(s1, ct, N, acc);  // dh1 = (gc * d_i) @ C^T
    __syncthreads();   // every thread is done reading gc * d_i
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int j = tid + cc * kThreads;
      if (j >= N) continue;
      const float aj = a[(long long)i * N + j];
      float sa = 0.f;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        sa = __fadd_rn(sa, __fmul_rn(h_at(i, r, j), acc[r][cc]));
        s1[r * N + j] = __fmul_rn(aj, acc[r][cc]);   // the next cotangent
      }
      pa[j] = sa;
    }
    __syncthreads();
  }

  for (int e = tid; e < BM * N; e += kThreads) {
    const int r = e / N, k = e % N;
    if (r < rows) dx[(long long)(m0 + r) * N + k] = from_f<T>(s1[e]);
  }
}

template <typename T, int BM, int CPT>
cudaError_t launch(const void* x, const void* g, const float* a,
                   const float* d, const float* bias, const float* c,
                   const float* ct, const float* ct_mid, void* dx,
                   float* stash, float* part, float* out, int M, int N, int K,
                   int relu, cudaStream_t stream) {
  const size_t smem = 2ull * BM * N * sizeof(float);
  auto kern = cascade_bwd_kernel<T, BM, CPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + BM - 1) / BM;
  kern<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), a, d, bias, c, ct,
      ct_mid, static_cast<T*>(dx), stash, part, M, N, K, relu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return acdc::launch_sum_partials(part, out, blocks, 3 * K * N,
                                   (bias != nullptr ? 3 : 2) * K * N, stream);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, const float* a,
                     const float* d, const float* bias, const float* c,
                     const float* ct, const float* ct_mid, void* dx,
                     float* stash, float* part, float* out, int M, int N,
                     int K, int relu, cudaStream_t stream) {
  if (N <= 256)
    return launch<T, 32, 1>(x, g, a, d, bias, c, ct, ct_mid, dx, stash, part,
                            out, M, N, K, relu, stream);
  if (N <= 512)
    return launch<T, 16, 2>(x, g, a, d, bias, c, ct, ct_mid, dx, stash, part,
                            out, M, N, K, relu, stream);
  if (N <= acdc::kMaxN)
    return launch<T, 16, 4>(x, g, a, d, bias, c, ct, ct_mid, dx, stash, part,
                            out, M, N, K, relu, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Rows per block at size N: the wrapper sizes the partial-sum workspace
// as (ceil(M / rows), 3, K, N) fp32.
extern "C" int acdc_cascade_bwd_rows_per_block(int N) {
  return acdc::rows_per_block(N);
}

// x, g (M, N) fp32 or bf16 (same dtype); a, d, bias (K, N) fp32 (bias may
// be NULL); c, ct, ct_mid (N, N) fp32 row-major (ct_mid NULL = no
// riffle); dx (M, N) in x's dtype; stash the (K-1, M, N) fp32 workspace;
// part the (blocks, 3, K, N) fp32 workspace; out (3, K, N) fp32 receives
// da, dd, db (db left unwritten without bias).  K >= 2, N <= 1024.
// Launches on `stream`, allocates nothing, returns the first CUDA error.
extern "C" int acdc_cascade_bwd_launch(
    const void* x, const void* g, const void* a, const void* d,
    const void* bias, const void* c, const void* ct, const void* ct_mid,
    void* dx, void* stash, void* part, void* out, int M, int N, int K,
    int relu, int x_is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto af = static_cast<const float*>(a);
  auto df = static_cast<const float*>(d);
  auto bf = static_cast<const float*>(bias);
  auto cf = static_cast<const float*>(c);
  auto tf = static_cast<const float*>(ct);
  auto mf = static_cast<const float*>(ct_mid);
  auto sf = static_cast<float*>(stash);
  auto pf = static_cast<float*>(part);
  auto of = static_cast<float*>(out);
  cudaError_t err = cudaSuccess;
  if (M > 0 && K >= 2) {
    err = x_is_bf16
              ? dispatch<__nv_bfloat16>(x, g, af, df, bf, cf, tf, mf, dx, sf,
                                        pf, of, M, N, K, relu, s)
              : dispatch<float>(x, g, af, df, bf, cf, tf, mf, dx, sf, pf, of,
                                M, N, K, relu, s);
  } else if (K < 2) {
    err = cudaErrorInvalidValue;
  }
  cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
