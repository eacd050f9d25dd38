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
// What bounds it on the H100: 2K dependent N x N products, 4*M*N^2 fp32
// flops a layer, against 8N bytes of activation a row and the N x N
// transforms.  At the serving shapes (M of a few rows, N = 128 - 1024) the
// work is a few microseconds of one SM's FMAs, so what sets the time is
// latency: the chain of 2K products and how many SMs share each one.
// Only at training M (hundreds of rows) does the fp32 FMA rate (67
// TFLOP/s; no tensor cores, TF32 would cost digits) come near.
//
// Design (the cluster machinery of acdc_common.cuh): one thread block
// cluster of S CTAs per BM rows; CTA `rank` owns columns [rank W, rank W +
// W) of every product, keeps its slice of C, C^T and ct_mid on chip
// (resident, or streamed from L2 through a cp.async ring where the slices
// do not fit, N = 1024), holds the full BM x N rows of the current
// product's input, and writes its slice of the output into every CTA's
// buffer for the next product through distributed shared memory, then
// the cluster syncs.  The 8 warps of a CTA split k and their partials are
// summed in warp order, so no thread walks all N steps and two runs give
// identical bits.  The D scale and bias round after each step
// (__fmul_rn, __fadd_rn) like the reference.  The launch's geometry (S,
// W, BM, resident or streamed, shared memory) comes from the wrapper's
// plan() in kernels/acdc_cascade_fused.py.

#include "acdc_common.cuh"

namespace {

using acdc::kThreads;
namespace cl = acdc::cl;

// transform of product p: C for the first of each layer, then ct_mid (id
// `mid`) between layers and C^T (id 1) after the last
struct FwdSeq {
  int K, mid;
  __device__ int operator()(int p) const {
    return (p & 1) == 0 ? 0 : (p == 2 * K - 1 ? 1 : mid);
  }
};

template <int BM, int CPT, bool STREAM>
__global__ void __launch_bounds__(kThreads, 1)
cascade_kernel(const float* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ d, const float* __restrict__ bias,
               const float* __restrict__ c, const float* __restrict__ ct,
               const float* __restrict__ ct_mid, float* __restrict__ y, int M,
               int K, int relu, cl::Geo g) {
  constexpr int LW = 32 * CPT;
  constexpr int RPW = cl::Rows<BM>::RPW;
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, NK = g.NK;
  float* h = smem;                 // layer input, already scaled by a_i
  float* h2 = h + BM * NK;         // (h @ C) * d_i + bias_i
  float* red = h2 + BM * NK;       // the warps' partial sums
  float* mats = red + cl::kWarps * BM * LW;
  g.own(cl::cluster_rank());
  const int m0 = (blockIdx.x / g.S) * BM;
  const int rows = min(BM, M - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* gm[3] = {c, ct, ct_mid != nullptr ? ct_mid : ct};
  cl::Products<BM, CPT, STREAM, FwdSeq> pr{
      mats, gm, -1, ct_mid != nullptr && K > 1 ? 3 : 2, 2 * K, g,
      FwdSeq{K, ct_mid != nullptr ? 2 : 1}};
  pr.prologue();
  for (int e = tid; e < BM * NK; e += kThreads) {
    const int r = e / NK, k = e % NK;
    h[e] = r < rows && k < N ? x[(long long)(m0 + r) * N + k] * a[k] : 0.f;
    h2[e] = 0.f;
  }
  // no CTA writes into another's buffers before they are initialised
  cl::cluster_arrive();

  float acc[BM][CPT];
  float v[RPW][CPT];
  for (int i = 0; i < K; ++i) {
    const bool last = i == K - 1;
    pr.run(2 * i, h, acc);
    cl::reduce<BM, CPT>(red, acc);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + cl::kWarps * rr;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int jj = lane + 32 * cc, j = g.j0 + jj;
        v[rr][cc] = 0.f;
        if (r < rows && jj < g.w) {
          // __fmul_rn/__fadd_rn: round after each step like the
          // reference (no fused multiply-add of the D scale and bias)
          float s = __fmul_rn(cl::sum<BM, CPT>(red, r, jj),
                              d[(long long)i * N + j]);
          if (bias != nullptr) s = __fadd_rn(s, bias[(long long)i * N + j]);
          v[rr][cc] = s;
        }
      }
    }
    if (i == 0) cl::cluster_wait();
    cl::broadcast<BM, CPT>(h2, v, rows, g);
    cl::cluster_sync();

    pr.run(2 * i + 1, h2, acc);
    cl::reduce<BM, CPT>(red, acc);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + cl::kWarps * rr;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int jj = lane + 32 * cc, j = g.j0 + jj;
        v[rr][cc] = 0.f;
        if (r < rows && jj < g.w) {
          float s = cl::sum<BM, CPT>(red, r, jj);
          if (last) {
            y[(long long)(m0 + r) * N + j] = s;
          } else {
            if (relu) s = fmaxf(s, 0.f);
            v[rr][cc] = s * a[(long long)(i + 1) * N + j];
          }
        }
      }
    }
    // the last layer writes device memory only: after the cluster_sync
    // above no CTA touches another's shared memory, so each may exit
    if (!last) {
      cl::broadcast<BM, CPT>(h, v, rows, g);
      cl::cluster_sync();
    }
  }
}

// shared memory of a launch, in bytes (the plan's smem_bytes)
inline long long smem_bytes(int BM, int LW, int NK, int KT, int nmats,
                            bool resident) {
  return 4 * (2ll * BM * NK + (long long)cl::kWarps * BM * LW +
              cl::mats_floats(NK, KT, LW, nmats, false, resident));
}

// Launch (or, with `max_clusters`, ask how many clusters fit the card)
template <int BM, int CPT, bool STREAM>
cudaError_t run(const float* x, const float* a, const float* d,
                const float* bias, const float* c, const float* ct,
                const float* ct_mid, float* y, int M, int K, int relu,
                const cl::Geo& g, size_t smem, cudaStream_t stream,
                int* max_clusters) {
  auto kern = cascade_kernel<BM, CPT, STREAM>;
  static const cudaError_t prepared = cl::prepare(kern);
  if (prepared != cudaSuccess) return prepared;
  cl::LaunchCfg lc(g.S, (M + BM - 1) / BM, smem, stream);
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, kern, &lc.cfg);
  return cudaLaunchKernelEx(&lc.cfg, kern, x, a, d, bias, c, ct, ct_mid, y,
                            M, K, relu, g);
}

template <int BM, int CPT>
cudaError_t by_mode(bool resident, const float* x, const float* a,
                    const float* d, const float* bias, const float* c,
                    const float* ct, const float* ct_mid, float* y, int M,
                    int K, int relu, const cl::Geo& g, size_t smem,
                    cudaStream_t s, int* mc) {
  return resident ? run<BM, CPT, false>(x, a, d, bias, c, ct, ct_mid, y,
                                           M, K, relu, g, smem, s, mc)
                  : run<BM, CPT, true>(x, a, d, bias, c, ct, ct_mid, y, M,
                                          K, relu, g, smem, s, mc);
}

template <int BM>
cudaError_t by_cpt(int CPT, bool resident, const float* x, const float* a,
                   const float* d, const float* bias, const float* c,
                   const float* ct, const float* ct_mid, float* y, int M,
                   int K, int relu, const cl::Geo& g, size_t smem,
                   cudaStream_t s, int* mc) {
  switch (CPT) {
    case 1: return by_mode<BM, 1>(resident, x, a, d, bias, c, ct, ct_mid,
                                     y, M, K, relu, g, smem, s, mc);
    case 2: return by_mode<BM, 2>(resident, x, a, d, bias, c, ct, ct_mid,
                                     y, M, K, relu, g, smem, s, mc);
    case 4: return by_mode<BM, 4>(resident, x, a, d, bias, c, ct, ct_mid,
                                     y, M, K, relu, g, smem, s, mc);
  }
  return cudaErrorInvalidValue;
}

cudaError_t by_bm(int BM, int CPT, bool resident, const float* x,
                  const float* a, const float* d, const float* bias,
                  const float* c, const float* ct, const float* ct_mid,
                  float* y, int M, int K, int relu, const cl::Geo& g,
                  size_t smem, cudaStream_t s, int* mc) {
  switch (BM) {
    case 4: return by_cpt<4>(CPT, resident, x, a, d, bias, c, ct, ct_mid,
                                y, M, K, relu, g, smem, s, mc);
    case 8: return by_cpt<8>(CPT, resident, x, a, d, bias, c, ct, ct_mid,
                                y, M, K, relu, g, smem, s, mc);
    case 16: return by_cpt<16>(CPT, resident, x, a, d, bias, c, ct,
                                  ct_mid, y, M, K, relu, g, smem, s, mc);
  }
  return cudaErrorInvalidValue;
}

cudaError_t entry(const void* x, const void* a, const void* d,
                  const void* bias, const void* c, const void* ct,
                  const void* ct_mid, void* y, int M, int N, int K, int relu,
                  int S, int W, int CPT, int BM, int NK, int KT,
                  int resident, int vec, int smem, void* stream, int* mc) {
  cl::Geo g;
  const int nmats = ct_mid != nullptr && K > 1 ? 3 : 2;
  if (M < 1 || K < 1 ||
      !cl::make_geo(g, N, S, W, 32 * CPT, NK, KT, resident, vec, false) ||
      smem != smem_bytes(BM, 32 * CPT, NK, KT, nmats, resident != 0) ||
      smem > 232448)
    return cudaErrorInvalidValue;
  return by_bm(BM, CPT, resident != 0, static_cast<const float*>(x),
               static_cast<const float*>(a), static_cast<const float*>(d),
               static_cast<const float*>(bias), static_cast<const float*>(c),
               static_cast<const float*>(ct),
               static_cast<const float*>(ct_mid), static_cast<float*>(y), M,
               K, relu, g, (size_t)smem, static_cast<cudaStream_t>(stream),
               mc);
}

}  // namespace

// x (M, N), a, d, bias (K, N) fp32 (bias may be NULL); c, ct, ct_mid
// (N, N) fp32 row-major (ct_mid NULL = no riffle); y (M, N) fp32 (the
// wrapper widens bf16 x exactly and rounds y back once).  The geometry
// (S CTAs a cluster of W columns each, CPT 32-column groups a thread, BM
// rows a cluster, depth NK, tile KT, resident or streamed, 16-byte
// copies, shared memory bytes) is the wrapper's plan; a geometry that is
// not a plan is refused (cudaErrorInvalidValue).  Launches on `stream`,
// allocates nothing, returns the first CUDA error.
extern "C" int acdc_cascade_launch(const void* x, const void* a,
                                   const void* d, const void* bias,
                                   const void* c, const void* ct,
                                   const void* ct_mid, void* y, int M, int N,
                                   int K, int relu, int S, int W, int CPT,
                                   int BM, int NK, int KT, int resident,
                                   int vec, int smem, void* stream) {
  cudaError_t err = entry(x, a, d, bias, c, ct, ct_mid, y, M, N, K, relu, S,
                          W, CPT, BM, NK, KT, resident, vec, smem, stream,
                          nullptr);
  cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// How many clusters of the plan's launch the card can hold at once
// (cudaOccupancyMaxActiveClusters); 0 means the cluster cannot be
// scheduled.  A negative value is a CUDA error, negated.
extern "C" int acdc_cascade_max_clusters(int M, int N, int K, int riffle,
                                         int S, int W, int CPT, int BM,
                                         int NK, int KT, int resident,
                                         int vec, int smem) {
  int n = 0;
  const float dummy = 0.f;
  cudaError_t err = entry(&dummy, &dummy, &dummy, nullptr, &dummy, &dummy,
                          riffle ? &dummy : nullptr, nullptr, M, N, K, 0, S,
                          W, CPT, BM, NK, KT, resident, vec, smem, nullptr,
                          &n);
  cudaGetLastError();
  return err != cudaSuccess ? -static_cast<int>(err) : n;
}
