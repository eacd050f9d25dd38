// Reverse-sweep backward of a whole order-K ACDC cascade, one pass per row
// block (K = 1, without the riffle or ReLU, is one layer's backward, the
// paper's eqs. (10)-(14): acdc_bwd launches it so):
//
// 1. forward re-walk: the x block goes through layers 0 .. K-2 as in the
//    forward kernel (fp32 activation, ReLU, riffle folded into
//    ct_mid = C^T[:, riffle]); each layer input h_1 .. h_{K-1} is stashed;
// 2. reverse sweep, layer K-1 down to 0, the cotangent resident on chip:
//    eqs. (10)-(14) per layer,
//
//      gc  = gcur @ C   (layer K-1)
//          = mask(gcur) contracted against ct_mid's second axis (below)
//      db_i = sum_rows gc,  h2 = (h_i * a_i) @ C,  dd_i = sum_rows h2 * gc
//      dh1 = (gc * d_i) @ C^T,  da_i = sum_rows h_i * dh1,  gcur = a_i * dh1
//
//    The ReLU mask is taken in h-space against the stashed next input,
//    (z_i > 0)[:, p] == (h_{i+1} > 0), and the un-permute is folded into
//    the transform, w[:, p^-1] @ C == w @ C[p, :] == w @ ct_mid^T, so the
//    kernel runs no gather.
//
// Replaces: src/repro/kernels/acdc_cascade_bwd.py, _cascade_bwd_kernel via
// acdc_cascade_bwd_pallas (K >= 2), and src/repro/kernels/acdc_bwd.py,
// _acdc_bwd_kernel via acdc_bwd_pallas (K = 1: three products, no re-walk,
// no stash).  Which cascades come here (the reference's VMEM gate, copied
// as arithmetic) is decided in kernels/ops.py.
//
// What bounds it on the H100: 5K - 2 dependent N x N products (two in the
// re-walk of layers 0 .. K-2, three in the sweep of every layer), i.e.
// 2*M*N^2 * (5K - 2) fp32 flops, against 12N bytes per row of x, g and dx
// independent of K.  At the training shapes (M = 256 - 512, N = 128 -
// 1024) the chain's latency and the fp32 FMA rate (67 TFLOP/s; no tensor
// cores, TF32 would cost digits) bound it.
//
// Design: the cluster machinery of acdc_common.cuh, as in the forward.
// One cluster of S CTAs owns BM rows, CTA `rank` owns columns [rank W,
// rank W + W) of every product and keeps its slices of C, C^T, ct_mid and
// ct_mid's rows (for the transposed contraction) on chip, resident or
// streamed.  Every diagonal gradient is a column sum, so it stays with the
// CTA that owns the column; so do the stash h_1 .. h_{K-1} and x, kept as
// the CTA's own columns in shared memory (a (K-1) x BM x W slice) where
// the plan finds room, else in a (K-1, M, N) global workspace whose own
// columns are copied on chip at each layer.  The ReLU mask is applied by
// the column's owner as it writes the next cotangent.  Three full-row
// buffers rotate: s0 the source h_i * a_i, s2 the cotangent, s1 gc * d_i;
// the sweep's first two products of a layer read s2 and s0 at once, so a
// layer costs two cluster barriers.  The (K, N) gradients are summed per
// cluster in a fixed order (rows of a warp, then warps) into a (clusters,
// 3, K, N) fp32 workspace and reduced across clusters pairwise, in a
// fixed shape, by a second kernel: no float atomics, and two runs give
// identical bits.

#include "acdc_common.cuh"

namespace {

using acdc::kThreads;
namespace cl = acdc::cl;

// transform of product p: the re-walk's (C, mid) per layer, then per
// sweep layer i: C (i = K-1) or the un-permute `sweep` for gc, C for h2,
// C^T (id 1) for dh1
struct BwdSeq {
  int K, mid, sweep;
  __device__ int operator()(int p) const {
    if (p < 2 * (K - 1)) return (p & 1) == 0 ? 0 : mid;
    const int q = p - 2 * (K - 1), i = K - 1 - q / 3, sub = q % 3;
    return sub == 0 ? (i == K - 1 ? 0 : sweep) : (sub == 1 ? 0 : 1);
  }
};

// floats of the own-column buffers: x, gc, the stash (or two slots of it;
// none at K = 1 with the stash on chip)
inline long long own_floats(int BM, int LW, int K, bool stash_smem) {
  return (long long)BM * LW * (2 + (stash_smem ? K - 1 : 2));
}

template <int BM, int CPT, bool STREAM>
__global__ void __launch_bounds__(kThreads, 1)
cascade_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                   const float* __restrict__ a, const float* __restrict__ d,
                   const float* __restrict__ bias,
                   const float* __restrict__ c, const float* __restrict__ ct,
                   const float* __restrict__ ct_mid, float* __restrict__ dx,
                   float* __restrict__ stash_g, float* __restrict__ part,
                   int M, int K, int relu, int with_db, int stash_smem,
                   cl::Geo g) {
  constexpr int LW = 32 * CPT;
  constexpr int RPW = cl::Rows<BM>::RPW;
  constexpr int OWN = BM * LW;
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, NK = g.NK;
  float* s0 = smem;               // source: h_i * a_i
  float* s1 = s0 + BM * NK;       // re-walk: h2; sweep: gc * d_i
  float* s2 = s1 + BM * NK;       // g, then the cotangent
  float* xl = s2 + BM * NK;       // own columns of x
  float* gcl = xl + OWN;          // own columns of gc
  float* stash = gcl + OWN;       // own columns of h_1 .. h_{K-1} (or 2 slots)
  float* red = stash + OWN * (stash_smem ? K - 1 : 2);
  float* colp = red + cl::kWarps * OWN;  // (3, warps, LW) column sums
  float* mats = colp + 3 * cl::kWarps * LW;
  g.own(cl::cluster_rank());
  const int cb = blockIdx.x / g.S;
  const int m0 = cb * BM;
  const int rows = min(BM, M - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool riffle = ct_mid != nullptr;
  const float* mid = riffle ? ct_mid : ct;
  const float* gm[4] = {c, ct, mid, mid};
  cl::Products<BM, CPT, STREAM, BwdSeq> pr{
      mats, gm, riffle ? 3 : -1, riffle ? 3 : 2, 5 * K - 2, g,
      BwdSeq{K, riffle ? 2 : 1, riffle ? 3 : 0}};
  pr.prologue();
  for (int e = tid; e < BM * NK; e += kThreads) {
    const int r = e / NK, k = e % NK;
    const bool ok = r < rows && k < N;
    const long long at = (long long)(m0 + r) * N + k;
    s0[e] = ok ? x[at] * a[k] : 0.f;
    s1[e] = 0.f;
    s2[e] = ok ? gy[at] : 0.f;
  }
  for (int e = tid; e < OWN; e += kThreads) {
    const int r = e / LW, jj = e % LW;
    xl[e] = r < rows && jj < g.w ? x[(long long)(m0 + r) * N + g.j0 + jj]
                                 : 0.f;
  }
  // no CTA writes into another's buffers before they are initialised
  cl::cluster_arrive();
  // own columns of the input of layer i (x for i = 0)
  auto h_own = [&](int i) -> float* {
    if (i == 0) return xl;
    return stash + (stash_smem ? (long long)(i - 1) * OWN
                               : (long long)(i & 1) * OWN);
  };

  float acc[BM][CPT];
  float v[RPW][CPT];
  int p = 0;
  // ---- forward re-walk: stash h_1 .. h_{K-1} -------------------------
  for (int i = 0; i < K - 1; ++i) {
    pr.run(p++, s0, acc);
    cl::reduce<BM, CPT>(red, acc);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + cl::kWarps * rr;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int jj = lane + 32 * cc, j = g.j0 + jj;
        v[rr][cc] = 0.f;
        if (r < rows && jj < g.w) {
          float s = __fmul_rn(cl::sum<BM, CPT>(red, r, jj),
                              d[(long long)i * N + j]);
          if (bias != nullptr) s = __fadd_rn(s, bias[(long long)i * N + j]);
          v[rr][cc] = s;
        }
      }
    }
    if (i == 0) cl::cluster_wait();
    cl::broadcast<BM, CPT>(s1, v, rows, g);
    cl::cluster_sync();

    pr.run(p++, s1, acc);
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
          if (relu) s = fmaxf(s, 0.f);
          if (stash_smem)
            stash[(long long)i * OWN + r * LW + jj] = s;
          else
            stash_g[((long long)i * M + m0 + r) * N + j] = s;
          v[rr][cc] = s * a[(long long)(i + 1) * N + j];
        }
      }
    }
    cl::broadcast<BM, CPT>(s0, v, rows, g);
    cl::cluster_sync();
  }

  // ---- reverse sweep: s2 the cotangent, s0 h_i * a_i, s1 gc * d_i -----
  float u[RPW][CPT];
  for (int i = K - 1; i >= 0; --i) {
    if (!stash_smem) {
      // this layer's own columns of h_i and h_{i-1} from the workspace
      for (int e = tid; e < OWN; e += kThreads) {
        const int r = e / LW, jj = e % LW;
        if (!(r < rows && jj < g.w)) continue;
        const long long at = (long long)(m0 + r) * N + g.j0 + jj;
        for (int l = i; l >= max(i - 1, 1); --l)
          h_own(l)[e] = stash_g[(long long)(l - 1) * M * N + at];
      }
    }
    const float* hi = h_own(i);
    float sb[CPT], sd[CPT], sa[CPT];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) sb[cc] = sd[cc] = sa[cc] = 0.f;

    // gc = gcur @ C (or the un-permute), db
    pr.run(p++, s2, acc);
    cl::reduce<BM, CPT>(red, acc);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + cl::kWarps * rr;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int jj = lane + 32 * cc;
        if (r < rows && jj < g.w) {
          const float gc = cl::sum<BM, CPT>(red, r, jj);
          gcl[r * LW + jj] = gc;
          sb[cc] = __fadd_rn(sb[cc], gc);
        }
      }
    }
    // h2 = (h_i * a_i) @ C, dd; gc * d_i to every CTA (same thread and
    // element as gcl's write above: no barrier needed between them)
    pr.run(p++, s0, acc);
    cl::reduce<BM, CPT>(red, acc);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + cl::kWarps * rr;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int jj = lane + 32 * cc, j = g.j0 + jj;
        v[rr][cc] = 0.f;
        if (r < rows && jj < g.w) {
          const float gc = gcl[r * LW + jj];
          sd[cc] = __fadd_rn(sd[cc],
                             __fmul_rn(cl::sum<BM, CPT>(red, r, jj), gc));
          v[rr][cc] = __fmul_rn(gc, d[(long long)i * N + j]);
        }
      }
    }
    // K = 1 has no re-walk: this is the first remote write
    if (K == 1) cl::cluster_wait();
    cl::broadcast<BM, CPT>(s1, v, rows, g);
    cl::cluster_sync();

    // dh1 = (gc * d_i) @ C^T, da; the next cotangent (masked) and
    // h_{i-1} * a_{i-1} to every CTA, or dx at layer 0
    pr.run(p++, s1, acc);
    cl::reduce<BM, CPT>(red, acc);
    const float* hp = i > 0 ? h_own(i - 1) : nullptr;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + cl::kWarps * rr;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int jj = lane + 32 * cc, j = g.j0 + jj;
        v[rr][cc] = u[rr][cc] = 0.f;
        if (r < rows && jj < g.w) {
          const float dh1 = cl::sum<BM, CPT>(red, r, jj);
          const float h = hi[r * LW + jj];
          sa[cc] = __fadd_rn(sa[cc], __fmul_rn(h, dh1));
          float gn = __fmul_rn(a[(long long)i * N + j], dh1);
          if (i == 0) {
            dx[(long long)(m0 + r) * N + j] = gn;
          } else {
            // mask in h-space against this layer's input h_i
            if (relu && !(h > 0.f)) gn = 0.f;
            v[rr][cc] = gn;
            u[rr][cc] = hp[r * LW + jj] * a[(long long)(i - 1) * N + j];
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int jj = lane + 32 * cc;
      colp[(0 * cl::kWarps + warp) * LW + jj] = sa[cc];
      colp[(1 * cl::kWarps + warp) * LW + jj] = sd[cc];
      colp[(2 * cl::kWarps + warp) * LW + jj] = sb[cc];
    }
    __syncthreads();
    // this cluster's (da, dd, db) of layer i, warps summed in order
    for (int e = tid; e < 3 * LW; e += kThreads) {
      const int which = e / LW, jj = e % LW;
      if (jj >= g.w || (which == 2 && !with_db)) continue;
      float s = colp[which * cl::kWarps * LW + jj];
      for (int w8 = 1; w8 < cl::kWarps; ++w8)
        s = __fadd_rn(s, colp[(which * cl::kWarps + w8) * LW + jj]);
      part[(((long long)cb * 3 + which) * K + i) * N + g.j0 + jj] = s;
    }
    // dx is device memory only: after the last cluster_sync no CTA
    // touches another's shared memory, so each may exit
    if (i > 0) {
      cl::broadcast<BM, CPT>(s2, v, rows, g);
      cl::broadcast<BM, CPT>(s0, u, rows, g);
      cl::cluster_sync();
    }
  }
}

inline long long smem_bytes(int BM, int LW, int NK, int KT, int K,
                            bool riffle, bool resident, bool stash_smem) {
  return 4 * (3ll * BM * NK + own_floats(BM, LW, K, stash_smem) +
              (long long)cl::kWarps * BM * LW + 3ll * cl::kWarps * LW +
              cl::mats_floats(NK, KT, LW, riffle ? 3 : 2, riffle, resident));
}

struct Bufs {
  const float *x, *g, *a, *d, *bias, *c, *ct, *ct_mid;
  float *dx, *stash, *part, *out;
};

// Launch both kernels (or, with `max_clusters`, ask how many clusters of
// the first fit the card)
template <int BM, int CPT, bool STREAM>
cudaError_t run(const Bufs& b, int M, int K, int relu, int with_db,
                int stash_smem, const cl::Geo& g, size_t smem,
                cudaStream_t stream, int* max_clusters) {
  auto kern = cascade_bwd_kernel<BM, CPT, STREAM>;
  static const cudaError_t prepared = cl::prepare(kern);
  if (prepared != cudaSuccess) return prepared;
  const int clusters = (M + BM - 1) / BM;
  cl::LaunchCfg lc(g.S, clusters, smem, stream);
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, kern, &lc.cfg);
  cudaError_t err = cudaLaunchKernelEx(&lc.cfg, kern, b.x, b.g, b.a, b.d,
                                       b.bias, b.c, b.ct, b.ct_mid, b.dx,
                                       b.stash, b.part, M, K, relu,
                                       with_db, stash_smem, g);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int N = g.N;
  return cl::launch_sum_partials_pairwise(
      b.part, b.out, clusters, 3 * K * N,
      (with_db ? 3 : 2) * K * N, stream);
}

template <int BM, int CPT>
cudaError_t by_mode(bool resident, const Bufs& b, int M, int K, int relu,
                    int db, int ss, const cl::Geo& g, size_t smem,
                    cudaStream_t s, int* mc) {
  return resident
             ? run<BM, CPT, false>(b, M, K, relu, db, ss, g, smem, s, mc)
             : run<BM, CPT, true>(b, M, K, relu, db, ss, g, smem, s, mc);
}

template <int BM>
cudaError_t by_cpt(int CPT, bool resident, const Bufs& b, int M, int K,
                   int relu, int db, int ss, const cl::Geo& g, size_t smem,
                   cudaStream_t s, int* mc) {
  switch (CPT) {
    case 1: return by_mode<BM, 1>(resident, b, M, K, relu, db, ss, g, smem,
                                     s, mc);
    case 2: return by_mode<BM, 2>(resident, b, M, K, relu, db, ss, g, smem,
                                     s, mc);
    case 4: return by_mode<BM, 4>(resident, b, M, K, relu, db, ss, g, smem,
                                     s, mc);
  }
  return cudaErrorInvalidValue;
}

cudaError_t by_bm(int BM, int CPT, bool resident, const Bufs& b, int M,
                  int K, int relu, int db, int ss, const cl::Geo& g,
                  size_t smem, cudaStream_t s, int* mc) {
  switch (BM) {
    case 4: return by_cpt<4>(CPT, resident, b, M, K, relu, db, ss, g, smem,
                                s, mc);
    case 8: return by_cpt<8>(CPT, resident, b, M, K, relu, db, ss, g, smem,
                                s, mc);
    case 16: return by_cpt<16>(CPT, resident, b, M, K, relu, db, ss, g,
                                  smem, s, mc);
  }
  return cudaErrorInvalidValue;
}

// K = 1 (one layer) has no re-walk, so no mid matrix and no ReLU
cudaError_t entry(const Bufs& b, int M, int N, int K, int relu, int with_db,
                  int S, int W, int CPT, int BM, int NK, int KT,
                  int resident, int vec, int stash_smem, int smem,
                  void* stream, int* mc) {
  cl::Geo g;
  const bool riffle = b.ct_mid != nullptr;
  if (M < 1 || K < 1 || (K == 1 && (riffle || relu)) ||
      !cl::make_geo(g, N, S, W, 32 * CPT, NK, KT, resident, vec, riffle) ||
      smem != smem_bytes(BM, 32 * CPT, NK, KT, K, riffle, resident != 0,
                         stash_smem != 0) ||
      smem > 232448)
    return cudaErrorInvalidValue;
  return by_bm(BM, CPT, resident != 0, b, M, K, relu, with_db, stash_smem,
               g, (size_t)smem, static_cast<cudaStream_t>(stream), mc);
}

}  // namespace

// x, g (M, N) fp32 (the wrapper widens bf16 exactly and rounds dx back
// once); a, d, bias (K, N) fp32 (bias may be NULL: no bias in the
// re-walk); c, ct, ct_mid (N, N) fp32 row-major (ct_mid NULL = no
// riffle); dx (M, N) fp32; stash the (K-1, M, N) fp32 workspace (unused,
// may be NULL, when the plan keeps the stash on chip); part the
// (clusters, 3, K, N) fp32 workspace; out (3, K, N) fp32 receives da, dd
// and, with `with_db`, db (left unwritten without).  K = 1 takes neither
// ct_mid nor relu.
// The geometry is the wrapper's plan (see acdc_cascade.cu), plus where the
// stash lives; a geometry that is not a plan is refused
// (cudaErrorInvalidValue).  Launches on `stream`, allocates nothing,
// returns the first CUDA error.
extern "C" int acdc_cascade_bwd_launch(
    const void* x, const void* g, const void* a, const void* d,
    const void* bias, const void* c, const void* ct, const void* ct_mid,
    void* dx, void* stash, void* part, void* out, int M, int N, int K,
    int relu, int with_db, int S, int W, int CPT, int BM, int NK, int KT,
    int resident, int vec, int stash_smem, int smem, void* stream) {
  const Bufs b{static_cast<const float*>(x),    static_cast<const float*>(g),
               static_cast<const float*>(a),    static_cast<const float*>(d),
               static_cast<const float*>(bias), static_cast<const float*>(c),
               static_cast<const float*>(ct),
               static_cast<const float*>(ct_mid), static_cast<float*>(dx),
               static_cast<float*>(stash),      static_cast<float*>(part),
               static_cast<float*>(out)};
  cudaError_t err = entry(b, M, N, K, relu, with_db, S, W, CPT, BM, NK, KT,
                          resident, vec, stash_smem, smem, stream, nullptr);
  cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// How many clusters of the plan's launch the card can hold at once; 0
// means the cluster cannot be scheduled, a negative value is a CUDA
// error, negated.
extern "C" int acdc_cascade_bwd_max_clusters(int M, int N, int K, int riffle,
                                             int S, int W, int CPT, int BM,
                                             int NK, int KT, int resident,
                                             int vec, int stash_smem,
                                             int smem) {
  int n = 0;
  const float dummy = 0.f;
  const Bufs b{&dummy, &dummy, &dummy, &dummy, nullptr, &dummy,
               &dummy, riffle ? &dummy : nullptr, nullptr, nullptr,
               nullptr, nullptr};
  cudaError_t err = entry(b, M, N, K, 0, 1, S, W, CPT, BM, NK, KT, resident,
                          vec, stash_smem, smem, nullptr, &n);
  cudaGetLastError();
  return err != cudaSuccess ? -static_cast<int>(err) : n;
}
