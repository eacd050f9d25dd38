// The thread block cluster machinery shared by the ACDC cascade kernels
// (acdc_cascade.cu, acdc_cascade_bwd.cu; acdc_fused and acdc_bwd are their
// K = 1 launches), namespace acdc::cl.
#pragma once

#include <cuda_runtime.h>

namespace acdc {

constexpr int kThreads = 256;

}  // namespace acdc

// ---------------------------------------------------------------------------
// Cluster machinery of the cascade kernels (acdc_cascade.cu,
// acdc_cascade_bwd.cu).
//
// One thread block cluster of S CTAs owns BM rows.  CTA `rank` owns the
// output columns [j0, j0 + w) of every N x N product, j0 = rank * W; it
// holds the full (BM x NK) input rows of the current product in shared
// memory (NK = N rounded up to a whole tile, zero padded) and writes its
// column slice of each product's output into every CTA's buffer for the
// next product through distributed shared memory, then the cluster syncs.
// Its slice of each transform, NK x LW fp32 with LW = 32 * CPT columns
// (zero beyond w), is either resident (copied once per launch) or
// streamed from L2 in KT-row tiles through a kStages-deep cp.async ring.
// A transform used transposed (the backward's contraction against
// ct_mid's second axis) is held as LW rows of its slice of rows, KT + 4
// (resident: NK + 4) floats apart, so a lane's 16-byte reads along k do
// not collide in the banks.
//
// Inside a CTA the 8 warps split k: warp ks sums its eighth of every
// tile's rows in k order, lane l owns columns l + 32 cc.  The partials
// meet in shared memory and are summed in warp order (fixed: identical
// bits every run, no atomics).
// ---------------------------------------------------------------------------

namespace acdc::cl {

constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// src_bytes = 0 reads nothing and zero-fills dst (the ragged edges)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}
// the cluster barrier in two halves: writes before arrive are visible to
// every CTA of the cluster after its wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the address of `p` (this CTA's shared memory) in CTA `rank`'s
__device__ __forceinline__ float* map_rank(float* p, unsigned rank) {
  unsigned long long in = reinterpret_cast<unsigned long long>(p), out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(in), "r"(rank));
  return reinterpret_cast<float*>(out);
}

// Launch geometry, the same numbers as the wrapper's plan().
struct Geo {
  int N, NK, KT, NT;  // size, padded depth, tile rows, tiles a product
  int S, W;           // cluster size, columns a slice (the last: fewer)
  int j0, w;          // this CTA's first column and width (set in-kernel)
  int vec;            // 1: 16-byte copies (N % 4 == 0, aligned), 0: 4-byte
  int resident;       // 1: transform slices resident, 0: streamed
  int slot;           // floats of a ring slot (streamed)

  // this CTA's slice: rank * W, as wide as N leaves
  __device__ void own(unsigned rank) {
    j0 = (int)rank * W;
    w = min(W, N - j0);
  }
};

// Host side: the geometry of a plan, checked; false if it is not one.
inline bool make_geo(Geo& g, int N, int S, int W, int LW, int NK, int KT,
                     int resident, int vec, bool trans) {
  if (N < 1 || S < 1 || S > 16 || W < 1 || W > LW || (long long)S * W < N ||
      (long long)(S - 1) * W >= N || NK < N || NK % 32 || KT < 32 ||
      KT % 32 || NK % KT || (resident && KT != NK) ||
      (vec && (N % 4 || W % 4)))
    return false;
  g.N = N; g.NK = NK; g.KT = KT; g.NT = NK / KT; g.S = S; g.W = W;
  g.j0 = 0; g.w = 0; g.vec = vec; g.resident = resident;
  g.slot = trans ? LW * (KT + 4) : KT * LW;
  return true;
}

// floats of shared memory of the transforms: `nmats` normal slices (and
// one transposed one when `trans`), resident or a kStages ring
__host__ __device__ inline long long mats_floats(int NK, int KT, int LW,
                                                 int nmats, bool trans,
                                                 bool resident) {
  if (resident)
    return (long long)nmats * NK * LW + (trans ? (long long)LW * (NK + 4)
                                               : 0);
  const long long slot = trans ? (long long)LW * (KT + 4) : (long long)KT * LW;
  return kStages * slot;
}

// Issue the copies of rows [k0, k0 + kt) of this CTA's slice of `m`
// (N x N row-major) into `dst`: normal (kt x LW, row stride LW) or
// transposed (LW x kt, row stride kt + 4).  Out of range: zeros.
template <int LW>
__device__ __forceinline__ void copy_slice(float* dst, const float* m,
                                           bool trans, int k0, int kt,
                                           const Geo& g) {
  const int tid = threadIdx.x;
  if (!trans) {
    if (g.vec) {
      constexpr int C4 = LW / 4;
      for (int c = tid; c < kt * C4; c += kThreads) {
        const int k = c / C4, jj = (c % C4) * 4;
        const bool ok = k0 + k < g.N && jj < g.w;
        cp_async16(dst + k * LW + jj,
                   ok ? m + (long long)(k0 + k) * g.N + g.j0 + jj : m, ok);
      }
    } else {
      for (int e = tid; e < kt * LW; e += kThreads) {
        const int k = e / LW, jj = e % LW;
        const bool ok = k0 + k < g.N && jj < g.w;
        cp_async4(dst + e,
                  ok ? m + (long long)(k0 + k) * g.N + g.j0 + jj : m, ok);
      }
    }
  } else {
    const int ld = kt + 4;
    if (g.vec) {
      const int c4 = kt / 4;
      for (int c = tid; c < LW * c4; c += kThreads) {
        const int jj = c / c4, kk = (c % c4) * 4;
        const bool ok = jj < g.w && k0 + kk < g.N;
        cp_async16(dst + jj * ld + kk,
                   ok ? m + (long long)(g.j0 + jj) * g.N + k0 + kk : m, ok);
      }
    } else {
      for (int e = tid; e < LW * kt; e += kThreads) {
        const int jj = e / kt, kk = e % kt;
        const bool ok = jj < g.w && k0 + kk < g.N;
        cp_async4(dst + jj * ld + kk,
                  ok ? m + (long long)(g.j0 + jj) * g.N + k0 + kk : m, ok);
      }
    }
  }
}

// acc[r][cc] += sum over k in [kb, ke) of src[r * ldh + ks + k] * W(k, j),
// j = lane + 32 cc, W(k, j) = tile[k * ld + j] (normal) or
// tile[j * ld + k] (TRANS); k ascending, four at a time.
template <int BM, int CPT, bool TRANS>
__device__ __forceinline__ void tile_fma(const float* __restrict__ src,
                                         int ldh, int ks,
                                         const float* __restrict__ tile,
                                         int ld, int kb, int ke,
                                         float (&acc)[BM][CPT]) {
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int k = kb; k < ke; k += 4) {
    float wv[CPT][4];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int j = lane + 32 * cc;
      if (TRANS) {
        const float4 v = *reinterpret_cast<const float4*>(tile + j * ld + k);
        wv[cc][0] = v.x; wv[cc][1] = v.y; wv[cc][2] = v.z; wv[cc][3] = v.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) wv[cc][u] = tile[(k + u) * ld + j];
      }
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const float4 hv =
          *reinterpret_cast<const float4*>(src + r * ldh + ks + k);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        acc[r][cc] = fmaf(hv.x, wv[cc][0], acc[r][cc]);
        acc[r][cc] = fmaf(hv.y, wv[cc][1], acc[r][cc]);
        acc[r][cc] = fmaf(hv.z, wv[cc][2], acc[r][cc]);
        acc[r][cc] = fmaf(hv.w, wv[cc][3], acc[r][cc]);
      }
    }
  }
}

// The products of one launch, in order.  `Seq` maps a product index to
// the id of its transform: ids 0 .. nmats-1 are used as given (normal),
// id `trans_id` (if >= 0) transposed.  Resident: the slices are copied
// once, the first product's transform in the first commit group, the
// rest in the second.  Streamed: tile q of the launch (product q / NT,
// rows (q % NT) * KT ...) is copied kStages - 1 tiles ahead, across
// product boundaries (the transforms do not depend on the data).
template <int BM, int CPT, bool STREAM, typename Seq>
struct Products {
  static constexpr int LW = 32 * CPT;
  float* mats;             // resident slabs or the ring
  const float* const* gm;  // global transforms by id
  int trans_id, nmats, total;  // transposed id, normal ids, products
  Geo g;
  Seq seq;

  __device__ float* slab(int id) const {
    return mats + (long long)id * g.NK * LW;  // the transposed one is last
  }
  __device__ void issue_tile(int q) {
    if (q < total * g.NT) {
      const int id = seq(q / g.NT);
      copy_slice<LW>(mats + (long long)(q % kStages) * g.slot, gm[id],
                     id == trans_id, (q % g.NT) * g.KT, g.KT, g);
    }
    cp_async_commit();
  }
  __device__ void prologue() {
    if (!STREAM) {
      const int first = seq(0);
      copy_slice<LW>(slab(first), gm[first], first == trans_id, 0, g.NK, g);
      cp_async_commit();
      for (int id = 0; id < nmats; ++id)
        if (id != first) copy_slice<LW>(slab(id), gm[id], false, 0, g.NK, g);
      if (trans_id >= 0 && trans_id != first)
        copy_slice<LW>(slab(trans_id), gm[trans_id], true, 0, g.NK, g);
      cp_async_commit();
    } else {
      for (int q = 0; q < kStages - 1; ++q) issue_tile(q);
    }
  }
  // acc = src (BM x NK, full rows) times this CTA's slice of product p's
  // transform; this warp's share of k only (see reduce)
  __device__ void run(int p, const float* src, float (&acc)[BM][CPT]) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[r][cc] = 0.f;
    const int warp = threadIdx.x >> 5;
    const int id = seq(p);
    const bool tr = id == trans_id;
    if (!STREAM) {
      if (p == 0) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      const int kb = warp * (g.NK / kWarps), ke = kb + g.NK / kWarps;
      if (tr)
        tile_fma<BM, CPT, true>(src, g.NK, 0, slab(id), g.NK + 4, kb, ke, acc);
      else
        tile_fma<BM, CPT, false>(src, g.NK, 0, slab(id), LW, kb, ke, acc);
    } else {
      const int kb = warp * (g.KT / kWarps), ke = kb + g.KT / kWarps;
      for (int t = 0; t < g.NT; ++t) {
        const int q = p * g.NT + t;
        cp_async_wait<kStages - 2>();
        __syncthreads();
        issue_tile(q + kStages - 1);
        const float* tile = mats + (long long)(q % kStages) * g.slot;
        if (tr)
          tile_fma<BM, CPT, true>(src, g.NK, t * g.KT, tile, g.KT + 4, kb,
                                  ke, acc);
        else
          tile_fma<BM, CPT, false>(src, g.NK, t * g.KT, tile, LW, kb, ke,
                                   acc);
      }
    }
  }
};

// Partials of the 8 warps to red (kWarps x BM x LW); after the barrier,
// sum(red, r, jj) is the finished product at (row r, column j0 + jj).
template <int BM, int CPT>
__device__ __forceinline__ void reduce(float* red, const float (&acc)[BM][CPT]) {
  constexpr int LW = 32 * CPT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      red[(warp * BM + r) * LW + lane + 32 * cc] = acc[r][cc];
  __syncthreads();
}
template <int BM, int CPT>
__device__ __forceinline__ float sum(const float* red, int r, int jj) {
  constexpr int LW = 32 * CPT;
  float s = red[r * LW + jj];
#pragma unroll
  for (int ks = 1; ks < kWarps; ++ks) s += red[(ks * BM + r) * LW + jj];
  return s;
}

// The epilogue's thread mapping: warp w takes rows w, w + 8, ...; lane l
// columns l + 32 cc.  RPW rows a warp.
template <int BM>
struct Rows {
  static constexpr int RPW = (BM + kWarps - 1) / kWarps;
};

// Write v[rr][cc] (row warp + 8 rr, column j0 + lane + 32 cc, valid where
// the row is < rows and the column < w) into `buf` (BM x NK) of every CTA
// of the cluster.
template <int BM, int CPT>
__device__ __forceinline__ void broadcast(float* buf,
                                          const float (&v)[Rows<BM>::RPW][CPT],
                                          int rows, const Geo& g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = 0; q < g.S; ++q) {
    float* dst = map_rank(buf, q);
#pragma unroll
    for (int rr = 0; rr < Rows<BM>::RPW; ++rr) {
      const int r = warp + kWarps * rr;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int jj = lane + 32 * cc;
        if (r < rows && jj < g.w) dst[r * g.NK + g.j0 + jj] = v[rr][cc];
      }
    }
  }
}

// out[i] = the sum over clusters b of part[b * stride + i] for i < len,
// pairwise in a fixed shape: eight partials at a time (loaded together,
// summed as a tree; zeros past the end), each group joining a stack of
// sums of 1, 2, 4, ... groups that merges equal sizes, so the error grows
// with log2(nblocks) and two runs give identical bits (no atomics).
__global__ void __launch_bounds__(kThreads)
sum_partials_pairwise(const float* __restrict__ part,
                      float* __restrict__ out, int nblocks, int stride,
                      int len) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= len) return;
  float sums[32];
  int sizes[32];
  int top = 0;
  for (int b0 = 0; b0 < nblocks; b0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = b0 + u < nblocks ? part[(long long)(b0 + u) * stride + i] : 0.f;
    float s = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
    int size = 1;
    while (top > 0 && sizes[top - 1] == size) {
      s = sums[--top] + s;
      size *= 2;
    }
    sums[top] = s;
    sizes[top++] = size;
  }
  float s = sums[--top];
  while (top > 0) s = sums[--top] + s;
  out[i] = s;
}

inline cudaError_t launch_sum_partials_pairwise(const float* part,
                                                float* out, int nblocks,
                                                int stride, int len,
                                                cudaStream_t stream) {
  sum_partials_pairwise<<<(len + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(part, out, nblocks, stride, len);
  return cudaGetLastError();
}

// Host side: set a kernel's attributes once (the largest dynamic shared
// memory and, above 8 CTAs, non-portable cluster sizes), then fill the
// launch configuration of a grid of `clusters` clusters of S CTAs.
template <typename Kern>
inline cudaError_t prepare(Kern kern) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

struct LaunchCfg {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  LaunchCfg(int S, int clusters, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(S * clusters, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

}  // namespace acdc::cl
