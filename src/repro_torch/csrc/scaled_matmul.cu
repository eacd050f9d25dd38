// Scaled matmul  y = ((x * pre) @ w) * post + bias   (fp32 accumulation,
// output in x's dtype; w is any (K, N) row-major fp32 matrix).
//
// Replaces: src/repro/kernels/scaled_matmul.py, _smm_kernel via
// scaled_matmul_pallas (the TPU's "multiple call" building block).  Two
// calls make one large-N ACDC layer, three fp32 calls its backward
// (kernels/ops.py).  The reference's rounding points are kept: x * pre is
// rounded to fp32 before the product, post and bias are applied with
// separate roundings (__fmul_rn, __fadd_rn), and the result is cast once.
//
// Two regimes on the H100, each with its own design; the pure-Python
// plan() in kernels/scaled_matmul.py picks the regime (M <= 16: stream),
// the tile, the K splits and the copy width, and the wrapper passes them.
//
// 1. Weight stream (small M: decode, 4 slots).  Each call must read the
//    whole fp32 w once (151 MB at N = 6144) for only 2MKN flops: it is
//    bound by device-memory bytes (3.35 TB/s, 45 us at N = 6144).  A
//    block owns a 128-column strip of w (512 B a row) and one K range
//    (split-K, about four blocks an SM), keeps its rows of x * pre (fp32,
//    k-major) in shared memory, and streams its w rows through a 4-stage
//    ring of 16 KB stages with 16-byte cp.async copies (48 KB in flight a
//    block).  Each warp owns 4 rows of every stage and each lane 4
//    columns, so the M x 4 sums live in registers; the 8 warps' sums
//    meet in shared memory in warp order.
//
// 2. Tensor cores, 3xTF32 (larger M: prefill, training).  Bound by
//    operations: 67 TFLOP/s for fp32 FMAs, 495 TFLOP/s in TF32 (wgmma;
//    mma.sync reaches ~318 on an H100 80GB HBM3 at 700 W, so 3xTF32 at
//    most ~106 fp32-equivalent).  Each fp32 operand v is split as it leaves shared
//    memory into big = tf32(v) and small = tf32(v - big)
//    (cvt.rna.tf32.f32), and three m16n8k8 mma.sync products
//    (small.big + big.small + big.big) are summed in fp32: near-fp32
//    accuracy.  x and w tiles stream through a cp.async ring in dynamic
//    shared memory, rows padded so every fragment load is free of bank
//    conflicts.  Tiles: 128 x 128 (8 warps of 32 x 64) and 64 x 128 (4
//    warps of 32 x 64, two blocks an SM); where one tile row leaves SMs
//    idle (M = 64) K is split as in regime 1.  bf16 x is widened and
//    scaled by pre before the split, so x is split too.  What holds it
//    under the mma.sync ceiling is the split itself: 5 instructions an
//    element of x, 4 of w, repeated by every warp that shares the tile.
//
// Groups (the MoE experts' cascades, which the reference runs under
// jax.vmap: the vmapped pallas_call gets a grid axis over the experts):
// pre (G, K), post and bias (G, N) for x (G * C, K), row r scaled by the
// vectors of group r / C, and w (the shared DCT matrix) read once for all
// G groups -- one M = G * C product, not G products that each re-read w.
// The scalings already ride each row in registers, so a group costs one
// index a row: in the weight stream's x * pre and in the epilogue; the
// tensor-core regime stages a per-row pre tile beside x (smm_tc's GP
// instances) instead of one pre slice.  Ungrouped calls are C = M.
//
// Summation order: two levels in both regimes.  Each BK = 32 slice of K
// is summed into fresh registers (a thread's own rows in regime 1, the
// mma accumulator in regime 2) and added to the running total once per
// slice; K splits write fp32 partials to a (splits, M, N) workspace that
// smm_reduce sums in split order and finishes (post, bias, cast).  The
// tensor cores' fp32 accumulation drops low bits at every mma, so a
// single accumulator over all of K drifts ~40 x further from fp64 than
// cuBLAS fp32 does; the per-slice level holds it under cuBLAS.  No float
// atomics: two runs give the same bits.  Ragged M/N/K edges are
// zero-filled by the copies (src-size 0), never padded by copying; where
// N (or K for x) is not a multiple of 16 bytes the copies are 4 bytes
// wide (and x is loaded element by element).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;  // K rows a pipeline stage (and a summation slice)

// --- asynchronous copies (sm_80+) -----------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// src_bytes = 0 reads nothing and zero-fills dst: the ragged edges
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

// --- shared arguments and the epilogue ------------------------------------

template <typename T>
struct Args {
  const T* x;         // (M, K)
  const float* w;     // (K, N)
  const float* pre;   // (G, K) or null
  const float* post;  // (G, N) or null
  const float* bias;  // (G, N) or null
  T* y;               // (M, N)
  float* ws;          // (splits, M, N) fp32 partials; null when splits == 1
  int M, N, K;
  int kc;             // K rows a split, a multiple of kBK
  int C;              // rows a group (M when ungrouped: G = 1)
};

template <typename T>
__device__ __forceinline__ void finish(float v, long long row, int col,
                                       const float* post, const float* bias,
                                       T* y, int N, int C) {
  // separate roundings, as the reference (no FMA contraction); the
  // vectors of row's group
  const long long g = row / C * N;
  if (post != nullptr) v = __fmul_rn(v, post[g + col]);
  if (bias != nullptr) v = __fadd_rn(v, bias[g + col]);
  y[row * N + col] = from_f<T>(v);
}

// one output's sum from one block: a partial (K split) or the result
template <typename T>
__device__ __forceinline__ void emit(const Args<T>& a, float v, int row,
                                     int col) {
  if (a.ws != nullptr)
    a.ws[((long long)blockIdx.z * a.M + row) * a.N + col] = v;
  else
    finish<T>(v, row, col, a.post, a.bias, a.y, a.N, a.C);
}

// --- regime 1: the weight stream ------------------------------------------

constexpr int kStreamBN = 128;
constexpr int kStreamStages = 4;
constexpr int kStreamRing = kStreamStages * kBK * kStreamBN;  // floats

// grid (ceil(M / MT), ceil(N / 128), splits); shared memory: the ring, then
// x * pre of the block's MT rows over its K range, k-major [kc][MT]
template <typename T, int MT, bool Vec>
__global__ void __launch_bounds__(kThreads)
    smm_stream(const Args<T> a) {
  static_assert(MT % 4 == 0 && kWarps * MT * kStreamBN <= kStreamRing,
                "the warp sums must fit the ring");
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* xs = smem + kStreamRing;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * kStreamBN;
  const int k0 = blockIdx.z * a.kc;
  const int k1 = min(a.K, k0 + a.kc);
  const int slices = (k1 - k0 + kBK - 1) / kBK;

  auto load = [&](int s) {  // slice s of w's strip into its ring stage
    float* dst = ring + (s % kStreamStages) * kBK * kStreamBN;
    const int kb = k0 + s * kBK;
    if (Vec) {
#pragma unroll
      for (int i = 0; i < kBK * kStreamBN / 4 / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / (kStreamBN / 4), c = e % (kStreamBN / 4) * 4;
        const bool ok = kb + r < k1 && n0 + c < a.N;
        cp_async16(dst + r * kStreamBN + c,
                   ok ? a.w + (long long)(kb + r) * a.N + n0 + c : a.w, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < kBK * kStreamBN / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / kStreamBN, c = e % kStreamBN;
        const bool ok = kb + r < k1 && n0 + c < a.N;
        cp_async4(dst + r * kStreamBN + c,
                  ok ? a.w + (long long)(kb + r) * a.N + n0 + c : a.w, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStreamStages - 1; ++s) {
    if (s < slices) load(s);
    cp_async_commit();
  }
  // x * pre, rounded to fp32 as the reference, while the first w stages
  // are in flight (rows along threads: coalesced reads of x)
  const int span = slices * kBK;
  for (int e = tid; e < MT * span; e += kThreads) {
    const int m = e / span, k = e % span;
    const int gm = m0 + m, gk = k0 + k;
    float v = 0.f;
    if (gm < a.M && gk < k1) {
      v = to_f(a.x[(long long)gm * a.K + gk]);
      if (a.pre != nullptr)
        v = __fmul_rn(v, a.pre[(long long)(gm / a.C) * a.K + gk]);
    }
    xs[k * MT + m] = v;
  }

  const int c4 = lane * 4;  // this lane's 4 columns of the strip
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int s = 0; s < slices; ++s) {
    if (s + kStreamStages - 1 < slices) load(s + kStreamStages - 1);
    cp_async_commit();
    cp_async_wait<kStreamStages - 1>();
    __syncthreads();
    const float* wt = ring + (s % kStreamStages) * kBK * kStreamBN;
    const float* xt = xs + s * kBK * MT;
    float part[MT][4];  // this slice's sum: the first level
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[m][j] = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / kWarps; ++i) {
      const int r = warp + i * kWarps;
      const float4 wv =
          *reinterpret_cast<const float4*>(wt + r * kStreamBN + c4);
#pragma unroll
      for (int m = 0; m < MT; m += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xt + r * MT + m);
        const float xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          part[m + q][0] = fmaf(xm[q], wv.x, part[m + q][0]);
          part[m + q][1] = fmaf(xm[q], wv.y, part[m + q][1]);
          part[m + q][2] = fmaf(xm[q], wv.z, part[m + q][2]);
          part[m + q][3] = fmaf(xm[q], wv.w, part[m + q][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] += part[m][j];
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the 8 warps' sums meet in the (now idle) ring, added in warp order
  float* red = ring;
#pragma unroll
  for (int m = 0; m < MT; ++m)
    *reinterpret_cast<float4*>(red + (warp * MT + m) * kStreamBN + c4) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int e = tid; e < MT * kStreamBN; e += kThreads) {
    const int m = e / kStreamBN, c = e % kStreamBN;
    float v = red[m * kStreamBN + c];
#pragma unroll
    for (int w8 = 1; w8 < kWarps; ++w8) v += red[(w8 * MT + m) * kStreamBN + c];
    const int gm = m0 + m, gn = n0 + c;
    if (gm < a.M && gn < a.N) emit(a, v, gm, gn);
  }
}

// --- regime 2: 3xTF32 on the tensor cores ----------------------------------

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// v = big + small (+ what TF32 cannot hold of the remainder, ~2^-22 |v|)
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(__fsub_rn(v, __uint_as_float(big)));
}
// d += a (16 x 8, row) * b (8 x 8, col), fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a BM x BN block of WGM x WGN warps; TwoLevel: each BK slice summed into
// fresh registers before the running total (else one accumulator); GP:
// grouped pre, staged per row (BM x kBK, rows padded to PS) where the
// ungrouped tile stages one kBK slice of pre
template <typename T, int BM, int BN, int WGM, int WGN, bool TwoLevel,
          int Stages, bool GP>
struct TcTile {
  static constexpr int kThreads = WGM * WGN * 32;
  static constexpr int WM = BM / WGM, WN = BN / WGN;  // warp tile
  static constexpr int MI = WM / 16, NI = WN / 8;     // mma tiles a warp
  static constexpr int kStages = Stages;
  // rows padded (x by 16 bytes, w by 32): fragment loads hit 32 banks
  static constexpr int XS = kBK + 16 / (int)sizeof(T);
  static constexpr int WS = BN + 8;
  static constexpr int PS = kBK + 4;  // conflict-free like x's rows
  static constexpr int kXBytes = BM * XS * (int)sizeof(T);
  static constexpr int kWBytes = kBK * WS * 4;
  static constexpr int kPBytes = GP ? BM * PS * 4 : kBK * 4;
  static constexpr int kStageBytes = kXBytes + kWBytes + kPBytes;
  static constexpr int kSmem = kStages * kStageBytes;
  // two blocks an SM where both shared memory and registers allow (the
  // sums, two levels, take 8 MI NI registers a thread)
  static constexpr int kMinBlocks =
      2 * (kSmem + 1024) <= 233472 && 8 * MI * NI + 96 <= 65536 / (2 * kThreads)
          ? 2
          : 1;
  static_assert(kXBytes % 16 == 0 && kWBytes % 16 == 0, "16-byte stages");
};

// grid (ceil(M / BM), ceil(N / BN), splits): the row tiles that share a
// strip of w are neighbours in launch order, so w comes from HBM ~once
template <typename T, int BM, int BN, int WGM, int WGN, bool TwoLevel,
          int Stages, bool Vec, bool GP>
__global__ void __launch_bounds__(
    (TcTile<T, BM, BN, WGM, WGN, TwoLevel, Stages, GP>::kThreads),
    (TcTile<T, BM, BN, WGM, WGN, TwoLevel, Stages, GP>::kMinBlocks))
    smm_tc(const Args<T> a) {
  using L = TcTile<T, BM, BN, WGM, WGN, TwoLevel, Stages, GP>;
  constexpr int NT = L::kThreads;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int wm0 = warp / WGN * L::WM, wn0 = warp % WGN * L::WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k0 = blockIdx.z * a.kc;
  const int k1 = min(a.K, k0 + a.kc);
  const int slices = (k1 - k0 + kBK - 1) / kBK;

  auto x_tile = [&](int s) {
    return reinterpret_cast<T*>(tc_smem + (s % L::kStages) * L::kStageBytes);
  };
  auto w_tile = [&](int s) {
    return reinterpret_cast<float*>(
        tc_smem + (s % L::kStages) * L::kStageBytes + L::kXBytes);
  };

  auto load = [&](int s) {
    T* xd = x_tile(s);
    float* wd = w_tile(s);
    float* pd = wd + kBK * L::WS;
    const int kb = k0 + s * kBK;
    if (Vec) {
      constexpr int kPer = 16 / (int)sizeof(T);  // x elements a copy
      constexpr int kRowCopies = kBK / kPer;
#pragma unroll
      for (int i = 0; i < BM * kRowCopies / NT; ++i) {
        const int e = tid + i * NT;
        const int r = e / kRowCopies, c = e % kRowCopies * kPer;
        const bool ok = m0 + r < a.M && kb + c < k1;
        cp_async16(xd + r * L::XS + c,
                   ok ? a.x + (long long)(m0 + r) * a.K + kb + c : a.x, ok);
      }
#pragma unroll
      for (int i = 0; i < kBK * BN / 4 / NT; ++i) {
        const int e = tid + i * NT;
        const int r = e / (BN / 4), c = e % (BN / 4) * 4;
        const bool ok = kb + r < k1 && n0 + c < a.N;
        cp_async16(wd + r * L::WS + c,
                   ok ? a.w + (long long)(kb + r) * a.N + n0 + c : a.w, ok);
      }
    } else {
      // x element by element (bf16 rows of odd length cannot take 4-byte
      // copies); the stage is idle, so plain stores are safe
#pragma unroll 4
      for (int i = 0; i < BM * kBK / NT; ++i) {
        const int e = tid + i * NT;
        const int r = e / kBK, c = e % kBK;
        xd[r * L::XS + c] = (m0 + r < a.M && kb + c < k1)
                                ? a.x[(long long)(m0 + r) * a.K + kb + c]
                                : from_f<T>(0.f);
      }
#pragma unroll 4
      for (int i = 0; i < kBK * BN / NT; ++i) {
        const int e = tid + i * NT;
        const int r = e / BN, c = e % BN;
        const bool ok = kb + r < k1 && n0 + c < a.N;
        cp_async4(wd + r * L::WS + c,
                  ok ? a.w + (long long)(kb + r) * a.N + n0 + c : a.w, ok);
      }
    }
    if constexpr (GP) {
      // each row's group's pre over this slice
      if (Vec) {
#pragma unroll
        for (int i = 0; i < BM * kBK / 4 / NT; ++i) {
          const int e = tid + i * NT;
          const int r = e / (kBK / 4), c = e % (kBK / 4) * 4;
          const bool ok = m0 + r < a.M && kb + c < k1;
          cp_async16(pd + r * L::PS + c,
                     ok ? a.pre + (long long)((m0 + r) / a.C) * a.K + kb + c
                        : a.pre,
                     ok);
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < BM * kBK / NT; ++i) {
          const int e = tid + i * NT;
          const int r = e / kBK, c = e % kBK;
          const bool ok = m0 + r < a.M && kb + c < k1;
          cp_async4(pd + r * L::PS + c,
                    ok ? a.pre + (long long)((m0 + r) / a.C) * a.K + kb + c
                       : a.pre,
                    ok);
        }
      }
    } else if (a.pre != nullptr && tid < kBK) {
      const bool ok = kb + tid < k1;
      cp_async4(pd + tid, ok ? a.pre + kb + tid : a.pre, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < slices) load(s);
    cp_async_commit();
  }

  float acc[L::MI][L::NI][4];
#pragma unroll
  for (int i = 0; i < L::MI; ++i)
#pragma unroll
    for (int j = 0; j < L::NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int s = 0; s < slices; ++s) {
    if (s + L::kStages - 1 < slices) load(s + L::kStages - 1);
    cp_async_commit();
    cp_async_wait<L::kStages - 1>();
    __syncthreads();
    const T* xt = x_tile(s);
    const float* wt = w_tile(s);
    const float* pt = wt + kBK * L::WS;
    float part_[TwoLevel ? L::MI : 1][TwoLevel ? L::NI : 1][4];
    auto sum = [&](int i, int j) -> float(&)[4] {
      if constexpr (TwoLevel) return part_[i][j];
      else return acc[i][j];
    };
    if constexpr (TwoLevel) {
#pragma unroll
      for (int i = 0; i < L::MI; ++i)
#pragma unroll
        for (int j = 0; j < L::NI; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part_[i][j][q] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      const float p0 = !GP && a.pre != nullptr ? pt[kk + t] : 1.f;
      const float p1 = !GP && a.pre != nullptr ? pt[kk + t + 4] : 1.f;
      uint32_t ab[L::MI][4], as[L::MI][4], bb[L::NI][2], bs[L::NI][2];
#pragma unroll
      for (int i = 0; i < L::MI; ++i) {
        // A fragment: rows g, g+8; columns t, t+4 (x * pre, then split)
        const T* xr = xt + (wm0 + i * 16 + g) * L::XS + kk + t;
        float pa[4] = {p0, p0, p1, p1};
        if constexpr (GP) {   // the pre of each row's group
          const float* pr = pt + (wm0 + i * 16 + g) * L::PS + kk + t;
          pa[0] = pr[0];
          pa[1] = pr[8 * L::PS];
          pa[2] = pr[4];
          pa[3] = pr[8 * L::PS + 4];
        }
        split_tf32(__fmul_rn(to_f(xr[0]), pa[0]), ab[i][0], as[i][0]);
        split_tf32(__fmul_rn(to_f(xr[8 * L::XS]), pa[1]), ab[i][1],
                   as[i][1]);
        split_tf32(__fmul_rn(to_f(xr[4]), pa[2]), ab[i][2], as[i][2]);
        split_tf32(__fmul_rn(to_f(xr[8 * L::XS + 4]), pa[3]), ab[i][3],
                   as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < L::NI; ++j) {
        // B fragment: rows (k) t, t+4; column g
        const float* wc = wt + (kk + t) * L::WS + wn0 + j * 8 + g;
        split_tf32(wc[0], bb[j][0], bs[j][0]);
        split_tf32(wc[4 * L::WS], bb[j][1], bs[j][1]);
      }
      // small terms first; each pass over the MI x NI accumulators is
      // independent, so no mma waits on the one just issued
#pragma unroll
      for (int i = 0; i < L::MI; ++i)
#pragma unroll
        for (int j = 0; j < L::NI; ++j) mma_tf32(sum(i, j), as[i], bb[j]);
#pragma unroll
      for (int i = 0; i < L::MI; ++i)
#pragma unroll
        for (int j = 0; j < L::NI; ++j) mma_tf32(sum(i, j), ab[i], bs[j]);
#pragma unroll
      for (int i = 0; i < L::MI; ++i)
#pragma unroll
        for (int j = 0; j < L::NI; ++j) mma_tf32(sum(i, j), ab[i], bb[j]);
    }
    if constexpr (TwoLevel) {
#pragma unroll
      for (int i = 0; i < L::MI; ++i)
#pragma unroll
        for (int j = 0; j < L::NI; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += part_[i][j][q];
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // accumulator fragment: rows g (q 0, 1) and g+8 (q 2, 3), columns 2t, 2t+1
#pragma unroll
  for (int i = 0; i < L::MI; ++i)
#pragma unroll
    for (int j = 0; j < L::NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + wm0 + i * 16 + g + q / 2 * 8;
        const int col = n0 + wn0 + j * 8 + 2 * t + q % 2;
        if (row < a.M && col < a.N) emit(a, acc[i][j][q], row, col);
      }
}

// --- the K splits' partials, summed in split order -------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    smm_reduce(const float* __restrict__ ws, const float* __restrict__ post,
               const float* __restrict__ bias, T* __restrict__ y, int M,
               int N, int splits, int C) {
  const long long mn = (long long)M * N;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < mn;
       e += (long long)gridDim.x * kThreads) {
    float v = ws[e];
    for (int s = 1; s < splits; ++s) v += ws[s * mn + e];
    finish<T>(v, e / N, (int)(e % N), post, bias, y, N, C);
  }
}

// --- host side --------------------------------------------------------------

// raise a kernel's dynamic shared memory limit once (`allowed` is the
// kernel's own record of the limit set so far)
template <typename Kernel>
bool allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return true;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return false;
  allowed = bytes;
  return true;
}

template <typename T, int MT>
int launch_stream(const Args<T>& a, bool vec, dim3 grid, cudaStream_t s) {
  static int allowed[2] = {0, 0};
  const int bytes = (kStreamRing + a.kc * MT) * 4;
  auto kernel = vec ? smm_stream<T, MT, true> : smm_stream<T, MT, false>;
  if (!allow_smem(kernel, bytes, allowed[vec])) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, bytes, s>>>(a);
  return cudaSuccess;
}

// The two tensor-core tiles (BM, BN, warps along M, warps along N, two-
// level sums, ring stages), chosen by timing on an H100 (PERF.md): 8
// warps of 32 x 64 with a 3-stage ring, one block an SM; 4 warps of
// 32 x 64 with a 4-stage ring, two blocks an SM.  scripts/smm_variants.py
// rebuilds this source with others defined, to time them.
#ifndef SMM_TC_TILE_BIG
#define SMM_TC_TILE_BIG 128, 128, 4, 2, true, 3
#endif
#ifndef SMM_TC_TILE_SMALL
#define SMM_TC_TILE_SMALL 64, 128, 2, 2, true, 4
#endif

// one instance of a tile: the copy width and the pre staging
template <typename T, int BM, int BN, int WGM, int WGN, bool TwoLevel,
          int Stages, bool Vec, bool GP>
void launch_tc_as(const Args<T>& a, dim3 grid, cudaStream_t s, int& err) {
  using L = TcTile<T, BM, BN, WGM, WGN, TwoLevel, Stages, GP>;
  static int allowed = 0;
  auto kernel = smm_tc<T, BM, BN, WGM, WGN, TwoLevel, Stages, Vec, GP>;
  if (!allow_smem(kernel, L::kSmem, allowed)) return;
  kernel<<<grid, L::kThreads, L::kSmem, s>>>(a);
  err = cudaSuccess;
}

// launches when (bm, bn) is this tile's; else leaves err as it was
template <typename T, int BM, int BN, int WGM, int WGN, bool TwoLevel,
          int Stages>
void launch_tc(const Args<T>& a, int bm, int bn, bool vec, bool gp,
               dim3 grid, cudaStream_t s, int& err) {
  if (bm != BM || bn != BN) return;
  if (vec && gp)
    launch_tc_as<T, BM, BN, WGM, WGN, TwoLevel, Stages, true, true>(a, grid,
                                                                    s, err);
  else if (vec)
    launch_tc_as<T, BM, BN, WGM, WGN, TwoLevel, Stages, true, false>(
        a, grid, s, err);
  else if (gp)
    launch_tc_as<T, BM, BN, WGM, WGN, TwoLevel, Stages, false, true>(
        a, grid, s, err);
  else
    launch_tc_as<T, BM, BN, WGM, WGN, TwoLevel, Stages, false, false>(
        a, grid, s, err);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int dispatch(const Args<T>& a, int regime, int bm, int bn, int splits,
             int vec, cudaStream_t s) {
  // grouped pre (its rows staged per row on the tensor cores)
  const bool gp = a.pre != nullptr && a.C < a.M;
  // the plan's promises, checked: 16-byte copies only where legal
  if (vec) {
    const int per = 16 / (int)sizeof(T);
    if (a.N % 4 != 0 || !aligned16(a.w)) return cudaErrorInvalidValue;
    if (regime == 1 && (a.K % per != 0 || !aligned16(a.x)))
      return cudaErrorInvalidValue;
    if (regime == 1 && gp && (a.K % 4 != 0 || !aligned16(a.pre)))
      return cudaErrorInvalidValue;
  }
  dim3 grid((a.M + bm - 1) / bm, (a.N + bn - 1) / bn, splits);
  int err = cudaErrorInvalidValue;
  if (regime == 0 && bn == kStreamBN) {
    if (bm == 4) err = launch_stream<T, 4>(a, vec, grid, s);
    if (bm == 8) err = launch_stream<T, 8>(a, vec, grid, s);
    if (bm == 16) err = launch_stream<T, 16>(a, vec, grid, s);
  } else if (regime == 1) {
    launch_tc<T, SMM_TC_TILE_BIG>(a, bm, bn, vec, gp, grid, s, err);
    launch_tc<T, SMM_TC_TILE_SMALL>(a, bm, bn, vec, gp, grid, s, err);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)a.M * a.N;
  const int blocks = (int)std::min<long long>((mn + kThreads - 1) / kThreads,
                                              132 * 8);
  smm_reduce<T><<<blocks, kThreads, 0, s>>>(a.ws, a.post, a.bias, a.y, a.M,
                                            a.N, splits, a.C);
  return cudaSuccess;
}

}  // namespace

// x (M, K) fp32 or bf16 (x_is_bf16); w (K, N) fp32; pre (G, K), post
// (G, N), bias (G, N) fp32 or NULL, for G = M / C groups of C =
// rows_per_group rows (C = M: one group); y (M, N) in x's dtype.  All
// row-major and contiguous.  The plan (kernels/scaled_matmul.py: plan):
// regime 0 (weight stream, bm rows of x a block in {4, 8, 16}, bn = 128)
// or 1 (3xTF32,
// bm x bn in {128 x 128, 64 x 128}); `splits` K ranges of `kc` rows each
// (a multiple of 32, every range non-empty); ws an fp32 (splits, M, N)
// workspace when splits > 1, else NULL; vec 1 for 16-byte copies.
// Launches on `stream` (one kernel, two with splits > 1), allocates
// nothing, and returns cudaGetLastError() or cudaErrorInvalidValue for a
// plan it cannot serve.
extern "C" int smm_launch(const void* x, const void* w, const void* pre,
                          const void* post, const void* bias, void* y,
                          void* ws, int M, int N, int K, int x_is_bf16,
                          int regime, int bm, int bn, int splits, int kc,
                          int vec, int rows_per_group, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (rows_per_group < 1 || M % rows_per_group != 0)
    return cudaErrorInvalidValue;
  if (splits < 1 || kc <= 0 || kc % kBK != 0 ||
      (long long)splits * kc < K || (splits > 1 && (splits - 1LL) * kc >= K) ||
      (splits > 1) != (ws != nullptr))
    return cudaErrorInvalidValue;
  int err;
  if (x_is_bf16) {
    Args<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(x),
                          static_cast<const float*>(w),
                          static_cast<const float*>(pre),
                          static_cast<const float*>(post),
                          static_cast<const float*>(bias),
                          static_cast<__nv_bfloat16*>(y),
                          static_cast<float*>(ws), M, N, K, kc,
                          rows_per_group};
    err = dispatch(a, regime, bm, bn, splits, vec, s);
  } else {
    Args<float> a{static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<const float*>(pre),
                  static_cast<const float*>(post),
                  static_cast<const float*>(bias), static_cast<float*>(y),
                  static_cast<float*>(ws), M, N, K, kc, rows_per_group};
    err = dispatch(a, regime, bm, bn, splits, vec, s);
  }
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}
