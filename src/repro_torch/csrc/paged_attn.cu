// Paged-attention decode/verify: write the T new tokens' K/V into their
// pages, then attend over the slot's mapped prefix plus the new tokens.
//
// Replaces: src/repro/kernels/paged_attn.py, _kernel via paged_attention.
// Mask contract (paged_attn.py:27-43): streamed keys kpos < position
// (and qpos - kpos < window when window > 0), read through the block
// table with unmapped entries reading page 0; new-token keys kpos <= qpos,
// kpos < virtual (= MB * bs) and the window; rows parked at/beyond the
// virtual length stream nothing.  Masked scores are -1e30 inside the
// online softmax exactly as in the reference, so an all-masked (parked)
// row averages the new tokens' values.  New K/V whose page is unmapped,
// or whose position is at/beyond the virtual row, go to the trash page
// n_pages - 1.  The body takes T as a parameter (T=1 decode; T=k+1 for
// speculative verify later).
//
// What bounds it on the H100: decode attention is byte-bound -- each
// (slot, KV head) reads len * Dh * 2 * itemsize bytes of K/V once and
// does ~4 * group * T flops per byte of it.
//
// Design, simple first: one block of 128 threads per (slot, KV head).
// It (1) writes the new K/V rows in place, (2) streams the prefix in
// tiles of 32 keys from the pools into shared memory (coalesced along
// Dh), scores each (query row, key) pair with a shared-memory dot product
// (query rows = group x T, at most 16), runs the fp32 online-softmax
// update one thread per row, and accumulates P @ V with thread d owning
// output dimension d for every row in registers, and (3) folds the new
// tokens the same way from the kernel's inputs (not re-read from the
// pool).  Reads never touch what step (1) writes: they stop at
// kpos < position.  Allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

constexpr int kThreads = 128;
constexpr int KT = 32;     // keys per streamed tile
constexpr int MAXR = 16;   // query rows per block: group * T
constexpr int MAXD = 128;  // head dim

struct Smem {
  float q[MAXR][MAXD];
  float k[KT][MAXD + 1];   // +1: the dot products read k by key, no conflicts
  float v[KT][MAXD];
  float s[MAXR][KT];
  float m[MAXR], l[MAXR], corr[MAXR];
};

// Fold keys sm.k/sm.v[0..nk) (positions base .. base+nk-1) into the
// running (m, l, acc) state of every query row.
__device__ __forceinline__ void fold(Smem& sm, float (&acc)[MAXR], int nk,
                                     int base, bool is_new, int rows, int T,
                                     int Dh, int pos, int virt, int window,
                                     float softcap, float scale) {
  const int tid = threadIdx.x;
  for (int e = tid; e < rows * KT; e += kThreads) {
    const int r = e / KT, j = e % KT;
    if (j >= nk) continue;
    float dot = 0.f;
    for (int dd = 0; dd < Dh; ++dd) dot = fmaf(sm.q[r][dd], sm.k[j][dd], dot);
    float s = dot * scale;
    if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    const int qpos = pos + r % T;
    const int kpos = base + j;
    bool ok = is_new ? (kpos <= qpos && kpos < virt) : true;
    if (window > 0) ok = ok && (qpos - kpos < window);
    sm.s[r][j] = ok ? s : -1e30f;
  }
  __syncthreads();
  if (tid < rows) {
    const int r = tid;
    const float m_old = sm.m[r];
    float mx = m_old;
    for (int j = 0; j < nk; ++j) mx = fmaxf(mx, sm.s[r][j]);
    const float corr = expf(m_old - mx);
    float sum = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(sm.s[r][j] - mx);
      sm.s[r][j] = p;
      sum += p;
    }
    sm.l[r] = sm.l[r] * corr + sum;
    sm.m[r] = mx;
    sm.corr[r] = corr;
  }
  __syncthreads();
  if (tid < Dh) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r >= rows) break;
      float a = acc[r] * sm.corr[r];
      for (int j = 0; j < nk; ++j) a = fmaf(sm.s[r][j], sm.v[j][tid], a);
      acc[r] = a;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ knew,
                  const T* __restrict__ vnew, T* kp, T* vp,
                  const int* __restrict__ tables,
                  const int* __restrict__ position, T* __restrict__ out,
                  int Tn, int Hq, int Hkv, int Dh, int n_pages, int bs,
                  int MB, int window, float softcap, float scale) {
  __shared__ Smem sm;
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int group = Hq / Hkv;
  const int rows = group * Tn;
  const int virt = MB * bs;
  const int pos = position[b];
  const int* tbl = tables + (long long)b * MB;

  // 1. persist the new tokens' K/V head slice (trash-routed when unmapped
  //    or at/beyond the virtual row)
  for (int e = tid; e < Tn * Dh; e += kThreads) {
    const int t = e / Dh, dd = e % Dh;
    const int qpos = pos + t;
    const int page_t = tbl[min(qpos / bs, MB - 1)];
    const bool writable = page_t >= 0 && qpos < virt;
    const long long page = writable ? page_t : n_pages - 1;
    const long long src = ((long long)(b * Tn + t) * Hkv + h) * Dh + dd;
    const long long dst = ((page * bs + qpos % bs) * Hkv + h) * Dh + dd;
    kp[dst] = knew[src];
    vp[dst] = vnew[src];
  }

  // query rows r = g * Tn + t of heads h * group + g
  for (int e = tid; e < rows * Dh; e += kThreads) {
    const int r = e / Dh, dd = e % Dh;
    const int g = r / Tn, t = r % Tn;
    sm.q[r][dd] =
        to_f(q[((long long)(b * Tn + t) * Hq + h * group + g) * Dh + dd]);
  }
  if (tid < rows) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  __syncthreads();

  // 2. stream the mapped prefix [kstart, frontier); keys before the
  //    window start are masked for every row, so they are skipped
  const int frontier = pos < virt ? pos : 0;
  const int kstart = window > 0 ? max(pos - window + 1, 0) : 0;
  for (int k0 = kstart; k0 < frontier; k0 += KT) {
    const int nk = min(KT, frontier - k0);
    for (int e = tid; e < nk * Dh; e += kThreads) {
      const int j = e / Dh, dd = e % Dh;
      const int kpos = k0 + j;
      const long long page = max(tbl[kpos / bs], 0);
      const long long idx = ((page * bs + kpos % bs) * Hkv + h) * Dh + dd;
      sm.k[j][dd] = to_f(kp[idx]);
      sm.v[j][dd] = to_f(vp[idx]);
    }
    __syncthreads();
    fold(sm, acc, nk, k0, false, rows, Tn, Dh, pos, virt, window, softcap,
         scale);
  }

  // 3. the new tokens attend from the kernel's inputs
  for (int e = tid; e < Tn * Dh; e += kThreads) {
    const int j = e / Dh, dd = e % Dh;
    const long long src = ((long long)(b * Tn + j) * Hkv + h) * Dh + dd;
    sm.k[j][dd] = to_f(knew[src]);
    sm.v[j][dd] = to_f(vnew[src]);
  }
  __syncthreads();
  fold(sm, acc, Tn, pos, true, rows, Tn, Dh, pos, virt, window, softcap,
       scale);

  if (tid < Dh) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r >= rows) break;
      const int g = r / Tn, t = r % Tn;
      out[((long long)(b * Tn + t) * Hq + h * group + g) * Dh + tid] =
          from_f<T>(acc[r] / fmaxf(sm.l[r], 1e-30f));
    }
  }
}

}  // namespace

// q (B, T, Hq, Dh); knew, vnew (B, T, Hkv, Dh); pools kp, vp
// (n_pages, bs, Hkv, Dh) updated in place, page n_pages-1 the trash page;
// tables (B, MB) int32 (-1 unmapped); position (B,) int32; out
// (B, T, Hq, Dh).  One dtype for all of q/knew/vnew/pools/out (fp32 or
// bf16).  Needs Dh <= 128, (Hq/Hkv) * T <= 16, T <= 32.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int paged_attn_launch(const void* q, const void* knew,
                                 const void* vnew, void* kp, void* vp,
                                 const void* tables, const void* position,
                                 void* out, int B, int Tn, int Hq, int Hkv,
                                 int Dh, int n_pages, int bs, int MB,
                                 int window, float softcap, float scale,
                                 int is_bf16, void* stream) {
  if (Dh > MAXD || Tn > KT || (Hq / Hkv) * Tn > MAXR)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto ti = static_cast<const int*>(tables);
  auto pi = static_cast<const int*>(position);
  if (B > 0) {
    dim3 grid(B, Hkv);
    if (is_bf16) {
      using T = __nv_bfloat16;
      paged_attn_kernel<T><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(knew),
          static_cast<const T*>(vnew), static_cast<T*>(kp),
          static_cast<T*>(vp), ti, pi, static_cast<T*>(out), Tn, Hq, Hkv, Dh,
          n_pages, bs, MB, window, softcap, scale);
    } else {
      paged_attn_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(knew),
          static_cast<const float*>(vnew), static_cast<float*>(kp),
          static_cast<float*>(vp), ti, pi, static_cast<float*>(out), Tn, Hq,
          Hkv, Dh, n_pages, bs, MB, window, softcap, scale);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
