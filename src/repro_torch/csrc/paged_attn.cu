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
// n_pages - 1.  T = 1 is decode, T = k + 1 speculative verify.
//
// What bounds it on the H100: decode attention is byte-bound.  Each
// (slot, KV head) reads len * Dh * 2 * itemsize bytes of K/V once and does
// 4 * group * T flops a key and dim: 2 flops a byte at T = 1 (group 2,
// bf16), 10 at T = 5, far below the card's 20 fp32 flops a byte, so fp32
// FMAs keep up with HBM and no tensor core is needed.  What it takes to
// reach the byte bound is parallelism and bytes in flight: a decode tick
// has only B * Hkv (slot, head) pairs (32 at B = 4) for 132 SMs.
//
// Design (split-KV, "flash decoding"):
// * the keys of each (slot, KV head) are split over `splits` CTAs, each a
//   fixed range of `pps` pages of the virtual row (the wrapper's plan,
//   from host integers only: no read of `position` on the host).  A split
//   wholly beyond the slot's position or before its window streams
//   nothing;
// * a CTA streams its range in tiles of `kt` keys, K and V rows of its
//   head (Dh * itemsize contiguous bytes each) copied with 16-byte
//   cp.async into two stages: the next tile is in flight while the warps
//   work on this one (deeper rings measured no faster);
// * the query rows of a (slot, KV head) (group * T of them, up to
//   16 * 32) are cut into row blocks of at most 16, each block its own
//   CTAs (grid y = KV heads x row blocks): every block streams the same
//   keys through the same split plan, so more rows cost more CTAs, never
//   more registers or shared memory a CTA;
// * inside a CTA, 4 warps split the keys: a row group, holding 2 query
//   rows (T = 1) or 4; more rows take more row groups of 4 warps, each
//   over every key of the tile in shared memory.  LPK = Dh / 8 lanes (rounded up
//   to a power of two) share a key row, each lane owning 8 dims of q, k,
//   v and the output, so a warp takes 32 / LPK keys at once; q.k is
//   reduced over the LPK lanes with shuffles; each key group (the LPK
//   lanes of one key) runs its own fp32 online softmax (running max m,
//   sum l, 8 dims of acc) over its keys, a few keys at a time;
// * the key groups of a warp merge by a shuffle butterfly, the warps of a
//   row group in warp order, the splits in split order: one merge
//   function, symmetric in its two sides, so every order above is fixed
//   and two runs give identical bits (no atomics);
// * the splits are combined by rank 0 of a thread block cluster (the
//   splits of one (slot, head); it reads the others' states through
//   distributed shared memory) or, where the plan has more splits than a
//   cluster takes, by a second kernel over a (B, Hkv, splits, rows,
//   Dh + 2) fp32 workspace.  Both merge the same states in the same order
//   with the same code: identical bits.  The combining CTA of each row
//   block folds the new tokens (from the kernel's inputs, not re-read
//   from the pool) and writes its rows' output; only row block 0's makes
//   the page writes, once per (slot, head).  Reads stop at kpos <
//   position, so they never race those writes.
//
// Softmax numerics: masked keys inside a split's range score -1e30 and
// enter the softmax as in the reference (a split that saw only masked
// keys has m = -1e30 and l counting them; merged with a split that saw a
// real key its weight is exp(-1e30 - m) = 0).  Keys outside every range
// are not scores at all: a key group or split that streamed nothing has
// m = -inf, l = 0, and the merge skips it (no exp(-inf - -inf)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kKeyWarps = 4;     // warps of a row group; they split keys
constexpr int kBlockRows = 16;   // query rows a row block (CTA) holds
constexpr int kMaxT = 32;
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;
// scores are kept in base 2 (s * log2 e), so every exponential is exp2
constexpr float kLog2e = 1.4426950408889634f;

enum Route { kSingle = 0, kCluster = 1, kTwoPass = 2 };

struct Args {
  const void *q, *knew, *vnew;
  void *kp, *vp;
  const int *tables, *position;
  void* out;
  float* ws;
  int B, T, Hq, Hkv, Dh, n_pages, bs, MB, window;
  float softcap, scale;
  int splits, pps, kt, route;
};

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

// 8 consecutive elements from shared memory (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
// (a bf16 is the upper half of the fp32 of the same value: one shift or
// mask an element); N consecutive elements, N a multiple of 8
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
    load8(p + 8 * i, *reinterpret_cast<float(*)[8]>(v + 8 * i));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// programmatic dependent launch: the combine kernel may start while the
// split kernel runs, and waits for its results before reading them
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// the address of `p` (this CTA's shared memory) in CTA `rank`'s
__device__ __forceinline__ const float* map_rank(const float* p,
                                                 unsigned rank) {
  unsigned long long in = reinterpret_cast<unsigned long long>(p), out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(in), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

// Keys [k0, k1) that split s streams for a slot at `pos`: its pages'
// keys inside [window start, frontier); parked rows stream nothing.
__device__ __forceinline__ void split_keys(int s, int pps, int bs, int pos,
                                           int virt, int window, int& k0,
                                           int& k1) {
  const int frontier = pos < virt ? pos : 0;
  const int kstart = window > 0 ? max(pos - window + 1, 0) : 0;
  k0 = max(s * pps * bs, kstart);
  k1 = min((s + 1) * pps * bs, frontier);
}

// a key's score in base 2 (masked keys take -1e30 instead): dot * scale,
// soft-capped as softcap * tanh(. / softcap) where SOFTCAP (a template
// parameter, so the common case is one multiply: left to the compiler, the
// capped path is if-converted into every score)
template <bool SOFTCAP>
__device__ __forceinline__ float score(float dot, float scale,
                                       float softcap) {
  if constexpr (SOFTCAP)
    return softcap * tanhf(dot * scale / softcap) * kLog2e;
  else
    return dot * scale * kLog2e;
}

// Fold state (m, l, a) into (M, L, A): the online-softmax merge.  It is
// symmetric in its two sides to the bit, and a side that saw no key
// (m = -inf) changes nothing.
__device__ __forceinline__ void merge1(float& M, float& L, float& A, float m,
                                       float l, float a) {
  if (m == -INFINITY) return;
  if (M == -INFINITY) {
    M = m; L = l; A = a;
    return;
  }
  const float mx = fmaxf(M, m);
  const float c0 = exp2f(M - mx), c1 = exp2f(m - mx);
  L = __fadd_rn(__fmul_rn(L, c0), __fmul_rn(l, c1));
  A = __fadd_rn(__fmul_rn(A, c0), __fmul_rn(a, c1));
  M = mx;
}
template <int N>
__device__ __forceinline__ void merge_n(float& M, float& L, float (&A)[N],
                                        float m, float l,
                                        const float (&a)[N]) {
  if (m == -INFINITY) return;
  if (M == -INFINITY) {
    M = m; L = l;
#pragma unroll
    for (int d = 0; d < N; ++d) A[d] = a[d];
    return;
  }
  const float mx = fmaxf(M, m);
  const float c0 = exp2f(M - mx), c1 = exp2f(m - mx);
  L = __fadd_rn(__fmul_rn(L, c0), __fmul_rn(l, c1));
#pragma unroll
  for (int d = 0; d < N; ++d)
    A[d] = __fadd_rn(__fmul_rn(A[d], c0), __fmul_rn(a[d], c1));
  M = mx;
}

// One element (row, dim d) of the splits' merged state: the largest m of
// the splits that streamed a key, then their l and acc weighted by
// 2^(m_s - M) and summed in split order (the loads independent of the
// sums).  `at(s)` points at split s's row (acc at [d], m at [mi], l at
// [mi + 1]); `live(s)` says whether it streamed a key.  Both combines run
// this same code on the same states: identical bits.
template <class At, class Live>
__device__ __forceinline__ void merge_splits(int S, int d, int mi, At at,
                                             Live live, float& M, float& L,
                                             float& A) {
  M = -INFINITY;
  for (int s = 0; s < S; ++s)
    if (live(s)) M = fmaxf(M, at(s)[mi]);
  L = 0.f;
  A = 0.f;
  if (M == -INFINITY) return;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    if (!live(s)) continue;
    const float* p = at(s);
    const float w = exp2f(p[mi] - M);
    L = fmaf(w, p[mi + 1], L);
    A = fmaf(w, d < 0 ? 0.f : p[d], A);
  }
}

// Layout of a split CTA's shared memory, the same on host and device:
// the two stages (reused for the warps' states once streamed), the query
// rows in fp32 (dims padded to DP = DPL * LPK), the CTA's state, each row
// acc[DP], m, l, the new tokens' K and V rows in fp32 and their write
// pages, and the split's pages (unmapped entries as page 0).
// dims a lane owns: 16 where a row group holds at most 2 query rows
// (decode, T = 1: fewer lanes a key, so fewer shuffles and less repeated
// softmax work a key), else 8 (registers); the lanes a key row takes
__host__ __device__ inline int dims_per_lane(int R) {
  return R <= 2 ? 16 : 8;
}
__host__ __device__ inline int lanes_per_key(int Dh, int dpl) {
  int l = 1;
  while (l * dpl < Dh) l *= 2;
  return l;
}
__host__ __device__ inline int rows_max(int R) { return R <= 2 ? 2 : 4; }
// rows a row block holds (the layout's rows) and the row blocks of R rows
__host__ __device__ inline int block_rows(int R) {
  return R < kBlockRows ? R : kBlockRows;
}
__host__ __device__ inline int row_blocks(int R) {
  return (R + kBlockRows - 1) / kBlockRows;
}
// the new tokens' K and V rows (fp32, dims padded to dp) and write pages
__host__ __device__ inline int new_bytes(int T, int dp) {
  return 2 * T * dp * 4 + (T + 3) / 4 * 16;
}
struct Layout {
  int rmax, rg, dp, region, qs, st, nk, pages, bytes;
  __host__ __device__ Layout(int R, int T, int Dh, int item, int kt,
                             int pps) {
    rmax = rows_max(R);
    rg = (R + rmax - 1) / rmax;
    const int dpl = dims_per_lane(R);
    dp = dpl * lanes_per_key(Dh, dpl);
    const int stages = 2 * 2 * kt * Dh * item;
    const int warps = kKeyWarps * rg * rmax * (dp + 2) * 4;
    region = ((stages > warps ? stages : warps) + 15) / 16 * 16;
    qs = region;
    st = qs + rg * rmax * dp * 4;
    nk = st + rg * rmax * (dp + 2) * 4;
    pages = nk + new_bytes(T, dp);
    bytes = pages + (pps + 3) / 4 * 16;
  }
};

// Copy keys [t0, t0 + nk) of head h (K and V rows) into a stage: thread
// tid takes 16-byte chunk tid % CPR of keys tid / CPR, + NT / CPR, ...
// (CPR: the chunks of a row, dims padded to DP; a padding chunk copies
// nothing); `pg` holds the split's pages from page p0 on.
template <typename T, int CPR>
__device__ __forceinline__ void issue_tile(T* dk, T* dv, const Args& a,
                                           const int* pg, int p0, int h,
                                           int t0, int nk) {
  constexpr int E = 16 / (int)sizeof(T);   // elements a chunk
  const int c = threadIdx.x % CPR;
  if (c * E >= a.Dh) return;
  const T* kp = static_cast<const T*>(a.kp) + c * E;
  const T* vp = static_cast<const T*>(a.vp) + c * E;
  for (int key = threadIdx.x / CPR; key < nk; key += blockDim.x / CPR) {
    const int kpos = t0 + key, p = kpos / a.bs;
    const long long row =
        (((long long)pg[p - p0] * a.bs + kpos - p * a.bs) * a.Hkv + h) *
        a.Dh;
    cp_async16(dk + key * a.Dh + c * E, kp + row);
    cp_async16(dv + key * a.Dh + c * E, vp + row);
  }
}

// The new tokens of (slot b, head h) into shared memory, from the inputs:
// their K and V rows in fp32 (dims padded to dp; the kernel's only reads
// of them) and, once `pos` is known (`pages` true), each token's write
// page: its table entry, or the trash page when unmapped or at/beyond the
// virtual row.
template <typename T>
__device__ __forceinline__ void load_new(const Args& a, float* nk, int dp,
                                         int b, int h) {
  const T* knew = static_cast<const T*>(a.knew);
  const T* vnew = static_cast<const T*>(a.vnew);
  float* nv = nk + a.T * dp;
  for (int e = threadIdx.x; e < a.T * dp; e += blockDim.x) {
    const int t = e / dp, d = e % dp;
    const long long src = ((long long)(b * a.T + t) * a.Hkv + h) * a.Dh + d;
    nk[e] = d < a.Dh ? to_f(knew[src]) : 0.f;
    nv[e] = d < a.Dh ? to_f(vnew[src]) : 0.f;
  }
}
__device__ __forceinline__ void write_pages(const Args& a, int* wp, int b,
                                            int pos) {
  const int* tbl = a.tables + (long long)b * a.MB;
  for (int t = threadIdx.x; t < a.T; t += blockDim.x) {
    const int qpos = pos + t;
    const int page = tbl[min(qpos / a.bs, a.MB - 1)];
    wp[t] = page >= 0 && qpos < a.MB * a.bs ? page : a.n_pages - 1;
  }
}

// The combining CTA's last step for (slot b, head h) and the Rl rows of
// its row block from R0 on, from the merged state `fin` (rows of acc[DP],
// m, l), the fp32 query rows `qs` and the new tokens `nk` (load_new,
// write_pages): their page writes (row block 0 only), their fold into
// every row's softmax, the output.  Warps take rows, lanes dims.
template <typename T>
__device__ __forceinline__ void finalize(const Args& a, const float* fin,
                                         const float* qs, const float* nk,
                                         int dp, int b, int h, int pos,
                                         int R0, int Rl) {
  T* kp = static_cast<T*>(a.kp);
  T* vp = static_cast<T*>(a.vp);
  T* out = static_cast<T*>(a.out);
  const int Tn = a.T, Dh = a.Dh, group = a.Hq / a.Hkv;
  const int virt = a.MB * a.bs;
  const float* nv = nk + Tn * dp;
  const int* wp = reinterpret_cast<const int*>(nv + Tn * dp);
  // 1. persist the new tokens' K/V head slice (bf16 -> fp32 -> bf16 is
  //    exact), once: by row block 0
  for (int e = threadIdx.x; R0 == 0 && e < Tn * Dh; e += blockDim.x) {
    const int t = e / Dh, dd = e % Dh;
    const int qpos = pos + t;
    const long long dst =
        (((long long)wp[t] * a.bs + qpos % a.bs) * a.Hkv + h) * Dh + dd;
    kp[dst] = from_f<T>(nk[t * dp + dd]);
    vp[dst] = from_f<T>(nv[t * dp + dd]);
  }
  // 2. fold the new tokens into each row, normalise
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < Rl; r += nwarps) {
    const int g = (R0 + r) / Tn, t = (R0 + r) % Tn, qpos = pos + t;
    const float* f = fin + r * (dp + 2);
    const float M = f[dp], L = f[dp + 1];
    float mx = M;
    float sj[kMaxT];
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j >= Tn) break;
      float part = 0.f;
      for (int d = lane; d < Dh; d += 32)
        part = fmaf(qs[r * dp + d], nk[j * dp + d], part);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(kFull, part, o);
      const int kpos = pos + j;
      const bool ok = kpos <= qpos && kpos < virt &&
                      (a.window <= 0 || qpos - kpos < a.window);
      sj[j] = !ok ? -1e30f
              : a.softcap > 0.f ? score<true>(part, a.scale, a.softcap)
                                : score<false>(part, a.scale, a.softcap);
      mx = fmaxf(mx, sj[j]);
    }
    const float corr = exp2f(M - mx);   // 0 when nothing was streamed
    float l = L * corr;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j >= Tn) break;
      sj[j] = exp2f(sj[j] - mx);
      l += sj[j];
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + ((long long)(b * Tn + t) * a.Hq + h * group + g) * Dh;
    for (int d = lane; d < Dh; d += 32) {
      float acc = f[d] * corr;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j >= Tn) break;
        acc = fmaf(sj[j], nv[j * dp + d], acc);
      }
      o[d] = from_f<T>(acc * inv);
    }
  }
}

// Query rows R0 + r = g * T + t (r < Rl) of heads h * group + g, fp32,
// dims padded; rows Rl .. rows - 1 zero
template <typename T>
__device__ __forceinline__ void load_q(const Args& a, float* qs, int rows,
                                       int dp, int b, int h, int R0,
                                       int Rl) {
  const T* q = static_cast<const T*>(a.q);
  const int group = a.Hq / a.Hkv;
  for (int e = threadIdx.x; e < rows * dp; e += blockDim.x) {
    const int r = e / dp, d = e % dp;
    float v = 0.f;
    if (r < Rl && d < a.Dh) {
      const int g = (R0 + r) / a.T, t = (R0 + r) % a.T;
      v = to_f(q[((long long)(b * a.T + t) * a.Hq + h * group + g) * a.Dh +
                 d]);
    }
    qs[e] = v;
  }
}

template <typename T, int LPK, int RMAX, bool SOFTCAP>
__global__ void __launch_bounds__(RMAX <= 2 ? 128 : 512, RMAX <= 2 ? 4 : 1)
paged_split(const Args a) {
  constexpr int KPW = 32 / LPK;           // keys a warp takes at once
  constexpr int NKG = kKeyWarps * KPW;    // key groups of a row group
  constexpr int KSUB = 2;                  // keys a key group folds at once
  constexpr int DPL = RMAX <= 2 ? 16 : 8;  // dims_per_lane
  constexpr int DP = DPL * LPK;
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = a.Hq / a.Hkv, Rall = group * a.T, Dh = a.Dh;
  const int nrb = row_blocks(Rall), RB = block_rows(Rall);
  const int split = blockIdx.x, h = blockIdx.y / nrb, b = blockIdx.z;
  // this CTA's row block: rows R0 .. R0 + R - 1 of the (slot, head)
  const int R0 = blockIdx.y % nrb * RB, R = min(RB, Rall - R0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int CPR = DP * (int)sizeof(T) / 16;   // 16-byte chunks a row
  const Layout lay(RB, a.T, Dh, (int)sizeof(T), a.kt, a.pps);
  const int rows = lay.rg * RMAX;
  T* stage = reinterpret_cast<T*>(smem);
  float* wst = reinterpret_cast<float*>(smem);   // after the stream
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* st = reinterpret_cast<float*>(smem + lay.st);
  float* nk = reinterpret_cast<float*>(smem + lay.nk);
  int* pg = reinterpret_cast<int*>(smem + lay.pages);
  launch_dependents();   // the combine kernel's prologue may start
  // one round trip: the position, and what does not depend on it (the
  // query rows, the split's pages, the finalizer's new tokens)
  const int pos = a.position[b], virt = a.MB * a.bs;
  const int* tbl = a.tables + (long long)b * a.MB;
  const int p0 = split * a.pps;
  const bool finalizer = split == 0 && a.route != kTwoPass;
  load_q<T>(a, qs, rows, DP, b, h, R0, R);
  for (int i = tid; i < a.pps && p0 + i < a.MB; i += blockDim.x)
    pg[i] = max(tbl[p0 + i], 0);
  if (finalizer) load_new<T>(a, nk, DP, b, h);
  int k0, k1;
  split_keys(split, a.pps, a.bs, pos, virt, a.window, k0, k1);
  const bool empty = k0 >= k1;
  if (empty && a.route == kTwoPass) return;
  if (empty && a.route == kCluster && split != 0) {
    cluster_sync();   // rank 0 reads no state of an empty split
    cluster_sync();
    return;
  }

  const int rg = warp / kKeyWarps, kw = warp % kKeyWarps;
  const int lk = lane % LPK, sub = lane / LPK, kg = kw * KPW + sub;
  // a lane past Dh reads dims 0 - 7 of its rows (finite) against a zero q;
  // what it adds to acc lies in padding never written out
  const int col = lk * DPL < Dh ? lk * DPL : 0;
  const int rbase = rg * RMAX;
  float m[RMAX], l[RMAX], acc[RMAX][DPL];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;
  }
  __syncthreads();

  if (!empty) {
    float qr[RMAX][DPL];   // this lane's dims of the group's q rows
    int kmin[RMAX];      // each row's first key inside the window
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      load_n<DPL>(qs + (rbase + r) * DP + lk * DPL, qr[r]);
      kmin[r] = a.window > 0 ? pos + (R0 + rbase + r) % a.T - a.window + 1
                             : INT_MIN;
    }
    // two stages: tile it + 1 in flight while the warps work on tile it
    const int kt = a.kt;
    auto issue = [&](int j) {
      const int t0 = k0 + j * kt;
      if (t0 < k1) {
        T* dst = stage + (j & 1) * 2 * kt * Dh;
        issue_tile<T, CPR>(dst, dst + kt * Dh, a, pg, p0, h, t0,
                           min(kt, k1 - t0));
      }
      cp_async_commit();
    };
    issue(0);
    // its loads overlap the tiles in flight
    if (finalizer) write_pages(a, reinterpret_cast<int*>(nk + 2 * a.T * DP),
                               b, pos);
    for (int t0 = k0, it = 0; t0 < k1; t0 += kt, ++it) {
      cp_async_wait<0>();
      // tile `it` is in, and every warp is done with tile it - 1, whose
      // stage the next copy fills
      __syncthreads();
      issue(it + 1);
      const T* ks = stage + (it & 1) * 2 * kt * Dh;
      const T* vs = ks + kt * Dh;
      const int nk = min(kt, k1 - t0);
      for (int i0 = 0; i0 * NKG < nk; i0 += KSUB) {
        if (i0 * NKG + kw * KPW >= nk) break;   // none of this warp's
        float s[RMAX][KSUB];
        float kv[KSUB][DPL];
        // keys past the tile read its last key (finite) and score -inf
#pragma unroll
        for (int kk = 0; kk < KSUB; ++kk)
          load_n<DPL>(ks + min(kg + NKG * (i0 + kk), nk - 1) * Dh + col,
                      kv[kk]);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          const int row = rbase + r;
          if (row >= R) break;
#pragma unroll
          for (int kk = 0; kk < KSUB; ++kk) {
            // four independent partial sums: a short dependency chain
            float p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int d = 0; d < DPL; ++d)
              p4[d % 4] = fmaf(qr[r][d], kv[kk][d], p4[d % 4]);
            float part = (p4[0] + p4[1]) + (p4[2] + p4[3]);
#pragma unroll
            for (int o = LPK / 2; o > 0; o >>= 1)
              part += __shfl_xor_sync(kFull, part, o);
            const int idx = kg + NKG * (i0 + kk), kpos = t0 + idx;
            s[r][kk] = idx >= nk ? -INFINITY
                       : kpos >= kmin[r]
                           ? score<SOFTCAP>(part, a.scale, a.softcap)
                           : -1e30f;
          }
        }
#pragma unroll
        for (int kk = 0; kk < KSUB; ++kk)
          load_n<DPL>(vs + min(kg + NKG * (i0 + kk), nk - 1) * Dh + col,
                      kv[kk]);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (rbase + r >= R) break;
          float mx = m[r];
#pragma unroll
          for (int kk = 0; kk < KSUB; ++kk) mx = fmaxf(mx, s[r][kk]);
          if (mx == -INFINITY) continue;     // no key of this group
          if (mx > m[r]) {                   // rescale only as m grows
            const float corr = exp2f(m[r] - mx);
            l[r] *= corr;
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[r][d] *= corr;
            m[r] = mx;
          }
#pragma unroll
          for (int kk = 0; kk < KSUB; ++kk) {
            const float p = exp2f(s[r][kk] - mx);
            l[r] += p;
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[r][d] = fmaf(p, kv[kk][d],
                                                           acc[r][d]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring becomes the warps' states
  } else if (finalizer) {
    write_pages(a, reinterpret_cast<int*>(nk + 2 * a.T * DP), b, pos);
  }

  // key groups of a warp: shuffle butterfly (every lane ends identical)
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (rbase + r >= R) break;
      const float mo = __shfl_xor_sync(kFull, m[r], o);
      const float lo = __shfl_xor_sync(kFull, l[r], o);
      float ao[DPL];
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        ao[d] = __shfl_xor_sync(kFull, acc[r][d], o);
      merge_n<DPL>(m[r], l[r], acc[r], mo, lo, ao);
    }
  }
  // the warps of a row group, in warp order, into st
  {
    float* w = wst + warp * RMAX * (DP + 2);
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (rbase + r >= R) break;
      if (sub == 0) {
#pragma unroll
        for (int d = 0; d < DPL; ++d)
          w[r * (DP + 2) + lk * DPL + d] = acc[r][d];
      }
      if (lane == 0) {
        w[r * (DP + 2) + DP] = m[r];
        w[r * (DP + 2) + DP + 1] = l[r];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < R * DP; e += blockDim.x) {
    const int row = e / DP, d = e % DP;
    const int g0 = row / RMAX, r = row % RMAX;
    float M = -INFINITY, L = 0.f, A = 0.f;
    for (int w = 0; w < kKeyWarps; ++w) {
      const float* ws = wst + ((g0 * kKeyWarps + w) * RMAX + r) * (DP + 2);
      merge1(M, L, A, ws[DP], ws[DP + 1], ws[d]);
    }
    st[row * (DP + 2) + d] = A;
    if (d == 0) {
      st[row * (DP + 2) + DP] = M;
      st[row * (DP + 2) + DP + 1] = L;
    }
  }
  __syncthreads();

  if (a.route == kTwoPass) {
    float* out = a.ws + ((((long long)b * a.Hkv + h) * a.splits + split) *
                             Rall + R0) * (Dh + 2);
    for (int e = tid; e < R * (Dh + 2); e += blockDim.x) {
      const int row = e / (Dh + 2), c = e % (Dh + 2);
      out[e] = st[row * (DP + 2) + (c < Dh ? c : DP + c - Dh)];
    }
    return;
  }
  const float* fin = st;
  if (a.route == kCluster) {
    cluster_sync();   // every split's state is in its shared memory
    float* merged = wst;
    if (split == 0) {
      auto live = [&](int s) {
        int s0, s1;
        split_keys(s, a.pps, a.bs, pos, virt, a.window, s0, s1);
        return s0 < s1;
      };
      for (int e = tid; e < R * DP; e += blockDim.x) {
        const int row = e / DP, d = e % DP;
        float M, L, A;
        merge_splits(a.splits, d < Dh ? d : -1, DP,
                     [&](int s) { return map_rank(st, s) + row * (DP + 2); },
                     live, M, L, A);
        merged[row * (DP + 2) + d] = A;
        if (d == 0) {
          merged[row * (DP + 2) + DP] = M;
          merged[row * (DP + 2) + DP + 1] = L;
        }
      }
    }
    cluster_sync();   // rank 0 has read every state; the others may exit
    if (split != 0) return;
    fin = merged;
  }
  finalize<T>(a, fin, qs, nk, DP, b, h, pos, R0, R);
}

// The second pass where the splits outnumber a cluster: merge each
// (slot, head, row block)'s split states from the workspace in split
// order, then the same last step.
template <typename T>
__global__ void __launch_bounds__(128)
paged_combine(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Rall = (a.Hq / a.Hkv) * a.T, Dh = a.Dh;
  const int nrb = row_blocks(Rall), RB = block_rows(Rall);
  const int h = blockIdx.x / nrb, b = blockIdx.y;
  const int R0 = blockIdx.x % nrb * RB, R = min(RB, Rall - R0);
  const int dp = dims_per_lane(RB) * lanes_per_key(Dh, dims_per_lane(RB));
  float* qs = reinterpret_cast<float*>(smem);
  float* st = qs + RB * dp;
  float* nk = st + RB * (dp + 2);
  // the prologue overlaps the split kernel; its states are read after it
  const int pos = a.position[b], virt = a.MB * a.bs;
  load_q<T>(a, qs, RB, dp, b, h, R0, R);
  load_new<T>(a, nk, dp, b, h);
  write_pages(a, reinterpret_cast<int*>(nk + 2 * a.T * dp), b, pos);
  wait_primary();
  const float* ws =
      a.ws + ((long long)b * a.Hkv + h) * a.splits * Rall * (Dh + 2);
  auto live = [&](int s) {
    int s0, s1;
    split_keys(s, a.pps, a.bs, pos, virt, a.window, s0, s1);
    return s0 < s1;
  };
  for (int e = threadIdx.x; e < R * dp; e += blockDim.x) {
    const int row = e / dp, d = e % dp;
    float M, L, A;
    merge_splits(a.splits, d < Dh ? d : -1, Dh,
                 [&](int s) {
                   return ws + ((long long)s * Rall + R0 + row) * (Dh + 2);
                 },
                 live, M, L, A);
    st[row * (dp + 2) + d] = A;
    if (d == 0) {
      st[row * (dp + 2) + dp] = M;
      st[row * (dp + 2) + dp + 1] = L;
    }
  }
  __syncthreads();
  finalize<T>(a, st, qs, nk, dp, b, h, pos, R0, R);
}

template <typename Kern>
cudaError_t prepare(Kern kern) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T, int LPK, int RMAX, bool SOFTCAP>
cudaError_t launch_split(const Args& a, int threads, int smem,
                         cudaStream_t stream) {
  auto kern = paged_split<T, LPK, RMAX, SOFTCAP>;
  static const cudaError_t prepared = prepare(kern);
  if (prepared != cudaSuccess) return prepared;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(a.splits, a.Hkv * row_blocks((a.Hq / a.Hkv) * a.T), a.B);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (a.route == kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, kern, a);
}

// the instances: 16 dims a lane at rows <= 2 (LPK 1 - 8), 8 above (2 - 16)
template <typename T, int RMAX, bool SOFTCAP>
cudaError_t by_lanes(const Args& a, int threads, int smem, cudaStream_t s) {
  constexpr int DPL = RMAX <= 2 ? 16 : 8;
  switch (lanes_per_key(a.Dh, DPL)) {
    case DPL == 16 ? 1 : 16:
      return launch_split<T, DPL == 16 ? 1 : 16, RMAX, SOFTCAP>(a, threads,
                                                                smem, s);
    case 2: return launch_split<T, 2, RMAX, SOFTCAP>(a, threads, smem, s);
    case 4: return launch_split<T, 4, RMAX, SOFTCAP>(a, threads, smem, s);
    case 8: return launch_split<T, 8, RMAX, SOFTCAP>(a, threads, smem, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool SOFTCAP>
cudaError_t by_rows(const Args& a, int R, int threads, int smem,
                    cudaStream_t s) {
  return rows_max(R) == 2 ? by_lanes<T, 2, SOFTCAP>(a, threads, smem, s)
                          : by_lanes<T, 4, SOFTCAP>(a, threads, smem, s);
}

template <typename T>
cudaError_t run(const Args& a, int smem, cudaStream_t s) {
  const int R = (a.Hq / a.Hkv) * a.T, RB = block_rows(R);
  const Layout lay(RB, a.T, a.Dh, (int)sizeof(T), a.kt, a.pps);
  if (smem != lay.bytes || smem > kSmemLimit) return cudaErrorInvalidValue;
  const int threads = 32 * kKeyWarps * lay.rg;
  cudaError_t err = a.softcap > 0.f
                        ? by_rows<T, true>(a, RB, threads, smem, s)
                        : by_rows<T, false>(a, RB, threads, smem, s);
  if (err != cudaSuccess || a.route != kTwoPass) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static const cudaError_t prepared = prepare(paged_combine<T>);
  if (prepared != cudaSuccess) return prepared;
  const int dp = lay.dp;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(a.Hkv * row_blocks(R), a.B, 1);
  cfg.blockDim = dim3(128, 1, 1);
  cfg.dynamicSmemBytes = (RB * dp + RB * (dp + 2)) * 4 + new_bytes(a.T, dp);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_combine<T>, a);
}

}  // namespace

// Shared memory of a split CTA for (slot, head)s of `rows` query rows
// (the plan's `smem_bytes` of their row block; -1 for a shape the kernel
// refuses).
extern "C" int paged_attn_smem_bytes(int rows, int T, int Dh, int item,
                                     int kt, int pps) {
  if (rows < 1 || T < 1 || T > kMaxT || rows % T) return -1;
  return Layout(block_rows(rows), T, Dh, item, kt, pps).bytes;
}

// q (B, T, Hq, Dh); knew, vnew (B, T, Hkv, Dh); pools kp, vp
// (n_pages, bs, Hkv, Dh) updated in place, page n_pages-1 the trash page,
// 16-byte aligned; tables (B, MB) int32 (-1 unmapped); position (B,)
// int32; out (B, T, Hq, Dh).  One dtype for all of q/knew/vnew/pools/out
// (fp32 or bf16).  Needs Dh a multiple of 16 in [16, 128] and T <= 32
// (any group: (Hq / Hkv) * T rows in blocks of 16).  The plan: `splits`
// CTAs a (slot, head, row block) of `pps`
// pages each (every split holding at least one page), `kt` keys a tile,
// `route` 0 (one split), 1 (a cluster of the splits) or 2 (the workspace
// ws, (B, Hkv, splits, rows, Dh + 2) fp32, and a second kernel), `smem`
// a split CTA's shared memory (laid out for min(rows, 16) rows); anything
// else is refused
// (cudaErrorInvalidValue).  Launches on `stream`, allocates nothing,
// returns the first CUDA error.
extern "C" int paged_attn_launch(const void* q, const void* knew,
                                 const void* vnew, void* kp, void* vp,
                                 const void* tables, const void* position,
                                 void* out, void* ws, int B, int Tn, int Hq,
                                 int Hkv, int Dh, int n_pages, int bs, int MB,
                                 int window, float softcap, float scale,
                                 int is_bf16, int splits, int pps, int kt,
                                 int route, int smem, void* stream) {
  const Args a{q, knew, vnew, kp, vp, static_cast<const int*>(tables),
               static_cast<const int*>(position), out,
               static_cast<float*>(ws), B, Tn, Hq, Hkv, Dh, n_pages, bs, MB,
               window, softcap, scale, splits, pps, kt, route};
  const bool ok =
      Hkv >= 1 && Hq % Hkv == 0 && Tn >= 1 && Tn <= kMaxT &&
      Dh % 16 == 0 && Dh >= 16 && Dh <= 128 &&
      bs >= 1 && MB >= 1 && splits >= 1 && pps >= 1 &&
      (long long)(splits - 1) * pps < MB && (long long)splits * pps >= MB &&
      kt >= 16 && kt % 16 == 0 &&
      ((route == kSingle && splits == 1) ||
       (route == kCluster && splits >= 2 && splits <= kMaxCluster) ||
       (route == kTwoPass && ws != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (B > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    err = is_bf16 ? run<__nv_bfloat16>(a, smem, s) : run<float>(a, smem, s);
  }
  cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
