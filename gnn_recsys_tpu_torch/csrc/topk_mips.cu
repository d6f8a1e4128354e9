// Full-catalog maximum-inner-product search for Hopper (sm_90a): one
// score-tile kernel, topk_kernel<T, SHARED_LIST, EPI>, with three epilogues;
// and mlp_topk_kernel, which ranks by the MLP head instead of a dot product
// with the same top-k lists (its own note, further down).
//
// Replaces the three Pallas kernels of gnn_recsys_tpu/ops/pallas/topk_mips.py:
//   * mips_topk           (_mips_kernel,  topk_mips.py:52)  -> EPI_TOPK
//   * mips_topk_boosted   pass 1 (_lse_kernel,   :108)     -> EPI_LSE
//   * mips_topk_boosted   pass 2 (_boost_kernel, :141)     -> EPI_BOOST
//
// What bounds them.  Ranking U users against I items at width D is 2*U*I*D
// floating-point operations (7.7e11 at the serving shape U=100k, I=30k,
// D=128) and only O(U*D + I*D + U*k) bytes, so the kernels are bound by f32
// FMA throughput (67 TFLOP/s on an H100 SXM), not by memory.  The scores
// are f32 FMAs on the CUDA cores: no TF32 and no tensor cores, because a
// truncated product reorders near-tied catalog rankings (the TPU kernel pins
// Precision.HIGHEST for the same reason).  bf16 inputs are widened to f32
// as they are read, and accumulate in f32.  Widths are a multiple of 4 (the
// wrappers zero-pad), the kernels' copy and load granule.
//
// The score tile, shared by the three epilogues.  A block of 256 threads
// owns BU=128 users and one contiguous range of the catalog, walked in tiles
// of BI=128 items; a thread holds an 8 x 8 register tile of scores, users
// ty + 16p and items tx + 16q, so that a warp's fragment reads fall on
// distinct banks.  The catalog streams through a ring of STAGES shared-memory
// stages of BK=32 dims, copied with cp.async in its own row-major layout (4
// dims of one row a copy: 16 bytes in f32, 8 in bf16; zero-filled past the
// range and past D) while earlier stages are multiplied, one barrier a stage.
// Fragments are read 4 dims of one row at a time, so nothing is transposed;
// bf16 stays bf16 in shared memory and is widened when it is read.  The
// block's users are copied once for the whole walk where shared memory holds
// them (66 KB in f32 at D=128); otherwise they go through the ring beside
// the items.  Each epilogue runs after a tile's last chunk, on the registers.
//
// EPI_TOPK.  A thread compares its 64 scores with its users' current k-th
// values and sends only those that reach them to the user's buffer in shared
// memory (the 16 lanes of a half-warp share a user: a prefix sum of their
// counts and one shared atomic place them).  The buffer holds BUF=64
// entries.  Offers only append, so a tile costs one barrier; when a buffer
// fills, its warp sorts it (a bitonic network over 64 entries, two a lane, in
// registers).  For k <= 32 the buffer holds the user's list, then the
// candidates offered since, and the sort keeps the k best, which also raises
// the user's k-th value.  Every candidate that reaches a k-th value needs an
// insert in a list kept in order, one at a time a user; a buffer needs one
// sort for every 32 or more of them.  For k > 32 the list lives in the
// block's row of the partial lists in device memory: the sorted buffer is
// merged into it in one pass (each entry's new place from a count of the
// other side's entries before it, merge_chunk) and empties.  A list is the
// first k entries of the order (value descending, index ascending), that of
// a stable descending sort (the lowest-index tie rule of _extract_topk);
// columns >= num_items never enter.
//
// EPI_BOOST.  The same top-k on exp(score - m[u]) / s[u] + weight * pop[i],
// m and s from pass 1.  A thread turns its 64 accumulators into those values
// in place (m and s of its 8 users from per-user arrays in shared memory,
// loaded once a block; pop of its 8 items from device memory, where the
// vector stays in L2), so the filter, offers and sorts run unchanged and the
// FMA loop keeps its registers.  The exponential is __expf and the division
// __fdividef (2 ulps each where the exponent is small, against expf and the
// true division of the plain version; a value's absolute error stays below
// 1e-6, within the checks' 1e-5); weight * pop[i] is rounded once and
// added with __fadd_rn, as the plain version adds it, so nvcc contracts
// nothing.  Items with equal scores and popularity get the same bits, so
// ties still go to the lowest index.
//
// EPI_LSE.  A thread keeps a running max m and sum-exp s in registers for
// each of its 8 users over its own items.  It folds in a tile's valid scores
// (the max of its 8 scores a user, a rescale by exp(m_old - m_new) only where
// the max grew, then one __expf a score: the sum's relative error stays near
// 1e-6, within the checks' 1e-5 on the log-sum-exp scale), with no shared
// memory and no barrier.  At the end the 16 lanes of a half-warp, which
// share a user, combine their pairs by shuffles.  A thread with no valid item
// (the last partial tile, a catalog of fewer than 16 items) keeps (-inf, 0),
// and no path evaluates exp(-inf - (-inf)).  The layout holds no per-user
// buffers.
//
// Catalog splits.  When there are too few user blocks to fill the card (a
// request of a few thousand users is 32 blocks on 132 SMs), the catalog is
// split into S contiguous ranges, one block column each; each block writes
// its partial list (or its partial max and sum-exp) and a second small
// kernel merges the S partials per user (merge_kernel under the list order,
// which stays exact; lse_combine_kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MIN_SPLIT_TILES = 4; // catalog tiles per split, at least
constexpr int MERGE_WARPS = 4;     // users per block of the merge kernel

// topk_kernel's epilogues
constexpr int EPI_TOPK = 0;   // top-k of the scores
constexpr int EPI_BOOST = 1;  // top-k of exp(score - m) / s + weight * pop
constexpr int EPI_LSE = 2;    // max and sum-exp of the scores

// topk_kernel
namespace tk {
constexpr int BU = 128;            // users per block
constexpr int BI = 128;            // catalog items per tile
constexpr int BK = 32;             // embedding dims per ring stage
constexpr int TY = BU / 8;         // thread rows: users ty + TY * p
constexpr int THREADS = 16 * TY;   // 16 x TY threads, 8 x 8 scores each
constexpr int NWARPS = THREADS / 32;
constexpr int STAGES = 3;          // ring stages in flight
constexpr int BUF = 64;            // a user's buffer: its list, then new candidates
constexpr int SHARED_K = 32;       // largest k whose lists live in the buffer
constexpr int LDK = BK + 4;        // elements a staged row: an odd count of 4-element groups
constexpr int MAX_K = 1024;        // the merge kernel holds 4 lists of k in shared memory
}  // namespace tk

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Whether (v, i) comes before (pv, pi): value descending, index ascending.
__device__ __forceinline__ bool before(float v, int i, float pv, int pi) {
  return v > pv || (v == pv && i < pi);
}

// Merge 32 * H candidates, entry e = lane + 32h, sorted in list order
// across the warp with the nc real ones first, into a running top-k (lv, li;
// n entries, n uniform across the warp) in shared or device memory, keeping
// the first k of the merged order.  List entry j moves to j plus the number
// of candidates before it (a binary search over the candidates by shuffles),
// candidate e to e plus the number of list entries before it (the entries
// whose count is at most e).  List chunks move from the last one down, so no
// entry is overwritten before it is read; the candidates land last, in the
// slots left free.  Called by a whole warp; returns the new n.
template <int H>
__device__ __forceinline__ int merge_chunk(float* lv, int* li, int n, int k,
                                           const float (&cv)[H], const int (&ci)[H], int nc,
                                           int lane) {
  if (nc == 0) return n;
  if (n == k) {  // nothing enters unless the best candidate beats the k-th
    const float bv = __shfl_sync(FULL, cv[0], 0);
    const int bi = __shfl_sync(FULL, ci[0], 0);
    if (!before(bv, bi, lv[k - 1], li[k - 1])) return n;
  }
  int ahead[H];  // list entries before candidate lane + 32h
#pragma unroll
  for (int h = 0; h < H; ++h) ahead[h] = 0;
  for (int base = (n + 31) / 32 * 32 - 32; base >= 0; base -= 32) {
    const int j = base + lane;
    const bool in = j < n;
    const float xv = in ? lv[j] : 0.f;
    const int xi = in ? li[j] : 0;
    // Candidates before entry j: the longest prefix of them that comes first.
    int b = 0;
#pragma unroll
    for (int step = 32 * H; step > 0; step >>= 1) {
      const int probe = b + step - 1;
      const int src = probe & 31;
      float pv = __shfl_sync(FULL, cv[0], src);
      int pi = __shfl_sync(FULL, ci[0], src);
#pragma unroll
      for (int h = 1; h < H; ++h) {
        const float hv = __shfl_sync(FULL, cv[h], src);
        const int hi = __shfl_sync(FULL, ci[h], src);
        if (probe >> 5 == h) {
          pv = hv;
          pi = hi;
        }
      }
      if (probe < nc && before(pv, pi, xv, xi)) b += step;
    }
    if (!in) b = INT_MAX;  // before no candidate
    // Entries of this chunk before each candidate: the lanes whose count is
    // at most e (the counts rise along the lanes).
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int e = lane + 32 * h;
      int c = 0;
#pragma unroll
      for (int step = 32; step > 0; step >>= 1) {
        const int probe = c + step - 1;
        const int pb = __shfl_sync(FULL, b, probe & 31);
        if (probe < 32 && pb <= e) c += step;
      }
      ahead[h] += c;
    }
    __syncwarp();  // the chunk is read
    if (in && j + b < k) {
      lv[j + b] = xv;
      li[j + b] = xi;
    }
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int e = lane + 32 * h;
    if (e < nc && e + ahead[h] < k) {
      lv[e + ahead[h]] = cv[h];
      li[e + ahead[h]] = ci[h];
    }
  }
  __syncwarp();
  return min(n + nc, k);
}

// The same merge for k <= 32, with the list in registers: lane p holds
// entry p (lv, li), so an insertion is one ballot and one shuffle.
__device__ __forceinline__ int merge_chunk_reg(float& lv, int& li, int n, int k,
                                               float v, int idx, bool valid, int lane) {
  const float kv0 = __shfl_sync(FULL, lv, k - 1);  // all lanes shuffle
  const int ki0 = __shfl_sync(FULL, li, k - 1);
  const bool pass = valid && (n < k || before(v, idx, kv0, ki0));
  unsigned mask = __ballot_sync(FULL, pass);
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cv = __shfl_sync(FULL, v, src);
    const int ci = __shfl_sync(FULL, idx, src);
    const float kv = __shfl_sync(FULL, lv, k - 1);
    const int ki = __shfl_sync(FULL, li, k - 1);
    if (n == k && !before(cv, ci, kv, ki)) continue;
    const int pos = __popc(__ballot_sync(FULL, lane < n && before(lv, li, cv, ci)));
    const float up_v = __shfl_up_sync(FULL, lv, 1);
    const int up_i = __shfl_up_sync(FULL, li, 1);
    if (lane == pos) {
      lv = cv;
      li = ci;
    } else if (lane > pos) {
      lv = up_v;
      li = up_i;
    }
    n = min(n + 1, k);
  }
  return n;
}

// Sort 64 (value, index) pairs held two a lane (entry lane and lane + 32)
// into the list order (value descending, index ascending): a bitonic
// network of 21 compare-exchange steps.  Called by a whole warp.
__device__ __forceinline__ void sort64(float (&v)[2], int (&id)[2], int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // the pair (lane, lane + 32) lies in one lane
        if (before(v[1], id[1], v[0], id[0])) {
          const float tv = v[0];
          const int ti = id[0];
          v[0] = v[1];
          id[0] = id[1];
          v[1] = tv;
          id[1] = ti;
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = lane + 32 * h;
        const float pv = __shfl_xor_sync(FULL, v[h], stride);
        const int pi = __shfl_xor_sync(FULL, id[h], stride);
        // The lower entry of a pair takes the one that comes first where
        // its block of `size` runs in list order, the later one elsewhere.
        const bool first = ((e & stride) == 0) == ((e & size) == 0);
        if (first ? before(pv, pi, v[h], id[h]) : before(v[h], id[h], pv, pi)) {
          v[h] = pv;
          id[h] = pi;
        }
      }
    }
  }
}

// A user's buffer of n (<= BUF) entries, bv / bi, loaded two a lane and
// sorted in list order (empty slots last).  Called by a whole warp.
__device__ __forceinline__ void sorted_buffer(const float* bv, const int* bi, int n,
                                              float (&v)[2], int (&id)[2], int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = lane + 32 * h;
    v[h] = e < n ? bv[e] : -INFINITY;
    id[h] = e < n ? bi[e] : INT_MAX;
  }
  sort64(v, id, lane);
}

// Sort a user's full buffer (n entries) and raise the user's k-th value
// *thr.  SHARED_LIST: the buffer keeps its k best (*ccnt of them); else the
// sorted entries merge into the user's list in device memory (lv, li; *cnt
// entries) and the buffer empties.  Called by a whole warp; lane 0 writes
// the counters.
template <bool SHARED_LIST>
__device__ __forceinline__ void flush_buffer(float* bv, int* bi, int n, int k, int* ccnt,
                                             float* thr, int* cnt, float* lv, int* li,
                                             int lane) {
  float v[2];
  int id[2];
  sorted_buffer(bv, bi, n, v, id, lane);
  if constexpr (SHARED_LIST) {
    const int kept = min(n, k);
    if (lane < kept) {
      bv[lane] = v[0];
      bi[lane] = id[0];
    }
    const float kth = __shfl_sync(FULL, v[0], k - 1);
    if (lane == 0) {
      *ccnt = kept;
      *thr = kept == k ? kth : -INFINITY;
    }
  } else {
    const int kept = merge_chunk<2>(lv, li, *cnt, k, v, id, n, lane);
    if (lane == 0) {
      *cnt = kept;
      *ccnt = 0;
      *thr = kept == k ? lv[k - 1] : -INFINITY;
    }
  }
}

// Write a user's top-k list to its row of the partial lists (lv, li) from
// the buffer's n entries: SHARED_LIST, the buffer's k best (-inf, -1 past
// them); else the buffer merged into the cnt entries already there, the
// tail past the list empty.  Called by a whole warp.
template <bool SHARED_LIST>
__device__ __forceinline__ void finish_list(const float* bv, const int* bi, int n, int k,
                                            int cnt, float* lv, int* li, int lane) {
  float v[2];
  int id[2];
  sorted_buffer(bv, bi, n, v, id, lane);
  if constexpr (SHARED_LIST) {  // the buffer's k best, in list order
    if (lane < k) {
      lv[lane] = lane < n ? v[0] : -INFINITY;
      li[lane] = lane < n ? id[0] : -1;
    }
  } else {  // the buffer's rest merged into the list; the tail past it empty
    const int kept = merge_chunk<2>(lv, li, cnt, k, v, id, n, lane);
    for (int p = kept + lane; p < k; p += 32) {
      lv[p] = -INFINITY;
      li[p] = -1;
    }
  }
}

// ----------------------------------------------------------------------
// topk_kernel
// ----------------------------------------------------------------------

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One cp.async of BYTES (16: f32, 8: bf16), zero-filled when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(BYTES), "r"(n));
}

// Copy rows [row0, row0 + nrows) x dims [d0, d0 + ncols) of a row-major
// [*, D] matrix into dst[r * ld + c], 4 elements a copy, zero-filled at rows
// >= row_end and dims >= D.
// NCOLS: ncols known at compile time (0: read ncols).
template <int NCOLS, typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* __restrict__ src, int row0,
                                          int nrows, int row_end, int d0, int ncols, int D) {
  const int groups = (NCOLS ? NCOLS : ncols) / 4;
  for (int g = threadIdx.x; g < nrows * groups; g += tk::THREADS) {
    const int r = g / groups;
    const int c = (g - r * groups) * 4;
    const bool ok = row0 + r < row_end && d0 + c < D;
    cp_async<4 * sizeof(T)>(dst + r * ld + c, ok ? src + (size_t)(row0 + r) * D + d0 + c : src,
                            ok);
  }
}

// Elements a row of the resident user block: D rounded up to BK, then to an
// odd count of 4-element groups, so that neighbouring users' fragment reads
// fall on distinct banks.
__host__ __device__ inline int tk_user_stride(int D) {
  const int padded = (D + tk::BK - 1) / tk::BK * tk::BK;
  return 4 * ((padded / 4) | 1);
}

// Shared-memory bytes: a ring stage, the resident users, and the whole block
// (ring, users and, for the top-k epilogues, the per-user buffers and three
// per-user counters, with EPI_BOOST also the users' m and s).
struct TkLayout {
  int stage;
  int users;
  int total;
};

__host__ __device__ inline TkLayout tk_layout(int D, int esize, int resident, int epi) {
  TkLayout L;
  L.stage = (tk::BI + (resident ? 0 : tk::BU)) * tk::LDK * esize;
  L.users = resident ? tk::BU * tk_user_stride(D) * esize : 0;
  L.total = tk::STAGES * L.stage + L.users;
  if (epi != EPI_LSE) L.total += tk::BU * tk::BUF * 8 + (epi == EPI_BOOST ? 5 : 3) * tk::BU * 4;
  return L;
}

// EPI_LSE: fold a tile's scores into a thread's running max m and sum-exp s
// of each of its 8 users; item q is valid where 16 * q < nvalid.  Without a
// valid item a thread keeps (-inf, 0) and evaluates no exp.
__device__ __forceinline__ void lse_fold(const float (&acc)[8][8], float (&m)[8], float (&s)[8],
                                         int nvalid) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    float tmax = -INFINITY;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (16 * q < nvalid) tmax = fmaxf(tmax, acc[p][q]);
    if (tmax > m[p]) {  // the max grew: rescale the sum (0 while m is -inf)
      s[p] *= expf(m[p] - tmax);
      m[p] = tmax;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (16 * q < nvalid) s[p] += __expf(acc[p][q] - m[p]);
  }
}

// EPI_BOOST: turn a thread's scores into exp(score - m) / s + weight * pop in
// place, m and s of its users ty + TY * p (row_m[TY * p], row_s[TY * p]),
// pop of its items tx + 16 q (pop[16 * q], read where 16 * q < nvalid).
__device__ __forceinline__ void boost_scores(float (&acc)[8][8], const float* row_m,
                                             const float* row_s, const float* __restrict__ pop,
                                             float weight, int nvalid) {
  float wp[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) wp[q] = 16 * q < nvalid ? weight * __ldg(pop + 16 * q) : 0.f;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const float m = row_m[tk::TY * p], s = row_s[tk::TY * p];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      acc[p][q] = __fadd_rn(__fdividef(__expf(acc[p][q] - m), s), wp[q]);
  }
}

// Scores users [u0, u0 + BU) against catalog range [i_begin, i_end).  The
// top-k epilogues write the range's top-k per user to part_vals / part_idx
// [split][user][k] (idx -1 past the range's item count), EPI_BOOST on the
// boosted values of pop, weight and pass 1's m_in, s_in; EPI_LSE writes the
// range's max and sum-exp to part_vals / part_sums [split][user].
// SHARED_LIST (top-k epilogues): k <= SHARED_K.
template <typename T, bool SHARED_LIST, int EPI>
__global__ void __launch_bounds__(tk::THREADS, 1)
topk_kernel(const T* __restrict__ users, const T* __restrict__ items, int num_users,
            int num_items, int D, int k, int split_items, int resident,
            const float* __restrict__ pop, float weight, const float* __restrict__ m_in,
            const float* __restrict__ s_in, float* __restrict__ part_vals,
            int* __restrict__ part_idx, float* __restrict__ part_sums) {
  constexpr int BU = tk::BU, BI = tk::BI, BK = tk::BK, TY = tk::TY, THREADS = tk::THREADS;
  constexpr int NWARPS = tk::NWARPS, STAGES = tk::STAGES, LDK = tk::LDK;
  constexpr int BUF = tk::BUF;
  extern __shared__ __align__(16) unsigned char tsmem[];
  const TkLayout L = tk_layout(D, sizeof(T), resident, EPI);
  T* ring = reinterpret_cast<T*>(tsmem);
  const int stage_elems = L.stage / static_cast<int>(sizeof(T));
  T* us = reinterpret_cast<T*>(tsmem + STAGES * L.stage);          // [BU][ldu], resident
  // A user's buffer: with SHARED_LIST its list (the first cnt entries,
  // sorted) and then the candidates offered since (ccnt entries in all);
  // else the candidates offered since the last merge.
  float* buf_v = reinterpret_cast<float*>(tsmem + STAGES * L.stage + L.users);  // [BU][BUF]
  int* buf_i = reinterpret_cast<int*>(buf_v + BU * BUF);          // [BU][BUF]
  int* ccnt = buf_i + BU * BUF;                                   // [BU] entries offered
  float* thr = reinterpret_cast<float*>(ccnt + BU);               // [BU] k-th value, -inf until k
  int* cnt = reinterpret_cast<int*>(thr + BU);                    // [BU] list entries
  float* row_m = reinterpret_cast<float*>(cnt + BU);              // [BU] EPI_BOOST: m
  float* row_s = row_m + BU;                                      // [BU] EPI_BOOST: s

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;  // items tx + 16q of a tile
  const int ty = tid >> 4;  // users ty + TY * p of the block
  const int u0 = blockIdx.x * BU;
  const int split = blockIdx.y;
  const int i_begin = split * split_items;
  const int i_end = min(num_items, i_begin + split_items);
  const int nchunks = (D + BK - 1) / BK;
  const int total = (i_end - i_begin + BI - 1) / BI * nchunks;  // ring stages of the walk
  const int ldu = resident ? tk_user_stride(D) : LDK;

  if constexpr (EPI != EPI_LSE) {
    for (int r = tid; r < BU; r += THREADS) {
      ccnt[r] = 0;
      cnt[r] = 0;
      thr[r] = -INFINITY;
      if constexpr (EPI == EPI_BOOST) {  // rows past the users are never offered
        row_m[r] = u0 + r < num_users ? m_in[u0 + r] : 0.f;
        row_s[r] = u0 + r < num_users ? s_in[u0 + r] : 1.f;
      }
    }
  }
  if (resident) copy_rows<0>(us, ldu, users, u0, BU, num_users, 0, nchunks * BK, D);
  // Stage s holds tile s / nchunks, dims (s % nchunks) * BK onward; a
  // commit group a stage (empty past the walk), the users in the first.
  auto issue = [&](int s) {
    if (s < total) {
      T* st = ring + (s % STAGES) * stage_elems;
      const int d0 = (s % nchunks) * BK;
      copy_rows<BK>(st, LDK, items, i_begin + (s / nchunks) * BI, BI, i_end, d0, BK, D);
      if (!resident) copy_rows<BK>(st + BI * LDK, LDK, users, u0, BU, num_users, d0, BK, D);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  float acc[8][8];
  float run_m[8], run_s[8];  // EPI_LSE: users ty + TY * p over this thread's items
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    run_m[p] = -INFINITY;
    run_s[p] = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  }
#pragma unroll 1
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s is in; every thread is done with stage s - 1
    issue(s + STAGES - 1);
    const int c = s % nchunks;
    const T* bs = ring + (s % STAGES) * stage_elems + tx * LDK;
    const T* as = (resident ? us + c * BK : ring + (s % STAGES) * stage_elems + BI * LDK) +
                  ty * ldu;
    const int astep = TY * ldu;
#pragma unroll
    for (int g = 0; g < BK / 4; ++g) {
      float4 a[8], b[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) a[p] = load4(as + p * astep + 4 * g);
#pragma unroll
      for (int q = 0; q < 8; ++q) b[q] = load4(bs + q * 16 * LDK + 4 * g);
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p].x, b[q].x, acc[p][q]);
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p].y, b[q].y, acc[p][q]);
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p].z, b[q].z, acc[p][q]);
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p].w, b[q].w, acc[p][q]);
    }
    if (c != nchunks - 1) continue;

    const int i0 = i_begin + (s / nchunks) * BI;
    if constexpr (EPI == EPI_LSE) {
      lse_fold(acc, run_m, run_s, i_end - i0 - tx);
    } else {
      if constexpr (EPI == EPI_BOOST)
        boost_scores(acc, row_m + ty, row_s + ty, pop + i0 + tx, weight, i_end - i0 - tx);
      // Epilogue: scores that reach their user's k-th value, bit 8p + q.
      unsigned long long pend = 0ull;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const float t = thr[ty + TY * p];
        const bool uok = u0 + ty + TY * p < num_users;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (uok && i0 + tx + 16 * q < i_end && acc[p][q] >= t) pend |= 1ull << (8 * p + q);
      }
      while (true) {
        // Offer: the 16 lanes of a half-warp hold the tile's scores of users
        // ty + TY * p.  Their counts, a byte a user, take one prefix sum over
        // the half-warp (sums stay under 256), and its first lane reserves
        // each user's slots with one atomic (a user's count before an offer is
        // at most BUF, so a byte holds every start position too).
        const unsigned long long offer_bits = pend;
        if (__any_sync(FULL, pend != 0ull)) {
          unsigned long long mine = 0ull;
#pragma unroll
          for (int p = 0; p < 8; ++p)
            mine |= static_cast<unsigned long long>(
                        __popc(static_cast<unsigned>(pend >> (8 * p)) & 0xffu)) << (8 * p);
          unsigned long long incl = mine;
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) {
            const unsigned long long y = __shfl_up_sync(FULL, incl, off, 16);
            if ((lane & 15) >= off) incl += y;
          }
          const unsigned long long offers = __shfl_sync(FULL, incl, 15, 16);
          unsigned long long base = 0ull;
          if ((lane & 15) == 0) {
#pragma unroll
            for (int p = 0; p < 8; ++p) {
              const int n = static_cast<int>(offers >> (8 * p)) & 0xff;
              if (n)
                base |= static_cast<unsigned long long>(atomicAdd(&ccnt[ty + TY * p], n))
                        << (8 * p);
            }
          }
          base = __shfl_sync(FULL, base, 0, 16) + (incl - mine);  // bytewise: no carries
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const int r = ty + TY * p;
            int pos = static_cast<int>(base >> (8 * p)) & 0xff;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              if (!((offer_bits >> (8 * p + q)) & 1ull)) continue;
              if (pos < BUF) {  // else it stays pending
                buf_v[r * BUF + pos] = acc[p][q];
                buf_i[r * BUF + pos] = i0 + tx + 16 * q;
                pend &= ~(1ull << (8 * p + q));
              }
              ++pos;
            }
          }
        }
        // Offers only append; a tile whose offers all found room is done.
        if (!__syncthreads_or(pend != 0ull)) break;
        // Some buffer is full: each warp sorts its users' fuller buffers
        // (users warp + NWARPS * j).  With SHARED_LIST a buffer keeps its k
        // best; else they merge into the user's list in device memory and the
        // buffer empties.
        const int mine = lane < BU / NWARPS ? ccnt[warp + NWARPS * lane] : 0;
        unsigned todo = __ballot_sync(FULL, mine > BUF - 16);
        while (todo) {
          const int j = __ffs(todo) - 1;
          todo &= todo - 1;
          const int r = warp + NWARPS * j;
          const int n = min(__shfl_sync(FULL, mine, j), BUF);
          const size_t row = ((size_t)split * num_users + u0 + r) * k;
          flush_buffer<SHARED_LIST>(buf_v + r * BUF, buf_i + r * BUF, n, k, ccnt + r, thr + r,
                                    cnt + r, part_vals + row, part_idx + row, lane);
        }
        __syncthreads();
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float t = thr[ty + TY * p];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (!(acc[p][q] >= t)) pend &= ~(1ull << (8 * p + q));
        }
      }
    }
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  }
  __syncthreads();

  if constexpr (EPI == EPI_LSE) {
    // The 16 lanes of a half-warp hold user ty + TY * p's pairs over their
    // items: combine them (a lane without a valid item holds (-inf, 0)).
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      float m = run_m[p], sum = run_s[p];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float mo = __shfl_xor_sync(FULL, m, off);
        const float so = __shfl_xor_sync(FULL, sum, off);
        const float mn = fmaxf(m, mo);
        if (mn != -INFINITY)
          sum = (m == mn ? sum : sum * expf(m - mn)) + (mo == mn ? so : so * expf(mo - mn));
        m = mn;
      }
      const int u = u0 + ty + TY * p;
      if (tx == 0 && u < num_users) {
        part_vals[(size_t)split * num_users + u] = m;
        part_sums[(size_t)split * num_users + u] = sum;
      }
    }
  } else {
    for (int r = warp; r < BU; r += NWARPS) {
      const int u = u0 + r;
      if (u >= num_users) continue;
      const size_t row = ((size_t)split * num_users + u) * k;
      finish_list<SHARED_LIST>(buf_v + r * BUF, buf_i + r * BUF, min(ccnt[r], BUF), k, cnt[r],
                               part_vals + row, part_idx + row, lane);
    }
  }
}

// ----------------------------------------------------------------------
// mlp_topk_kernel
// ----------------------------------------------------------------------
//
// The top-k of the MLP head's scores (pred='nn') over the whole catalog.
// It replaces no Pallas kernel: the JAX package ranks with the head in XLA,
// a user chunk's [C, T, 128] tiles at a time (gnn_recsys_tpu/retrieval/
// recs.py:68-115, make_mlp_score_fn).  The caller factorises the first
// Dense, a_u = u W1_u^T + b1 [U, 128] and a_i = i W1_i^T [I, 128] (two f32
// GEMMs), and the kernel does the rest for every pair (u, i):
//
//   h = relu(a_u[u] + a_i[i]);  z = relu(h W2^T + b2);  s = sigmoid(z . w3 + b3)
//
// and ranks s as EPI_TOPK ranks a score.  No score leaves the registers.
//
// What bounds it.  Layers 2 and 3 are 4,128 FMAs a pair against two
// 128-float rows: 8,256 operations, 2.5e13 for 100,000 users against 30,000
// items.  So f32 FMA throughput on the CUDA cores bounds it (67 TFLOP/s),
// with no TF32 and no tensor cores: the products are full f32, as the plain
// version's.  The adds and maxes that form h, the loads of W2 and layer 3
// take issue slots besides, about an eighth of them.
//
// The design.  A block of 256 threads owns BU=128 users, resident in shared
// memory beside W2 transposed ([128][32]: a warp's reads of a row of it are
// broadcasts), and walks its catalog range in tiles of BI=64 items of a_i,
// streamed through a two-stage cp.async ring (a tile is 128 users x 64 items
// of work, so two stages hide the copy).  Each warp owns 16 of the users and
// scores them two at a time against the tile's items, two a lane: a thread's
// register tile is 2 users x 2 items x the 32 outputs of layer 2, 128
// accumulators, so each step of the 128-wide sum costs 4 adds, 4 maxes and 8
// float4 loads of W2 for 128 FMAs, and a float4 of each of the four rows per
// 4 steps.  h is formed in registers and never stored.  The sum over the 128
// inputs runs in order, one FMA each, then b2 is added; layer 3 is FMAs in
// order over the 32 outputs, then b3; the sigmoid is 1 / (1 + expf(-x)) with
// the IEEE division, as PyTorch's sigmoid computes it.  On the H100 at 4,096
// users x 30,000 items it runs at 56% of the f32 peak: edited copies with W2
// taken from registers ran 9% faster, with no top-k 2%; one with W2 as
// constant-bank operands of a fully unrolled sum ran at half the speed.
//
// Top-k.  A warp owns its users, so it offers their scores with no atomic
// and no block barrier: per user a ballot of the lanes whose scores reach the
// user's k-th value, a prefix count that places them in the user's BUF-entry
// buffer, and a full buffer flushed at once by the same warp (flush_buffer:
// EPI_TOPK's sort, its SHARED_LIST route for k <= 32 and its merge into the
// list in device memory for larger k).  The lists, catalog splits and
// merge_kernel are EPI_TOPK's, so ties go to the lowest index.
namespace mk {
constexpr int H1 = 128;     // the head's first hidden width: a_u and a_i rows
constexpr int H2 = 32;      // its second
constexpr int BU = tk::BU;  // users per block: 16 a warp
constexpr int BI = 64;      // catalog items per tile: lane and lane + 32
constexpr int THREADS = tk::THREADS;
constexpr int NWARPS = tk::NWARPS;
constexpr int STAGES = 2;   // a_i tiles in the ring
constexpr int LDI = H1 + 4; // floats a staged item row: 8 lanes' float4 reads of 8 rows
                            // fall on distinct banks
constexpr int BUF = tk::BUF;
// Shared memory: ring, users, W2^T, b2, w3 (floats); buffers; three counters a user.
constexpr int SMEM_BYTES =
    4 * (STAGES * BI * LDI + BU * H1 + H1 * H2 + 2 * H2) + BU * BUF * 8 + 3 * BU * 4;
static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
static_assert(BU % (2 * NWARPS) == 0, "a warp scores its users two at a time");
}  // namespace mk

__device__ __forceinline__ float component(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The head's scores of two users (rows ua, ub of the resident users) against
// a lane's two items (rows it and it + 32 of the staged tile): s[p][q] for
// user p and item q.
__device__ __forceinline__ void tower_scores(const float* ua, const float* ub, const float* it,
                                             const float* w2t, const float* b2s,
                                             const float* w3s, float b3, float (&s)[2][2]) {
  constexpr int H1 = mk::H1, H2 = mk::H2, LDI = mk::LDI;
  float acc[2][2][H2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < H2; ++j) acc[p][q][j] = 0.f;
  // The rows' next 4 inputs are loaded a step ahead (the last step loads
  // the first again, unused), two steps a loop: 4.6% faster at 4,096 x
  // 30,000 than neither (28.5 -> 27.2 ms on the H100).
  float4 x[2] = {load4(ua), load4(ub)};
  float4 y[2] = {load4(it), load4(it + 32 * LDI)};
#pragma unroll 2
  for (int c = 0; c < H1; c += 4) {
    const int cn = (c + 4) & (H1 - 1);
    const float4 xn[2] = {load4(ua + cn), load4(ub + cn)};
    const float4 yn[2] = {load4(it + cn), load4(it + 32 * LDI + cn)};
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float h[2][2];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          h[p][q] = fmaxf(component(x[p], cc) + component(y[q], cc), 0.f);
      const float* w = w2t + (c + cc) * H2;
#pragma unroll
      for (int j = 0; j < H2; j += 4) {
        const float4 wj = load4(w + j);
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            acc[p][q][j] = fmaf(h[p][q], wj.x, acc[p][q][j]);
            acc[p][q][j + 1] = fmaf(h[p][q], wj.y, acc[p][q][j + 1]);
            acc[p][q][j + 2] = fmaf(h[p][q], wj.z, acc[p][q][j + 2]);
            acc[p][q][j + 3] = fmaf(h[p][q], wj.w, acc[p][q][j + 3]);
          }
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      x[p] = xn[p];
      y[p] = yn[p];
    }
  }
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float logit = 0.f;
#pragma unroll
      for (int j = 0; j < H2; ++j)
        logit = fmaf(fmaxf(acc[p][q][j] + b2s[j], 0.f), w3s[j], logit);
      s[p][q] = 1.f / (1.f + expf(-(logit + b3)));
    }
}

// Offer a lane's two scores v[q] (items i0 + lane + 32 q, those below i_end)
// to a user's buffer (bv, bi; its counters ccnt, thr, cnt; its list lv, li),
// which only the calling warp touches: the scores that reach the user's k-th
// value go in by a prefix count over the lanes, and a full buffer is flushed
// and the rest filtered again.  Called by a whole warp.
template <bool SHARED_LIST>
__device__ __forceinline__ void offer_warp(const float (&v)[2], int i0, int i_end, int k,
                                           float* bv, int* bi, int* ccnt, float* thr, int* cnt,
                                           float* lv, int* li, int lane) {
  const unsigned below = (1u << lane) - 1u;
  const float t = *thr;
  bool pass[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) pass[q] = i0 + lane + 32 * q < i_end && v[q] >= t;
  while (true) {
    const unsigned m0 = __ballot_sync(FULL, pass[0]);
    const unsigned m1 = __ballot_sync(FULL, pass[1]);
    const int n = __popc(m0) + __popc(m1);
    if (n == 0) return;
    const int c = *ccnt;
    const int pos[2] = {c + __popc(m0 & below), c + __popc(m0) + __popc(m1 & below)};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (pass[q] && pos[q] < tk::BUF) {
        bv[pos[q]] = v[q];
        bi[pos[q]] = i0 + lane + 32 * q;
        pass[q] = false;
      }
    }
    __syncwarp();
    if (c + n <= tk::BUF) {
      if (lane == 0) *ccnt = c + n;
      __syncwarp();
      return;
    }
    flush_buffer<SHARED_LIST>(bv, bi, tk::BUF, k, ccnt, thr, cnt, lv, li, lane);
    __syncwarp();
    const float raised = *thr;
#pragma unroll
    for (int q = 0; q < 2; ++q) pass[q] = pass[q] && v[q] >= raised;
  }
}

// Ranks users [u0, u0 + BU) by the head over catalog range [i_begin, i_end)
// and writes the range's top-k per user to part_vals / part_idx
// [split][user][k] (idx -1 past the range's item count).  a_u [U][H1], a_i
// [I][H1], w2 [H2][H1], b2 [H2], w3 [H2], b3 [1], all f32.  SHARED_LIST: k
// <= SHARED_K.
template <bool SHARED_LIST>
__global__ void __launch_bounds__(mk::THREADS, 1)
mlp_topk_kernel(const float* __restrict__ a_u, const float* __restrict__ a_i,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3, int num_users,
                int num_items, int k, int split_items, float* __restrict__ part_vals,
                int* __restrict__ part_idx) {
  constexpr int BU = mk::BU, BI = mk::BI, H1 = mk::H1, H2 = mk::H2, LDI = mk::LDI;
  constexpr int THREADS = mk::THREADS, NWARPS = mk::NWARPS, BUF = mk::BUF;
  extern __shared__ __align__(16) unsigned char mksmem[];
  float* ring = reinterpret_cast<float*>(mksmem);    // [STAGES][BI][LDI]
  float* us = ring + mk::STAGES * BI * LDI;          // [BU][H1]
  float* w2t = us + BU * H1;                         // [H1][H2]
  float* b2s = w2t + H1 * H2;                        // [H2]
  float* w3s = b2s + H2;                             // [H2]
  float* buf_v = w3s + H2;                           // [BU][BUF]
  int* buf_i = reinterpret_cast<int*>(buf_v + BU * BUF);  // [BU][BUF]
  int* ccnt = buf_i + BU * BUF;                      // [BU] entries in the buffer
  float* thr = reinterpret_cast<float*>(ccnt + BU);  // [BU] k-th value, -inf until k
  int* cnt = reinterpret_cast<int*>(thr + BU);       // [BU] list entries (k > SHARED_K)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int u0 = blockIdx.x * BU;
  const int split = blockIdx.y;
  const int i_begin = split * split_items;
  const int i_end = min(num_items, i_begin + split_items);
  const int tiles = (i_end - i_begin + BI - 1) / BI;

  for (int r = tid; r < BU; r += THREADS) {
    ccnt[r] = 0;
    cnt[r] = 0;
    thr[r] = -INFINITY;
  }
  for (int e = tid; e < H1 * H2; e += THREADS) w2t[e] = w2[(e % H2) * H1 + e / H2];
  if (tid < H2) {
    b2s[tid] = b2[tid];
    w3s[tid] = w3[tid];
  }
  const float bias3 = *b3;
  // The users go in the first tile's commit group.
  copy_rows<H1>(us, H1, a_u, u0, BU, num_users, 0, H1, H1);
  auto issue = [&](int t) {
    if (t < tiles)
      copy_rows<H1>(ring + (t % mk::STAGES) * BI * LDI, LDI, a_i, i_begin + t * BI, BI, i_end,
                    0, H1, H1);
    cp_async_commit();
  };
  issue(0);
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1
    issue(t + 1);
    const float* it = ring + (t % mk::STAGES) * BI * LDI + lane * LDI;
    const int i0 = i_begin + t * BI;
#pragma unroll 1
    for (int r = warp; r < BU; r += 2 * NWARPS) {  // users r and r + NWARPS
      if (u0 + r >= num_users) break;
      float s[2][2];
      tower_scores(us + r * H1, us + (r + NWARPS) * H1, it, w2t, b2s, w3s, bias3, s);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int ru = r + p * NWARPS;
        if (u0 + ru >= num_users) break;
        const size_t row = ((size_t)split * num_users + u0 + ru) * k;
        offer_warp<SHARED_LIST>(s[p], i0, i_end, k, buf_v + ru * BUF, buf_i + ru * BUF,
                                ccnt + ru, thr + ru, cnt + ru, part_vals + row,
                                part_idx + row, lane);
      }
    }
  }
  // A warp's users are its own: no barrier before their lists.
  for (int r = warp; r < BU; r += NWARPS) {
    const int u = u0 + r;
    if (u >= num_users) continue;
    const size_t row = ((size_t)split * num_users + u) * k;
    finish_list<SHARED_LIST>(buf_v + r * BUF, buf_i + r * BUF, min(ccnt[r], BUF), k, cnt[r],
                             part_vals + row, part_idx + row, lane);
  }
}

// ----------------------------------------------------------------------
// Combining the catalog splits
// ----------------------------------------------------------------------

// One warp per user: merge the S partial lists (splits in catalog order)
// into the final top-k.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
merge_kernel(const float* __restrict__ part_vals, const int* __restrict__ part_idx,
             int num_splits, int num_users, int k, float* __restrict__ out_vals,
             long long* __restrict__ out_idx) {
  extern __shared__ __align__(16) float msmem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u = blockIdx.x * MERGE_WARPS + warp;
  if (u >= num_users) return;  // warp-uniform
  float* lv = msmem + warp * k;
  int* li = reinterpret_cast<int*>(msmem + MERGE_WARPS * k) + warp * k;
  int n = 0;
  float rv = -INFINITY;  // the register list when k <= 32
  int ri = -1;
  for (int s = 0; s < num_splits; ++s) {
    const size_t row = ((size_t)s * num_users + u) * k;
    for (int base = 0; base < k; base += 32) {
      const int p = base + lane;
      const bool in = p < k;
      const int i = in ? part_idx[row + p] : -1;
      const float v = in ? part_vals[row + p] : -INFINITY;
      if (k <= 32) {
        n = merge_chunk_reg(rv, ri, n, k, v, i, i >= 0, lane);
      } else {  // a chunk of a partial list is sorted, its real entries first
        const float cv[1] = {v};
        const int ci[1] = {i};
        n = merge_chunk<1>(lv, li, n, k, cv, ci, __popc(__ballot_sync(FULL, i >= 0)), lane);
      }
    }
  }
  if (k <= 32 && lane < k) {
    lv[lane] = rv;
    li[lane] = ri;
  }
  __syncwarp();
  for (int p = lane; p < k; p += 32) {
    const bool ok = p < n;
    out_vals[(size_t)u * k + p] = ok ? lv[p] : -INFINITY;
    out_idx[(size_t)u * k + p] = ok ? (long long)li[p] : 0;
  }
}

// One thread per user: combine the S partial (max, sum-exp) pairs.
__global__ void lse_combine_kernel(const float* __restrict__ part_m,
                                   const float* __restrict__ part_s, int num_splits,
                                   int num_users, float* __restrict__ m_out,
                                   float* __restrict__ s_out) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= num_users) return;
  float m = -INFINITY;
  for (int s = 0; s < num_splits; ++s) m = fmaxf(m, part_m[(size_t)s * num_users + u]);
  float sum = 0.f;
  for (int s = 0; s < num_splits; ++s) {
    const size_t row = (size_t)s * num_users + u;
    sum += part_s[row] * expf(part_m[row] - m);
  }
  m_out[u] = m;
  s_out[u] = sum;
}

// ----------------------------------------------------------------------
// Host side
// ----------------------------------------------------------------------

// Catalog splits: as many block columns as fit in one wave of resident
// blocks (a second, nearly empty wave would cost as much as the first),
// each at least MIN_SPLIT_TILES tiles long.
int split_count(int user_blocks, int tiles, int blocks_per_sm) {
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int target = max(1, sms * max(blocks_per_sm, 1));
  int splits = target / user_blocks;
  splits = max(1, min(splits, tiles / MIN_SPLIT_TILES));
  const int tiles_per_split = (tiles + splits - 1) / splits;
  return (tiles + tiles_per_split - 1) / tiles_per_split;
}

// Sets the dynamic shared memory of a kernel and reads its occupancy.
template <typename K>
cudaError_t configure(K kernel, int threads, int smem, int* blocks_per_sm) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
}

template <typename T>
using TkKernel = void (*)(const T*, const T*, int, int, int, int, int, int, const float*, float,
                          const float*, const float*, float*, int*, float*);

// The instantiation of topk_kernel a launch with epilogue epi and k runs.
template <typename T>
TkKernel<T> tk_kernel(int epi, int k) {
  const bool shared_list = k <= tk::SHARED_K;
  if (epi == EPI_LSE) return topk_kernel<T, false, EPI_LSE>;
  if (epi == EPI_BOOST)
    return shared_list ? topk_kernel<T, true, EPI_BOOST> : topk_kernel<T, false, EPI_BOOST>;
  return shared_list ? topk_kernel<T, true, EPI_TOPK> : topk_kernel<T, false, EPI_TOPK>;
}

template <typename T>
cudaError_t tk_configure(int epi, int D, int k, int resident, int* blocks_per_sm) {
  return configure(tk_kernel<T>(epi, k), tk::THREADS,
                   tk_layout(D, sizeof(T), resident, epi).total, blocks_per_sm);
}

// One launch of topk_kernel over `splits` block columns of the catalog.
template <typename T>
cudaError_t tk_launch(int epi, const void* users, const void* items, int num_users,
                      int num_items, int D, int k, int resident, int splits, const void* pop,
                      float weight, const void* m_in, const void* s_in, void* part_vals,
                      void* part_idx, void* part_sums, cudaStream_t stream) {
  int blocks_per_sm = 0;
  cudaError_t err = tk_configure<T>(epi, D, k, resident, &blocks_per_sm);
  if (err != cudaSuccess) return err;
  const int tiles = (num_items + tk::BI - 1) / tk::BI;
  const int split_items = ((tiles + splits - 1) / splits) * tk::BI;
  const dim3 grid((num_users + tk::BU - 1) / tk::BU, splits);
  const int smem = tk_layout(D, sizeof(T), resident, epi).total;
  const TkKernel<T> kernel = tk_kernel<T>(epi, k);
  kernel<<<grid, tk::THREADS, smem, stream>>>(
      static_cast<const T*>(users), static_cast<const T*>(items), num_users, num_items, D, k,
      split_items, resident, static_cast<const float*>(pop), weight,
      static_cast<const float*>(m_in), static_cast<const float*>(s_in),
      static_cast<float*>(part_vals), static_cast<int*>(part_idx),
      static_cast<float*>(part_sums));
  return cudaGetLastError();
}

cudaError_t launch_scores(int epi, int bf16, const void* users, const void* items,
                          int num_users, int num_items, int D, int k, int resident, int splits,
                          const void* pop, float weight, const void* m_in, const void* s_in,
                          void* part_vals, void* part_idx, void* part_sums,
                          cudaStream_t stream) {
  return bf16 ? tk_launch<__nv_bfloat16>(epi, users, items, num_users, num_items, D, k,
                                         resident, splits, pop, weight, m_in, s_in, part_vals,
                                         part_idx, part_sums, stream)
              : tk_launch<float>(epi, users, items, num_users, num_items, D, k, resident,
                                 splits, pop, weight, m_in, s_in, part_vals, part_idx,
                                 part_sums, stream);
}

cudaError_t launch_merge(const void* part_vals, const void* part_idx, int splits,
                         int num_users, int k, void* out_vals, void* out_idx,
                         cudaStream_t stream) {
  const int smem = MERGE_WARPS * k * 8;
  merge_kernel<<<(num_users + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, smem,
                 stream>>>(static_cast<const float*>(part_vals),
                           static_cast<const int*>(part_idx), splits, num_users, k,
                           static_cast<float*>(out_vals),
                           static_cast<long long*>(out_idx));
  return cudaGetLastError();
}

using MkKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const float*, int, int, int, int, float*, int*);

// The instantiation of mlp_topk_kernel a launch with k runs.
MkKernel mk_kernel(int k) {
  return k <= tk::SHARED_K ? mlp_topk_kernel<true> : mlp_topk_kernel<false>;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest k the top-k epilogues take.
int mips_max_k() { return tk::MAX_K; }

// Shared-memory bytes of a topk_kernel launch with epilogue epi (0: top-k,
// 1: boost, 2: LSE); the host plans with a mirror of this layout and picks
// resident users where they fit.
int mips_topk_smem_bytes(int D, int bf16, int resident, int epi) {
  return tk_layout(D, bf16 ? 2 : 4, resident, epi).total;
}

// Number of catalog splits a launch with these sizes uses; the caller sizes
// the partial buffers ([splits][num_users][k], or [splits][num_users] for
// the LSE epilogue).
int mips_topk_splits(int num_users, int num_items, int D, int k, int resident, int bf16,
                     int epi) {
  int blocks_per_sm = 1;
  const cudaError_t err =
      bf16 ? tk_configure<__nv_bfloat16>(epi, D, k, resident, &blocks_per_sm)
           : tk_configure<float>(epi, D, k, resident, &blocks_per_sm);
  if (err != cudaSuccess) return 1;
  return split_count((num_users + tk::BU - 1) / tk::BU, (num_items + tk::BI - 1) / tk::BI,
                     blocks_per_sm);
}

int mips_topk_launch(const void* users, const void* items, int num_users, int num_items,
                     int D, int k, int bf16, int resident, int splits, void* part_vals,
                     void* part_idx, void* out_vals, void* out_idx, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 || k < 1 || k > tk::MAX_K) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_scores(EPI_TOPK, bf16, users, items, num_users, num_items, D, k,
                                  resident, splits, nullptr, 0.f, nullptr, nullptr, part_vals,
                                  part_idx, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_vals, part_idx, splits, num_users, k, out_vals, out_idx, st);
}

int mips_lse_launch(const void* users, const void* items, int num_users, int num_items,
                    int D, int bf16, int resident, int splits, void* part_m, void* part_s,
                    void* m_out, void* s_out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_scores(EPI_LSE, bf16, users, items, num_users, num_items, D, 0,
                                  resident, splits, nullptr, 0.f, nullptr, nullptr, part_m,
                                  nullptr, part_s, st);
  if (err != cudaSuccess) return (int)err;
  lse_combine_kernel<<<(num_users + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s), splits,
      num_users, static_cast<float*>(m_out), static_cast<float*>(s_out));
  return (int)cudaGetLastError();
}

int mips_boost_launch(const void* users, const void* items, const void* pop,
                      const void* m_in, const void* s_in, float weight, int num_users,
                      int num_items, int D, int k, int bf16, int resident, int splits,
                      void* part_vals, void* part_idx, void* out_vals, void* out_idx,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 || k < 1 || k > tk::MAX_K) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_scores(EPI_BOOST, bf16, users, items, num_users, num_items, D, k,
                                  resident, splits, pop, weight, m_in, s_in, part_vals,
                                  part_idx, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_vals, part_idx, splits, num_users, k, out_vals, out_idx, st);
}

// The MLP head's widths mlp_topk_kernel is built for: 0, the first hidden
// layer's; 1, the second's.
int mlp_topk_widths(int which) { return which == 0 ? mk::H1 : mk::H2; }

// Number of catalog splits an mlp_topk launch with these sizes uses; the
// caller sizes the partial lists [splits][num_users][k].
int mlp_topk_splits(int num_users, int num_items, int k) {
  int blocks_per_sm = 1;
  if (configure(mk_kernel(k), mk::THREADS, mk::SMEM_BYTES, &blocks_per_sm) != cudaSuccess)
    return 1;
  return split_count((num_users + mk::BU - 1) / mk::BU, (num_items + mk::BI - 1) / mk::BI,
                     blocks_per_sm);
}

int mlp_topk_launch(const void* a_u, const void* a_i, const void* w2, const void* b2,
                    const void* w3, const void* b3, int num_users, int num_items, int k,
                    int splits, void* part_vals, void* part_idx, void* out_vals, void* out_idx,
                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > tk::MAX_K || splits < 1) return (int)cudaErrorInvalidValue;
  const MkKernel kernel = mk_kernel(k);
  int blocks_per_sm = 0;
  cudaError_t err = configure(kernel, mk::THREADS, mk::SMEM_BYTES, &blocks_per_sm);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (num_items + mk::BI - 1) / mk::BI;
  const int split_items = ((tiles + splits - 1) / splits) * mk::BI;
  const dim3 grid((num_users + mk::BU - 1) / mk::BU, splits);
  kernel<<<grid, mk::THREADS, mk::SMEM_BYTES, st>>>(
      static_cast<const float*>(a_u), static_cast<const float*>(a_i),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3), num_users, num_items, k,
      split_items, static_cast<float*>(part_vals), static_cast<int*>(part_idx));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_vals, part_idx, splits, num_users, k, out_vals, out_idx, st);
}

}  // extern "C"
