// Full-catalog maximum-inner-product top-k for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of gnn_recsys_tpu/ops/pallas/topk_mips.py:
//   * mips_topk           (_mips_kernel,  topk_mips.py:52)  -> topk_kernel
//   * mips_topk_boosted   pass 1 (_lse_kernel,   :108)     -> mips_kernel, MODE_LSE
//   * mips_topk_boosted   pass 2 (_boost_kernel, :141)     -> mips_kernel, MODE_BOOST
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
// topk_kernel, the score tile of mips_topk.  A block of 256 threads owns
// BU=128 users and one contiguous range of the catalog, walked in tiles of
// BI=128 items; a thread holds an 8 x 8 register tile of scores, users
// ty + 16p and items tx + 16q, so that a warp's fragment reads fall on
// distinct banks.  The catalog streams through a ring of STAGES shared-memory
// stages of BK=32 dims, copied with cp.async in its own row-major layout (4
// dims of one row a copy: 16 bytes in f32, 8 in bf16; zero-filled past the
// range and past D) while earlier stages are multiplied, one barrier a stage.
// Fragments are read 4 dims of one row at a time, so nothing is transposed;
// bf16 stays bf16 in shared memory and is widened when it is read.  The
// block's users are copied once for the whole walk where shared memory holds
// them (66 KB in f32 at D=128); otherwise they go through the ring beside
// the items.  The epilogue works in registers: a thread compares its 64
// scores with its users' current k-th values and sends only those that
// reach them to the user's buffer in shared memory (the 16 lanes of a
// half-warp share a user: a prefix sum of their counts and one shared atomic
// place them).  For k <= 32 the buffer holds BUF=64 entries: the user's list,
// then the candidates offered since.  Offers only append, so a tile costs
// one barrier; when a buffer fills, its warp sorts it (a bitonic network over
// 64 entries, two a lane, in registers) and keeps the k best, which also
// raises the user's k-th value.  Every candidate that reaches a k-th value
// needs an insert in a list kept in order, one at a time a user; a buffer
// needs one sort for every 32 or more of them.  For
// k > 32 a warp merges up to CAP candidates a user at a time into its list
// in the block's row of the partial lists in device memory.  A list is the
// first k entries of the order (value descending, index ascending), that of a
// stable
// descending sort (the lowest-index tie rule of _extract_topk); columns
// >= num_items never enter.
//
// Catalog splits.  When there are too few user blocks to fill the card (a
// request of a few thousand users is 32 blocks on 132 SMs), the catalog is
// split into S contiguous ranges, one block column each; each block writes
// its partial list (or its partial max / sum-exp for MODE_LSE) and a second
// small kernel merges the S partials per user under the same order, which
// stays exact.
//
// mips_kernel, the first design, still runs both passes of the boosted
// top-k: 128 threads own 64 users; each 32-dim chunk of both operands is
// staged synchronously (transposed), each tile's scores go through a shared
// score tile, and flagged users' rows merge into lists in shared memory.
// MODE_LSE keeps an online max and sum-exp per user; MODE_BOOST re-scores
// each tile as exp(s - m) / sum + w * pop[i] and runs the same top-k merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 232448; // bytes of shared memory a block may use
constexpr int MIN_SPLIT_TILES = 4; // catalog tiles per split, at least
constexpr int MERGE_WARPS = 4;     // users per block of the merge kernel

// mips_kernel (the boosted passes)
constexpr int BU = 64;             // users per block
constexpr int BI = 128;            // catalog items per tile
constexpr int BK = 32;             // embedding dims per staged chunk
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int A_STRIDE = BU + 4;   // floats per staged user row (16-byte aligned)
constexpr int B_STRIDE = BI + 4;   // floats per staged item row
constexpr int S_STRIDE = BI + 1;   // floats per score-tile row

enum { MODE_LSE = 1, MODE_BOOST = 2 };

// The score tile reuses the staging buffers' space (they are idle while
// it lives), so four blocks fit on an SM at the serving k.
constexpr int STAGE_FLOATS = BK * A_STRIDE + BK * B_STRIDE;
constexpr int TILE_FLOATS = STAGE_FLOATS > BU * S_STRIDE ? STAGE_FLOATS : BU * S_STRIDE;
constexpr int fixed_smem_bytes() { return (TILE_FLOATS + 5 * BU) * 4; }
constexpr int MAX_K = ((SMEM_LIMIT - fixed_smem_bytes()) / (BU * 8)) / 32 * 32;

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
constexpr int CAP = 32;            // candidate slots a user between merges, k > SHARED_K
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

// Stage rows [row0, row0 + NROWS) x dims [d0, d0 + BK) of a row-major
// [nrows, D] matrix into dst[BK][STRIDE], transposed and widened to f32.
// Out-of-range rows and dims are zero.
template <int NROWS, int STRIDE, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int row0, int nrows, int d0, int D) {
  constexpr int GROUPS = NROWS * BK / 4;
#pragma unroll
  for (int rep = 0; rep < GROUPS / THREADS; ++rep) {
    const int g = rep * THREADS + threadIdx.x;
    const int r = g / (BK / 4);
    const int c = (g % (BK / 4)) * 4;
    const int row = row0 + r;
    const int d = d0 + c;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < nrows && d < D) v = load4(src + (size_t)row * D + d);
    dst[(c + 0) * STRIDE + r] = v.x;
    dst[(c + 1) * STRIDE + r] = v.y;
    dst[(c + 2) * STRIDE + r] = v.z;
    dst[(c + 3) * STRIDE + r] = v.w;
  }
}

// Whether (v, i) comes before (pv, pi): value descending, index ascending.
__device__ __forceinline__ bool before(float v, int i, float pv, int pi) {
  return v > pv || (v == pv && i < pi);
}

// Merge 32 candidates (one per lane; `valid` marks real ones) into a
// running top-k (lv, li; n valid entries, n uniform across the warp), in
// shared or device memory.  Called by a whole warp; returns the new n.
__device__ __forceinline__ int merge_chunk(float* lv, int* li, int n, int k,
                                           float v, int idx, bool valid, int lane) {
  bool pass = valid;
  if (n == k) pass = pass && before(v, idx, lv[k - 1], li[k - 1]);
  unsigned mask = __ballot_sync(FULL, pass);
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cv = __shfl_sync(FULL, v, src);
    const int ci = __shfl_sync(FULL, idx, src);
    if (n == k && !before(cv, ci, lv[k - 1], li[k - 1])) continue;
    // Insert position: entries that come before the candidate.
    int pos = 0;
    for (int base = 0; base < n; base += 32) {
      const int p = base + lane;
      const bool b = p < n && before(lv[p], li[p], cv, ci);
      pos += __popc(__ballot_sync(FULL, b));
    }
    // Shift [pos, last) one slot right, highest chunk first.
    const int last = min(n, k - 1);
    for (int hi = last; hi > pos; hi -= 32) {
      const int p = hi - 1 - lane;
      const bool act = p >= pos;
      float tv = 0.f;
      int ti = 0;
      if (act) {
        tv = lv[p];
        ti = li[p];
      }
      __syncwarp();
      if (act) {
        lv[p + 1] = tv;
        li[p + 1] = ti;
      }
      __syncwarp();
    }
    if (lane == 0) {
      lv[pos] = cv;
      li[pos] = ci;
    }
    __syncwarp();
    n = min(n + 1, k);
  }
  return n;
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
// (ring, users, the per-user buffers, per-user counters).
struct TkLayout {
  int stage;
  int users;
  int total;
};

__host__ __device__ inline TkLayout tk_layout(int D, int esize, int resident) {
  TkLayout L;
  L.stage = (tk::BI + (resident ? 0 : tk::BU)) * tk::LDK * esize;
  L.users = resident ? tk::BU * tk_user_stride(D) * esize : 0;
  L.total = tk::STAGES * L.stage + L.users + tk::BU * tk::BUF * 8 + 3 * tk::BU * 4;
  return L;
}

// Scores users [u0, u0 + BU) against catalog range [i_begin, i_end) and
// writes the range's top-k per user to part_vals / part_idx [split][user][k]
// (idx -1 past the range's item count).  SHARED_LIST: k <= SHARED_K.
template <typename T, bool SHARED_LIST>
__global__ void __launch_bounds__(tk::THREADS, 1)
topk_kernel(const T* __restrict__ users, const T* __restrict__ items, int num_users,
            int num_items, int D, int k, int split_items, int resident,
            float* __restrict__ part_vals, int* __restrict__ part_idx) {
  constexpr int BU = tk::BU, BI = tk::BI, BK = tk::BK, TY = tk::TY, THREADS = tk::THREADS;
  constexpr int NWARPS = tk::NWARPS, STAGES = tk::STAGES, CAP = tk::CAP, LDK = tk::LDK;
  constexpr int BUF = tk::BUF;
  extern __shared__ __align__(16) unsigned char tsmem[];
  const TkLayout L = tk_layout(D, sizeof(T), resident);
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

  for (int r = tid; r < BU; r += THREADS) {
    ccnt[r] = 0;
    cnt[r] = 0;
    thr[r] = -INFINITY;
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
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
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

    // Epilogue: scores that reach their user's k-th value, bit 8p + q.
    const int i0 = i_begin + (s / nchunks) * BI;
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
      bool offered = false;
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
        offered = mine != 0ull;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int r = ty + TY * p;
          int pos = static_cast<int>(base >> (8 * p)) & 0xff;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (!((offer_bits >> (8 * p + q)) & 1ull)) continue;
            if (pos < (SHARED_LIST ? BUF : CAP)) {  // else it stays pending
              buf_v[r * BUF + pos] = acc[p][q];
              buf_i[r * BUF + pos] = i0 + tx + 16 * q;
              pend &= ~(1ull << (8 * p + q));
            }
            ++pos;
          }
        }
      }
      if constexpr (SHARED_LIST) {
        // Offers only append; a tile whose offers all found room is done.
        if (!__syncthreads_or(pend != 0ull)) break;
        // Some buffer is full: each warp sorts its users' fuller buffers
        // (users warp + NWARPS * j) and cuts each back to its k best.
        const int mine = lane < BU / NWARPS ? ccnt[warp + NWARPS * lane] : 0;
        unsigned todo = __ballot_sync(FULL, mine > BUF - 16);
        while (todo) {
          const int j = __ffs(todo) - 1;
          todo &= todo - 1;
          const int r = warp + NWARPS * j;
          const int n = min(__shfl_sync(FULL, mine, j), BUF);
          float v[2];
          int id[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = lane + 32 * h;
            v[h] = e < n ? buf_v[r * BUF + e] : -INFINITY;
            id[h] = e < n ? buf_i[r * BUF + e] : INT_MAX;
          }
          sort64(v, id, lane);
          const int kept = min(n, k);
          if (lane < kept) {
            buf_v[r * BUF + lane] = v[0];
            buf_i[r * BUF + lane] = id[0];
          }
          const float kth = __shfl_sync(FULL, v[0], k - 1);
          if (lane == 0) {
            ccnt[r] = kept;
            thr[r] = kept == k ? kth : -INFINITY;
          }
        }
        __syncthreads();
      } else {
        if (!__syncthreads_or(offered)) break;  // no candidate: the tile is done
        // A warp merges the candidates of its users (warp + NWARPS * j, lane
        // j reads user j's count) into their lists in device memory.
        const int mine = lane < BU / NWARPS ? ccnt[warp + NWARPS * lane] : 0;
        unsigned todo = __ballot_sync(FULL, mine > 0);
        while (todo) {
          const int j = __ffs(todo) - 1;
          todo &= todo - 1;
          const int r = warp + NWARPS * j;
          const int nc = min(__shfl_sync(FULL, mine, j), CAP);
          const bool valid = lane < nc;
          const float cv = valid ? buf_v[r * BUF + lane] : -INFINITY;
          const int ci = valid ? buf_i[r * BUF + lane] : -1;
          const size_t row = ((size_t)split * num_users + u0 + r) * k;
          const int n = merge_chunk(part_vals + row, part_idx + row, cnt[r], k, cv, ci, valid,
                                    lane);
          if (lane == 0) {
            cnt[r] = n;
            ccnt[r] = 0;
            thr[r] = n == k ? part_vals[row + k - 1] : -INFINITY;
          }
        }
        // Lists, thresholds and counters are settled; offers that found a
        // full buffer are filtered again and offered in another round.
        if (!__syncthreads_or(pend != 0ull)) break;
      }
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const float t = thr[ty + TY * p];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (!(acc[p][q] >= t)) pend &= ~(1ull << (8 * p + q));
      }
    }
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  }
  __syncthreads();

  for (int r = warp; r < BU; r += NWARPS) {
    const int u = u0 + r;
    if (u >= num_users) continue;
    const size_t row = ((size_t)split * num_users + u) * k;
    if constexpr (SHARED_LIST) {  // the buffer's k best, in list order
      const int n = min(ccnt[r], BUF);
      float v[2];
      int id[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = lane + 32 * h;
        v[h] = e < n ? buf_v[r * BUF + e] : -INFINITY;
        id[h] = e < n ? buf_i[r * BUF + e] : INT_MAX;
      }
      sort64(v, id, lane);
      if (lane < k) {
        part_vals[row + lane] = lane < n ? v[0] : -INFINITY;
        part_idx[row + lane] = lane < n ? id[0] : -1;
      }
    } else {
      for (int p = cnt[r] + lane; p < k; p += 32) {
        part_vals[row + p] = -INFINITY;
        part_idx[row + p] = -1;
      }
    }
  }
}

// ----------------------------------------------------------------------
// mips_kernel (the boosted passes)
// ----------------------------------------------------------------------

// Merge one user's BI-wide score row into its list in shared memory.
__device__ __forceinline__ int merge_row(float* ulv, int* uli, int n, int k,
                                         const float* srow, int i0, int i_end, int lane) {
  if (k <= 32) {  // warp-uniform
    float rv = lane < n ? ulv[lane] : -INFINITY;
    int ri = lane < n ? uli[lane] : -1;
#pragma unroll
    for (int q = 0; q < BI / 32; ++q) {
      const int c = q * 32 + lane;
      n = merge_chunk_reg(rv, ri, n, k, srow[c], i0 + c, i0 + c < i_end, lane);
    }
    if (lane < k) {
      ulv[lane] = rv;
      uli[lane] = ri;
    }
  } else {
#pragma unroll 1
    for (int q = 0; q < BI / 32; ++q) {
      const int c = q * 32 + lane;
      n = merge_chunk(ulv, uli, n, k, srow[c], i0 + c, i0 + c < i_end, lane);
    }
  }
  __syncwarp();
  return n;
}

// Scores users [u0, u0 + BU) against catalog range [i_begin, i_end).
// MODE_BOOST writes the range's top-k per user to part_vals / part_idx
// [split][user][k] (idx -1 past the range's item count); MODE_LSE writes
// the range's max and sum-exp to part_m / part_s [split][user].
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
mips_kernel(const T* __restrict__ users, const T* __restrict__ items,
            int num_users, int num_items, int D, int k, int split_items,
            const float* __restrict__ pop, float weight,
            const float* __restrict__ m_in, const float* __restrict__ s_in,
            float* __restrict__ part_vals, int* __restrict__ part_idx,
            float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                      // [BK][A_STRIDE]
  float* Bs = As + BK * A_STRIDE;        // [BK][B_STRIDE]
  float* S = smem;                       // [BU][S_STRIDE], over As and Bs
  float* row_m = smem + TILE_FLOATS;     // [BU] running max (LSE) / m (BOOST)
  float* row_s = row_m + BU;             // [BU] running sum-exp (LSE) / sum (BOOST)
  float* thr = row_s + BU;               // [BU] k-th value, -inf until k entries
  int* flag = reinterpret_cast<int*>(thr + BU);   // [BU] a score reached thr
  int* cnt = flag + BU;                           // [BU] valid top-k entries
  float* lv = reinterpret_cast<float*>(cnt + BU); // [BU][k]
  int* li = reinterpret_cast<int*>(lv + BU * k);  // [BU][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % 16;  // items 4tx..4tx+3 and 64+4tx..64+4tx+3
  const int ty = tid / 16;  // users 4ty..4ty+3 and 32+4ty..32+4ty+3
  const int u0 = blockIdx.x * BU;
  const int split = blockIdx.y;
  const int i_begin = split * split_items;
  const int i_end = min(num_items, i_begin + split_items);

  for (int r = tid; r < BU; r += THREADS) {
    const int u = u0 + r;
    cnt[r] = 0;
    flag[r] = 0;
    thr[r] = -INFINITY;
    if (MODE == MODE_LSE) {
      row_m[r] = -INFINITY;
      row_s[r] = 0.f;
    } else {
      row_m[r] = u < num_users ? m_in[u] : 0.f;
      row_s[r] = u < num_users ? s_in[u] : 1.f;
    }
  }

#pragma unroll 1
  for (int i0 = i_begin; i0 < i_end; i0 += BI) {
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += BK) {
      __syncthreads();  // the previous chunk and the previous merge are done
      stage<BU, A_STRIDE>(As, users, u0, num_users, d0, D);
      stage<BI, B_STRIDE>(Bs, items, i0, i_end, d0, D);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * A_STRIDE + 4 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk * A_STRIDE + 32 + 4 * ty]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk * B_STRIDE + 4 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk * B_STRIDE + 64 + 4 * tx]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int x = 0; x < 8; ++x)
#pragma unroll
          for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
      }
    }

    // Epilogue: the tile's scores (boosted for MODE_BOOST) into S; flag the
    // users with a score that reaches their current k-th value.
    __syncthreads();  // S overwrites the staged chunks
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int r = (x < 4) ? 4 * ty + x : 32 + 4 * ty + (x - 4);
      const float t = thr[r];
      bool hit = false;
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        const int c = (y < 4) ? 4 * tx + y : 64 + 4 * tx + (y - 4);
        float v = acc[x][y];
        if (i0 + c < i_end) {
          if (MODE == MODE_BOOST) v = expf(v - row_m[r]) / row_s[r] + weight * pop[i0 + c];
          hit = hit || v >= t;
        }
        S[r * S_STRIDE + c] = v;
      }
      if (MODE != MODE_LSE && hit) flag[r] = 1;
    }
    __syncthreads();

#pragma unroll 1
    for (int r = warp; r < BU; r += NWARPS) {
      if (u0 + r >= num_users) continue;
      const float* srow = S + r * S_STRIDE;
      if (MODE == MODE_LSE) {
        float v[BI / 32];
        float tmax = -INFINITY;
#pragma unroll
        for (int q = 0; q < BI / 32; ++q) {
          const int c = q * 32 + lane;
          v[q] = (i0 + c < i_end) ? srow[c] : -INFINITY;
          tmax = fmaxf(tmax, v[q]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, off));
        const float m_old = row_m[r];
        const float m_new = fmaxf(m_old, tmax);
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < BI / 32; ++q) sum += expf(v[q] - m_new);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
        __syncwarp();
        if (lane == 0) {
          row_s[r] = row_s[r] * expf(m_old - m_new) + sum;
          row_m[r] = m_new;
        }
      } else {
        if (!flag[r]) continue;
        float* ulv = lv + r * k;
        int* uli = li + r * k;
        const int n = merge_row(ulv, uli, cnt[r], k, srow, i0, i_end, lane);
        if (lane == 0) {
          cnt[r] = n;
          flag[r] = 0;
          thr[r] = (n == k) ? ulv[k - 1] : -INFINITY;
        }
      }
    }
  }
  __syncthreads();

  for (int r = warp; r < BU; r += NWARPS) {
    const int u = u0 + r;
    if (u >= num_users) continue;
    const size_t row = (size_t)split * num_users + u;
    if (MODE == MODE_LSE) {
      if (lane == 0) {
        part_m[row] = row_m[r];
        part_s[row] = row_s[r];
      }
    } else {
      const int n = cnt[r];
      for (int p = lane; p < k; p += 32) {
        const bool ok = p < n;
        part_vals[row * k + p] = ok ? lv[r * k + p] : -INFINITY;
        part_idx[row * k + p] = ok ? li[r * k + p] : -1;
      }
    }
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
      n = (k <= 32) ? merge_chunk_reg(rv, ri, n, k, v, i, i >= 0, lane)
                    : merge_chunk(lv, li, n, k, v, i, i >= 0, lane);
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
cudaError_t tk_configure(int D, int k, int resident, int* blocks_per_sm) {
  const int smem = tk_layout(D, sizeof(T), resident).total;
  return k <= tk::SHARED_K ? configure(topk_kernel<T, true>, tk::THREADS, smem, blocks_per_sm)
                           : configure(topk_kernel<T, false>, tk::THREADS, smem, blocks_per_sm);
}

template <typename T>
cudaError_t tk_launch(const void* users, const void* items, int num_users, int num_items,
                      int D, int k, int resident, int splits, void* part_vals,
                      void* part_idx, cudaStream_t stream) {
  int blocks_per_sm = 0;
  cudaError_t err = tk_configure<T>(D, k, resident, &blocks_per_sm);
  if (err != cudaSuccess) return err;
  const int tiles = (num_items + tk::BI - 1) / tk::BI;
  const int split_items = ((tiles + splits - 1) / splits) * tk::BI;
  const dim3 grid((num_users + tk::BU - 1) / tk::BU, splits);
  const int smem = tk_layout(D, sizeof(T), resident).total;
  const T* u = static_cast<const T*>(users);
  const T* it = static_cast<const T*>(items);
  float* pv = static_cast<float*>(part_vals);
  int* pi = static_cast<int*>(part_idx);
  if (k <= tk::SHARED_K)
    topk_kernel<T, true><<<grid, tk::THREADS, smem, stream>>>(
        u, it, num_users, num_items, D, k, split_items, resident, pv, pi);
  else
    topk_kernel<T, false><<<grid, tk::THREADS, smem, stream>>>(
        u, it, num_users, num_items, D, k, split_items, resident, pv, pi);
  return cudaGetLastError();
}

int smem_bytes(int k) { return fixed_smem_bytes() + BU * k * 8; }

template <typename T, int MODE>
int num_splits(int num_users, int num_items, int k) {
  int blocks_per_sm = 1;
  if (configure(mips_kernel<T, MODE>, THREADS, smem_bytes(k), &blocks_per_sm) != cudaSuccess)
    return 1;
  return split_count((num_users + BU - 1) / BU, (num_items + BI - 1) / BI, blocks_per_sm);
}

template <typename T, int MODE>
cudaError_t launch_main(const void* users, const void* items, int num_users,
                        int num_items, int D, int k, int splits, const void* pop,
                        float weight, const void* m_in, const void* s_in,
                        void* part_vals, void* part_idx, void* part_m, void* part_s,
                        cudaStream_t stream) {
  int blocks_per_sm = 0;
  cudaError_t err = configure(mips_kernel<T, MODE>, THREADS, smem_bytes(k), &blocks_per_sm);
  if (err != cudaSuccess) return err;
  const int tiles = (num_items + BI - 1) / BI;
  const int split_items = ((tiles + splits - 1) / splits) * BI;
  const dim3 grid((num_users + BU - 1) / BU, splits);
  mips_kernel<T, MODE><<<grid, THREADS, smem_bytes(k), stream>>>(
      static_cast<const T*>(users), static_cast<const T*>(items), num_users, num_items,
      D, k, split_items, static_cast<const float*>(pop), weight,
      static_cast<const float*>(m_in), static_cast<const float*>(s_in),
      static_cast<float*>(part_vals), static_cast<int*>(part_idx),
      static_cast<float*>(part_m), static_cast<float*>(part_s));
  return cudaGetLastError();
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

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest k the top-k kernels take: the smaller of mips_kernel's (its
// running lists live in shared memory) and topk_kernel's.
int mips_max_k() { return MAX_K < tk::MAX_K ? MAX_K : tk::MAX_K; }

// Shared-memory bytes of a topk_kernel launch (the host plans with a mirror
// of this layout and picks resident users where they fit).
int mips_topk_smem_bytes(int D, int bf16, int resident) {
  return tk_layout(D, bf16 ? 2 : 4, resident).total;
}

// Number of catalog splits a launch with these sizes uses; the caller sizes
// the partial buffers ([splits][num_users][k], or [splits][num_users]).
int mips_topk_splits(int num_users, int num_items, int D, int k, int resident, int bf16) {
  int blocks_per_sm = 1;
  const cudaError_t err = bf16 ? tk_configure<__nv_bfloat16>(D, k, resident, &blocks_per_sm)
                               : tk_configure<float>(D, k, resident, &blocks_per_sm);
  if (err != cudaSuccess) return 1;
  return split_count((num_users + tk::BU - 1) / tk::BU, (num_items + tk::BI - 1) / tk::BI,
                     blocks_per_sm);
}

int mips_num_splits(int num_users, int num_items, int k, int mode, int bf16) {
  if (mode == MODE_LSE)
    return bf16 ? num_splits<__nv_bfloat16, MODE_LSE>(num_users, num_items, 0)
                : num_splits<float, MODE_LSE>(num_users, num_items, 0);
  return bf16 ? num_splits<__nv_bfloat16, MODE_BOOST>(num_users, num_items, k)
              : num_splits<float, MODE_BOOST>(num_users, num_items, k);
}

int mips_topk_launch(const void* users, const void* items, int num_users, int num_items,
                     int D, int k, int bf16, int resident, int splits, void* part_vals,
                     void* part_idx, void* out_vals, void* out_idx, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 || k < 1 || k > mips_max_k()) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      bf16 ? tk_launch<__nv_bfloat16>(users, items, num_users, num_items, D, k, resident,
                                      splits, part_vals, part_idx, st)
           : tk_launch<float>(users, items, num_users, num_items, D, k, resident, splits,
                              part_vals, part_idx, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_vals, part_idx, splits, num_users, k, out_vals, out_idx, st);
}

int mips_lse_launch(const void* users, const void* items, int num_users, int num_items,
                    int D, int bf16, int splits, void* part_m, void* part_s, void* m_out,
                    void* s_out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch_main<__nv_bfloat16, MODE_LSE>(users, items, num_users, num_items, D, 0,
                                                  splits, nullptr, 0.f, nullptr, nullptr,
                                                  nullptr, nullptr, part_m, part_s, st)
           : launch_main<float, MODE_LSE>(users, items, num_users, num_items, D, 0, splits,
                                          nullptr, 0.f, nullptr, nullptr, nullptr, nullptr,
                                          part_m, part_s, st);
  if (err != cudaSuccess) return (int)err;
  lse_combine_kernel<<<(num_users + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s), splits,
      num_users, static_cast<float*>(m_out), static_cast<float*>(s_out));
  return (int)cudaGetLastError();
}

int mips_boost_launch(const void* users, const void* items, const void* pop,
                      const void* m_in, const void* s_in, float weight, int num_users,
                      int num_items, int D, int k, int bf16, int splits, void* part_vals,
                      void* part_idx, void* out_vals, void* out_idx, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch_main<__nv_bfloat16, MODE_BOOST>(users, items, num_users, num_items, D,
                                                    k, splits, pop, weight, m_in, s_in,
                                                    part_vals, part_idx, nullptr, nullptr,
                                                    st)
           : launch_main<float, MODE_BOOST>(users, items, num_users, num_items, D, k,
                                            splits, pop, weight, m_in, s_in, part_vals,
                                            part_idx, nullptr, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_vals, part_idx, splits, num_users, k, out_vals, out_idx, st);
}

}  // extern "C"
