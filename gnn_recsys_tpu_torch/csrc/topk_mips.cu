// Full-catalog maximum-inner-product top-k for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of gnn_recsys_tpu/ops/pallas/topk_mips.py:
//   * mips_topk           (_mips_kernel,  topk_mips.py:52)  -> MODE_TOPK
//   * mips_topk_boosted   pass 1 (_lse_kernel,   :108)     -> MODE_LSE
//   * mips_topk_boosted   pass 2 (_boost_kernel, :141)     -> MODE_BOOST
//
// What bounds it.  Ranking U users against I items at width D is 2*U*I*D
// floating-point operations (7.7e11 at the serving shape U=100k, I=30k,
// D=128) and only O(U*D + I*D + U*k) bytes, so the kernel is bound by f32
// FMA throughput (67 TFLOP/s on an H100 SXM), not by memory.  The scores
// are f32 FMAs on the CUDA cores: no TF32 and no tensor cores, because a
// truncated product reorders near-tied catalog rankings (the TPU kernel pins
// Precision.HIGHEST for the same reason).  bf16 inputs are widened to f32
// while they are staged, and accumulate in f32.
//
// The simple design.  A block of 128 threads owns BU=64 users and one
// contiguous range of the catalog; a loop over catalog tiles of BI=128 items
// takes the place of the TPU's sequential grid axis.  Each tile's [BU, BI]
// scores are an SGEMM-style register tile (8x8 scores a thread, D staged
// through shared memory BK=32 dims at a time), written to a shared score
// tile that reuses the staging space.  A thread flags each of its users
// whose scores reach that user's current k-th value; a warp then merges only
// the flagged users' rows into their running top-k, kept in shared memory
// (and, for k <= 32, held in registers one entry a lane while a row merges)
// and ordered by (value descending, index ascending).  A candidate enters only if it comes before
// the current k-th entry in that order, so a list is the first k entries of
// a stable descending sort (the lowest-index tie rule of _extract_topk).
// Columns >= num_items never enter.
//
// When there are too few user blocks to fill the card (a request of a few
// thousand users is 64 blocks on 132 SMs), the catalog is split into S
// contiguous ranges, one block column each; each block writes its partial
// list (or its partial max / sum-exp for MODE_LSE) and a second small kernel
// merges the S partials per user under the same order, which stays exact.
// MODE_LSE keeps an online max and sum-exp per user; MODE_BOOST re-scores
// each tile as exp(s - m) / sum + w * pop[i] and runs the same top-k merge.
//
// Left for later work: wgmma for bf16, TMA staging with an mbarrier ring,
// warp specialisation, and double buffering of the staged chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BU = 64;             // users per block
constexpr int BI = 128;            // catalog items per tile
constexpr int BK = 32;             // embedding dims per staged chunk
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int A_STRIDE = BU + 4;   // floats per staged user row (16-byte aligned)
constexpr int B_STRIDE = BI + 4;   // floats per staged item row
constexpr int S_STRIDE = BI + 1;   // floats per score-tile row
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 232448; // bytes of shared memory a block may use
constexpr int MIN_SPLIT_TILES = 4; // catalog tiles per split, at least
constexpr int MERGE_WARPS = 4;     // users per block of the merge kernel

enum { MODE_TOPK = 0, MODE_LSE = 1, MODE_BOOST = 2 };

// The score tile reuses the staging buffers' space (they are idle while
// it lives), so four blocks fit on an SM at the serving k.
constexpr int STAGE_FLOATS = BK * A_STRIDE + BK * B_STRIDE;
constexpr int TILE_FLOATS = STAGE_FLOATS > BU * S_STRIDE ? STAGE_FLOATS : BU * S_STRIDE;
constexpr int fixed_smem_bytes() { return (TILE_FLOATS + 5 * BU) * 4; }
constexpr int MAX_K = ((SMEM_LIMIT - fixed_smem_bytes()) / (BU * 8)) / 32 * 32;

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
// running top-k (lv, li; n valid entries, n uniform across the warp).
// Called by a whole warp; returns the new n.
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
// MODE_TOPK / MODE_BOOST write the range's top-k per user to part_vals /
// part_idx [split][user][k] (idx -1 past the range's item count);
// MODE_LSE writes the range's max and sum-exp to part_m / part_s [split][user].
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
    } else if (MODE == MODE_BOOST) {
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

int smem_bytes(int k) { return fixed_smem_bytes() + BU * k * 8; }

template <typename T, int MODE>
cudaError_t configure(int k, int* blocks_per_sm) {
  const int smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      mips_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, mips_kernel<T, MODE>,
                                                       THREADS, smem);
}

// Catalog splits: as many block columns as fit in one wave of resident
// blocks (a second, nearly empty wave would cost as much as the first),
// each at least MIN_SPLIT_TILES tiles long.
template <typename T, int MODE>
int num_splits(int num_users, int num_items, int k) {
  int blocks_per_sm = 1, device = 0, sms = 1;
  if (configure<T, MODE>(k, &blocks_per_sm) != cudaSuccess) return 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int user_blocks = (num_users + BU - 1) / BU;
  const int tiles = (num_items + BI - 1) / BI;
  const int target = max(1, sms * max(blocks_per_sm, 1));
  int splits = target / user_blocks;
  splits = max(1, min(splits, tiles / MIN_SPLIT_TILES));
  const int tiles_per_split = (tiles + splits - 1) / splits;
  return (tiles + tiles_per_split - 1) / tiles_per_split;
}

template <typename T, int MODE>
cudaError_t launch_main(const void* users, const void* items, int num_users,
                        int num_items, int D, int k, int splits, const void* pop,
                        float weight, const void* m_in, const void* s_in,
                        void* part_vals, void* part_idx, void* part_m, void* part_s,
                        cudaStream_t stream) {
  int blocks_per_sm = 0;
  cudaError_t err = configure<T, MODE>(k, &blocks_per_sm);
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

// Largest k the top-k kernels take (the running lists live in shared memory).
int mips_max_k() { return MAX_K; }

// Number of catalog splits a launch with these sizes uses; the caller sizes
// the partial buffers ([splits][num_users][k], or [splits][num_users]).
int mips_num_splits(int num_users, int num_items, int k, int mode, int bf16) {
  if (mode == MODE_LSE)
    return bf16 ? num_splits<__nv_bfloat16, MODE_LSE>(num_users, num_items, 0)
                : num_splits<float, MODE_LSE>(num_users, num_items, 0);
  if (mode == MODE_BOOST)
    return bf16 ? num_splits<__nv_bfloat16, MODE_BOOST>(num_users, num_items, k)
                : num_splits<float, MODE_BOOST>(num_users, num_items, k);
  return bf16 ? num_splits<__nv_bfloat16, MODE_TOPK>(num_users, num_items, k)
              : num_splits<float, MODE_TOPK>(num_users, num_items, k);
}

int mips_topk_launch(const void* users, const void* items, int num_users, int num_items,
                     int D, int k, int bf16, int splits, void* part_vals, void* part_idx,
                     void* out_vals, void* out_idx, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch_main<__nv_bfloat16, MODE_TOPK>(users, items, num_users, num_items, D, k,
                                                   splits, nullptr, 0.f, nullptr, nullptr,
                                                   part_vals, part_idx, nullptr, nullptr, st)
           : launch_main<float, MODE_TOPK>(users, items, num_users, num_items, D, k, splits,
                                           nullptr, 0.f, nullptr, nullptr, part_vals,
                                           part_idx, nullptr, nullptr, st);
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
