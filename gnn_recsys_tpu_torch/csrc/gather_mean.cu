// Neighbour gather + masked mean, forward and backward, for Hopper (sm_90a).
//
// Replaces gather_mean_pallas of gnn_recsys_tpu/ops/pallas/gather_mean.py
// (_kernel, gather_mean.py:49), the csc_gather_mean contract without edge
// weights:
//
//   out[b] = sum_k m[b,k] * h[clip(nbr[b,k])] / max(sum_k m[b,k], 1)
//
// h [N, D] f32 is a source table, nbr [B, K] int32 row ids (clipped into
// [0, N-1]), m [B, K] uint8 the validity mask; a row with no valid slot gives
// zeros.  The dedup'd block forward runs it on every mean of its bottom-up
// pass (the table is transform_src of the unique nodes of the level below).
//
// The TPU kernel has no backward: JAX differentiates that path through XLA's
// transpose of the gather, a scatter-add.  Training needs the gradient with
// respect to h, so the backward is a kernel too:
//
//   dh[u] = sum over valid slots (b,k) with clip(nbr[b,k]) == u of
//           dout[b] / max(count_b, 1)
//
// What bounds them.  Both move bytes and do almost no arithmetic (one add or
// one multiply-add a gathered element).  Counting each input once and each
// output once, the forward at the training step's widest call (B=38,912,
// K=8, N=30,000, D=256) moves about 72 MB, 0.022 ms at 3.35 TB/s; reading
// every valid slot's row from device memory would be about 319 MB.  A table
// that fits in the 50 MB L2 serves its repeated rows from L2, so the time
// lies between the two readings and the L2's rate sets it; a larger table
// (the step's 100,000-row one, 102 MB) reads from device memory.  The
// backward moves the same bytes the other way.  Neither kernel's warp has
// much to do, so both are held by how many dependent loads are in flight on
// an SM: more warps resident beat more loads a warp (measured on the H100,
// PERF.md).
//
// Forward.  One warp a destination row.  Lane j < K holds slot j's clipped id
// (or -1 where masked), loaded once; the count is one ballot.  The lanes span
// D in 16-byte float4 columns (D=256: two a lane).  K = 4 and 8 (the step's)
// are compiled for that K, with the slots unrolled; any other K walks its
// slots 8 at a time.  Every slot's loads are unconditional (a masked slot
// reads row 0 and is zeroed by a select), so no branch orders them and
// ptxas schedules them freely; at its own register choice it interleaves
// them with the adds and keeps 6 blocks an SM, which was faster than
// forcing all of a row's loads ahead of the adds (more registers, fewer
// blocks).  The sums are taken in ascending slot order and the row is
// written once, scaled by 1 / max(count, 1).
//
// Backward: no atomics, and bit-reproducible.  One warp owns one dh row u and
// writes it once (a row that no slot reads gets zeros, so dh needs no fill).
// Its slots come from a transpose of the gather: `order` lists slot
// positions grouped by the row they read, ascending within a row, and row
// u's entries are order[start[u] .. start[u+1]).  The gather's slot (b, k)
// is the entry off + b*K + k, and only the entries in [off, off + rows*K)
// are walked.  The dedup'd block forward hands over the sort its plan
// already made of a whole lower frontier (every gather that reads one table
// shares it, each with its own off), with `rows` the destination table's
// unique count: the padding rows' slots lie past it, and their cotangent is
// zero, so skipping them adds nothing but 0.0.  A caller without a plan
// sorts the clipped ids itself (ops/cuda/gather_mean.py: slot_transpose).
// A run longer than 32 entries is first narrowed to [off, off + rows*K) by
// a 32-way search (one load a lane a step); then the warp loads 32 entries
// at a time, each lane computes its slot's row b and 1 / count_b (one load of
// the mask row's words gives the slot's validity and the count), a ballot
// keeps the valid ones, and the cotangent rows of 2 valid slots at a time
// load together before they are added, in ascending slot order.  At most 42
// registers keep 6 blocks an SM: the 100,000-row table's rows have one or two
// slots each, so a row costs its chain of dependent loads, and more rows in
// flight is what shortens it.  Fixed order, no atomics: two runs give the
// same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // rows per block (one warp each)
constexpr int CH = 2;     // vector columns a lane holds per pass over the slots
constexpr int G = 8;      // forward, any K: slots whose loads issue together
constexpr int U = 2;      // backward: valid slots whose cotangent rows load together
constexpr int BWD_BLOCKS = 6;  // backward blocks resident an SM (at most 42 registers)

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  static __device__ __forceinline__ void fma(T& a, const T& b, float s) {
    a.x = fmaf(b.x, s, a.x); a.y = fmaf(b.y, s, a.y);
    a.z = fmaf(b.z, s, a.z); a.w = fmaf(b.w, s, a.w);
  }
  static __device__ __forceinline__ T scale(const T& a, float s) {
    return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
  static __device__ __forceinline__ void fma(T& a, const T& b, float s) { a = fmaf(b, s, a); }
  static __device__ __forceinline__ T scale(const T& a, float s) { return a * s; }
};

// Slot base+lane of the row at `row`: its clipped id, or -1 where masked or past K.
__device__ __forceinline__ int slot_id(const int* __restrict__ nbr,
                                       const uint8_t* __restrict__ mask, size_t row, int K,
                                       int base, int lane, int N) {
  const int k = base + lane;
  if (k >= K || !mask[row + k]) return -1;
  return min(max(nbr[row + k], 0), N - 1);
}

// KS: the K compiled for (4 or 8), or 0 for any K.
template <int VEC, int KS>
__global__ void __launch_bounds__(WARPS * 32)
gather_mean_fwd_kernel(const float* __restrict__ h, const int* __restrict__ nbr,
                       const uint8_t* __restrict__ mask, int N, int B, int K_, int D,
                       float* __restrict__ out) {
  using V = typename Vec<VEC>::T;
  constexpr int GS = KS ? KS : G;  // slots a group; 32 % GS == 0
  const int K = KS ? KS : K_;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave together
  const size_t row = (size_t)b * K;
  const int first = slot_id(nbr, mask, row, K, 0, lane, N);  // slots 0..31, loaded once
  int count = __popc(__ballot_sync(FULL, first >= 0));
  for (int base = 32; base < K; base += 32)
    count += __popc(__ballot_sync(FULL, slot_id(nbr, mask, row, K, base, lane, N) >= 0));
  const float inv = 1.f / fmaxf((float)count, 1.f);
  const int dv = D / VEC;
  const V* hv = reinterpret_cast<const V*>(h);
  V* ov = reinterpret_cast<V*>(out) + (size_t)b * dv;
  for (int c0 = 0; c0 < dv; c0 += 32 * CH) {
    V acc[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) acc[j] = Vec<VEC>::zero();
    for (int base = 0; base < K; base += 32) {
      const int mine = base == 0 ? first : slot_id(nbr, mask, row, K, base, lane, N);
      const int n = min(32, K - base);
      for (int s0 = 0; s0 < n; s0 += GS) {
        int id[GS];
#pragma unroll
        for (int i = 0; i < GS; ++i) id[i] = __shfl_sync(FULL, mine, s0 + i);
        V v[GS][CH];
#pragma unroll
        for (int i = 0; i < GS; ++i) {
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            const int c = c0 + lane + 32 * j;
            // Unconditional (a masked slot reads row 0), then zeroed: no branch.
            const V x = __ldg(hv + (size_t)max(id[i], 0) * dv + min(c, dv - 1));
            v[i][j] = (id[i] >= 0 && c < dv) ? x : Vec<VEC>::zero();
          }
        }
#pragma unroll
        for (int i = 0; i < GS; ++i) {
#pragma unroll
          for (int j = 0; j < CH; ++j) Vec<VEC>::add(acc[j], v[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < dv) ov[c] = Vec<VEC>::scale(acc[j], inv);
    }
  }
}

// Valid slots of the mask row at m (bool bytes); `words`: m is 4-byte aligned.
template <int KS>
__device__ __forceinline__ int mask_count(const uint8_t* __restrict__ m, int K, bool words) {
  int c = 0;
  if constexpr (KS != 0 && KS % 4 == 0) {
    if (words) {
#pragma unroll
      for (int j = 0; j < KS; j += 4)
        c += __popc(__ldg(reinterpret_cast<const unsigned*>(m + j)) & 0x01010101u);
      return c;
    }
  }
  for (int j = 0; j < K; ++j) c += __ldg(m + j);
  return c;
}

// Whether slot k of the mask row at m is valid and, where it is, the row's
// valid slots in `count`.  K = 4 or 8 on 4-byte-aligned rows: one load of
// the row's words gives both.
template <int KS>
__device__ __forceinline__ bool slot_valid(const uint8_t* __restrict__ m, int k, int K,
                                           bool words, int& count) {
  if constexpr (KS == 4 || KS == 8) {
    if (words) {
      unsigned w[KS / 4];
#pragma unroll
      for (int i = 0; i < KS / 4; ++i) w[i] = __ldg(reinterpret_cast<const unsigned*>(m) + i);
      count = 0;
#pragma unroll
      for (int i = 0; i < KS / 4; ++i) count += __popc(w[i] & 0x01010101u);
      const unsigned word = k >= 4 ? w[KS / 4 - 1] : w[0];
      return (word >> (8 * (k & 3))) & 0xffu;
    }
  }
  if (!__ldg(m + k)) return false;
  count = mask_count<KS>(m, K, words);
  return true;
}

// First index in [lo, hi) whose entry is >= key, or hi (a[lo..hi) ascending).
// 32 probes a step: a run of L entries takes ceil(log32 L) loads.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a, int lo, int hi,
                                                int key, int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int idx = lo + lane * step;
    const int n = __popc(__ballot_sync(FULL, idx < hi && __ldg(a + idx) < key));
    if (n == 0) return lo;
    hi = min(hi, lo + n * step);  // a[lo + n*step] >= key, where it exists
    lo += (n - 1) * step + 1;     // a[lo + (n-1)*step] < key
  }
  const int idx = lo + lane;
  return lo + __popc(__ballot_sync(FULL, idx < hi && __ldg(a + idx) < key));
}

template <int VEC, int KS>
__global__ void __launch_bounds__(WARPS * 32, BWD_BLOCKS)
gather_mean_bwd_kernel(const float* __restrict__ dout, const uint8_t* __restrict__ mask,
                       const int* __restrict__ order, const int* __restrict__ start,
                       const int* __restrict__ rows_dev, int off, int N, int B, int K_, int D,
                       float* __restrict__ dh) {
  using V = typename Vec<VEC>::T;
  const int K = KS ? KS : K_;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (u >= N) return;
  const int rows = rows_dev ? min(max(__ldg(rows_dev), 0), B) : B;
  const int first = off, last = off + rows * K;  // the entries this gather walks
  int lo = __ldg(start + u), hi = __ldg(start + u + 1);
  if (hi - lo > 32) {
    lo = warp_lower_bound(order, lo, hi, first, lane);
    hi = warp_lower_bound(order, lo, hi, last, lane);
  }
  const bool words = (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  const int dv = D / VEC;
  const V* gv = reinterpret_cast<const V*>(dout);
  V* dv_row = reinterpret_cast<V*>(dh) + (size_t)u * dv;
  for (int c0 = 0; c0 < dv; c0 += 32 * CH) {
    V acc[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) acc[j] = Vec<VEC>::zero();
    for (int j0 = lo; j0 < hi; j0 += 32) {
      // This lane's entry: its cotangent row b and 1 / count_b, if valid.
      const int e = j0 + lane;
      int b = 0;
      float inv = 0.f;
      bool ok = false;
      if (e < hi) {
        const int p = __ldg(order + e);
        if (p >= first && p < last) {
          const int q = p - off;
          b = q / K;
          const uint8_t* m = mask + (size_t)b * K;
          int cnt = 1;
          ok = slot_valid<KS>(m, q - b * K, K, words, cnt);
          if (ok) inv = 1.f / (float)cnt;
        }
      }
      unsigned bits = __ballot_sync(FULL, ok);
      while (bits) {  // up to U valid slots a round, lowest lane (slot) first
        int src[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          src[i] = bits ? __ffs(bits) - 1 : -1;
          bits &= bits - 1;
        }
        int rb[U];
        float rs[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          rb[i] = __shfl_sync(FULL, b, src[i] & 31);
          rs[i] = __shfl_sync(FULL, inv, src[i] & 31);
        }
        V v[U][CH];  // the round's cotangent rows in flight before the first add
#pragma unroll
        for (int i = 0; i < U; ++i) {
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            const int c = c0 + lane + 32 * j;
            v[i][j] = Vec<VEC>::zero();
            if (src[i] >= 0 && c < dv) v[i][j] = __ldg(gv + (size_t)rb[i] * dv + c);
          }
        }
#pragma unroll
        for (int i = 0; i < U; ++i) {
          if (src[i] < 0) break;  // the same for the whole warp
#pragma unroll
          for (int j = 0; j < CH; ++j) Vec<VEC>::fma(acc[j], v[i][j], rs[i]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < dv) dv_row[c] = acc[j];
    }
  }
}

template <int VEC_, int KS_>
struct Cfg {
  static constexpr int VEC = VEC_, KS = KS_;
};

// Calls f(Cfg<VEC, KS>{}) for the float4 or scalar path and K = 8, 4 or any.
template <typename F>
void dispatch(int vec4, int K, F&& f) {
  if (vec4) {
    if (K == 8) f(Cfg<4, 8>{});
    else if (K == 4) f(Cfg<4, 4>{});
    else f(Cfg<4, 0>{});
  } else {
    if (K == 8) f(Cfg<1, 8>{});
    else if (K == 4) f(Cfg<1, 4>{});
    else f(Cfg<1, 0>{});
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vec4: D % 4 == 0 and every pointer 16-byte aligned (the wrapper decides).
int gather_mean_fwd_launch(const void* h, const void* nbr, const void* mask, int N, int B,
                           int K, int D, int vec4, void* out, void* stream) {
  const dim3 grid((B + WARPS - 1) / WARPS);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* hp = static_cast<const float*>(h);
  const auto* ip = static_cast<const int*>(nbr);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* op = static_cast<float*>(out);
  dispatch(vec4, K, [&](auto cfg) {
    using C = decltype(cfg);
    gather_mean_fwd_kernel<C::VEC, C::KS><<<grid, WARPS * 32, 0, s>>>(hp, ip, mp, N, B, K, D, op);
  });
  return (int)cudaGetLastError();
}

// dh [N, D] from dout [B, D], the mask [B, K] and the transpose: order [L]
// and start [N + 1] int32, the gather's first entry `off`, and `rows` (an
// int32 on the device, or null for B): the entries walked are
// [off, off + rows*K).  Every row of dh is written.
int gather_mean_bwd_launch(const void* dout, const void* mask, const void* order,
                           const void* start, const void* rows, int off, int N, int B, int K,
                           int D, int vec4, void* dh, void* stream) {
  const dim3 grid((N + WARPS - 1) / WARPS);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float*>(dout);
  const auto* mp = static_cast<const uint8_t*>(mask);
  const auto* op = static_cast<const int*>(order);
  const auto* sp = static_cast<const int*>(start);
  const auto* rp = static_cast<const int*>(rows);
  auto* dp = static_cast<float*>(dh);
  dispatch(vec4, K, [&](auto cfg) {
    using C = decltype(cfg);
    gather_mean_bwd_kernel<C::VEC, C::KS><<<grid, WARPS * 32, 0, s>>>(gp, mp, op, sp, rp, off,
                                                                      N, B, K, D, dp);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
