// Neighbour gather + masked mean, forward and backward, for Hopper (sm_90a).
//
// Replaces gather_mean_pallas of gnn_recsys_tpu/ops/pallas/gather_mean.py
// (_kernel, gather_mean.py:49), the csc_gather_mean contract without edge
// weights:
//
//   out[b] = sum_k m[b,k] * h[clip(nbr[b,k])] / max(sum_k m[b,k], 1)
//
// h [N, D] f32 or bf16 is a source table, nbr [B, K] int32 row ids (clipped
// into [0, N-1]), m [B, K] uint8 the validity mask; a row with no valid slot
// gives zeros.  The dedup'd block forward runs it on every mean of its
// bottom-up pass (the table is transform_src of the unique nodes of the level
// below), in the model's computation dtype.  Both element types sum in f32.
// In bf16 the forward rounds each sum to bf16 and then divides by the count,
// as the TPU kernel's bf16 sum and division do, and the backward rounds each
// row of dh once; the plain versions do the same.  Each kernel is a template
// on the element type T and on the elements VEC of one load: 16 bytes (4 f32
// or 8 bf16) where D and the pointers allow, else one.
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
// K=8, N=30,000, D=256) moves about 72 MB in f32 and half that in bf16,
// 0.022 ms (0.011 ms) at 3.35 TB/s; reading every valid slot's row from
// device memory would be about 319 MB in f32.  A table that fits in the 50 MB
// L2 serves its repeated rows from L2, so the time lies between the two
// readings and the L2's rate sets it; a larger table (the step's 100,000-row
// one, 102 MB) reads from device memory.  The backward moves the same bytes
// the other way.  Neither kernel's warp has much to do, so both are held by
// how many dependent loads are in flight on an SM, and by the longest chain
// of them that one warp walks: a call ends with its slowest warp.
//
// That second limit is what full-fanout gathers meet (K = 16 to 1,280: the
// search's trials and the uncapped rows of the CLI drill).  There a row of the
// table can be read by a thousand slots, and the dedup'd plan sends every
// masked slot of a gather to one row (the lower table's entry for the
// padding id): at (B, K, N) = (904, 1,280, 3,000) that row's run holds about
// 917,000 entries, almost all masked.  One warp walking it took 13.4 ms on
// the H100, at a bound of 0.003 ms; the same warp also recounted a slot's
// whole mask row for each valid slot.  The design below bounds the entries
// any one warp walks.
// On an H100 80GB HBM3 at 700 W (gather_times.py, on the drill's and the
// search's own plans), the backward at (904, 1,280, 3,000, 256) went from
// 13.41 to 0.0326 ms and at (20,000, 16, 6,000, 256) from 1.27 to 0.076 ms;
// the forward at (904, 1,280, 3,000, 256) from 0.135 to 0.030 ms.
//
// Forward, K <= 32.  One warp a destination row.  Lane j < K holds slot j's
// clipped id (or -1 where masked), loaded once; the count is one ballot.  The
// lanes span D in 16-byte columns (D=256: two float4 a lane in f32, one load
// of 8 bf16 a lane in bf16), each widened to f32 as it is added.  K = 4 and 8
// (the step's) are compiled for that K, with the slots unrolled; any other K
// walks its slots 8 at a time.  Every slot's loads are unconditional (a masked
// slot reads row 0 and is zeroed by a select), so no branch orders them and
// ptxas schedules them freely; at its own register choice it interleaves them
// with the adds and keeps 6 blocks an SM, which was faster than forcing all of
// a row's loads ahead of the adds (more registers, fewer blocks).  The sums
// are taken in ascending slot order and the row is written once, scaled by
// 1 / max(count, 1).
//
// Forward, K > 32.  One block a destination row, its 8 warps each taking a
// contiguous run of 32-slot groups.  A group's ballot compacts its valid
// slots, and only their rows load (4 at a time), so a row of 1,280 slots with
// 100 valid ones loads 100 rows, not 1,280.  Each warp sums its slots in
// ascending order; the partials meet in shared memory and are added in warp
// order, so the whole row is summed in ascending slot order of the runs.
//
// Backward: no atomics, and bit-reproducible.  dh[u] sums the cotangent rows
// of the slots that read row u, each scaled by 1 / max(count_b, 1), in
// ascending slot order, and is written once (a row that no slot reads gets
// zeros, so dh needs no fill).  Its slots come from a transpose of the
// gather: `order` lists slot positions grouped by the row they read,
// ascending within a row, and row u's entries are order[start[u] ..
// start[u+1]).  The gather's slot (b, k) is the entry off + b*K + k, and only
// the entries in [off, off + rows*K) are walked.  The dedup'd block forward
// hands over the sort its plan already made of a whole lower frontier (every
// gather that reads one table shares it, each with its own off), with `rows`
// the destination table's unique count: the padding rows' slots lie past it,
// and their cotangent is zero, so skipping them adds nothing but 0.0.  A
// caller without a plan sorts the clipped ids itself (ops/cuda/gather_mean.py:
// slot_transpose).
//
// Backward, K = 4 and 8 (the training step's gathers, whose rows have one or
// two slots each).  One warp owns one dh row.  A run longer than 32 entries
// is first narrowed to [off, off + rows*K) by a 32-way search (one load a
// lane a step); then the warp loads 32 entries at a time, each lane computes
// its slot's row b and 1 / count_b (one load of the mask row's words gives
// the slot's validity and the count), a ballot keeps the valid ones, and the
// cotangent rows of 2 valid slots at a time load together before they are
// added, in ascending slot order.  At most 42 registers keep 6 blocks an SM:
// a row costs its chain of dependent loads, and more rows in flight is what
// shortens it.
//
// Backward, any other K: four kernels, every grid and scratch size fixed by
// B*K, N and CHUNK, so that a CUDA graph can capture the call.
//   1. prep: one warp per destination row b computes 1 / max(count_b, 1)
//      once (word loads and __popc), and one warp per table row u narrows
//      its run to [off, off + rows*K) and counts its chunks:
//      max(1, ceil(len / CHUNK)).
//   2. scan: one block turns the chunk counts into each row's first chunk
//      slot; at most N + ceil(B*K / CHUNK) slots.
//   3. walk: one warp per chunk slot finds its row by a 32-way search of the
//      scan, loads its CHUNK entries, their mask bytes and their scales up
//      front (each slot's validity one byte, its scale one load), and adds
//      the valid slots' cotangent rows, 2 at a time, in ascending order.  A
//      row of one chunk is written there; a longer row's chunks write f32
//      partials (and a flag where any slot was valid).
//   4. reduce: one warp per row of several chunks adds the flagged partials
//      in chunk order and writes the row once (in bf16 rounded once).
// A warp so walks at most CHUNK entries whatever the skew, the masked row's
// 917,000 entries included.  Fixed order, no atomics: two runs give the same
// bits, and a row of one chunk is summed as one warp walking its whole run
// would sum it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // rows per block (one warp each)
constexpr int G = 8;      // forward, any K: slots whose loads issue together
constexpr int U = 2;      // backward: valid slots whose cotangent rows load together
constexpr int BWD_BLOCKS = 6;  // backward blocks resident an SM (at most 42 registers)
constexpr int CHUNK = 128;         // backward, any K: entries one warp walks
constexpr int STEPS = CHUNK / 32;  // its loads of 32 entries, issued together
static_assert(CHUNK % 32 == 0 && CHUNK >= 32, "a chunk is whole loads of 32 entries");
constexpr int WALK_BLOCKS = 4;     // walk blocks resident an SM (at most 64 registers)
constexpr int RU = 4;              // reduce: partial rows that load together
constexpr int FL = 8;              // reduce: flag loads a lane issues together
constexpr int GW = 4;              // forward, K > 32: valid slots whose rows load together
constexpr int SCAN_THREADS = 1024;

using bf16 = __nv_bfloat16;

// One load of a table or cotangent row: VEC elements of T (16 bytes on the
// vector path: 4 f32 or 8 bf16; one element on the scalar path), and its
// f32 view.  Sums are f32; a bf16 result is rounded once, to nearest even.
template <typename T, int VEC>
struct Pack;
template <>
struct Pack<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[4]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  static __device__ __forceinline__ Raw narrow(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Pack<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw zero() { return 0.f; }
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[1]) { f[0] = r; }
  static __device__ __forceinline__ Raw narrow(const float (&f)[1]) { return f[0]; }
};
template <>
struct Pack<bf16, 8> {
  using Raw = uint4;  // 4 words of 2 bf16, the lower address in the low half
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ Raw narrow(const float (&f)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&two);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Pack<bf16, 1> {
  using Raw = bf16;
  static __device__ __forceinline__ Raw zero() { return __float2bfloat16_rn(0.f); }
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[1]) {
    f[0] = __bfloat162float(r);
  }
  static __device__ __forceinline__ Raw narrow(const float (&f)[1]) {
    return __float2bfloat16_rn(f[0]);
  }
};

// acc += widen(r); fma_scaled: acc += widen(r) * s, one fused multiply-add.
template <typename T, int VEC>
__device__ __forceinline__ void add(float (&acc)[VEC], const typename Pack<T, VEC>::Raw& r) {
  float f[VEC];
  Pack<T, VEC>::widen(r, f);
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] += f[e];
}
template <typename T, int VEC>
__device__ __forceinline__ void fma_scaled(float (&acc)[VEC], const typename Pack<T, VEC>::Raw& r,
                                           float s) {
  float f[VEC];
  Pack<T, VEC>::widen(r, f);
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = fmaf(f[e], s, acc[e]);
}

// An f32 partial of VEC columns, stored and loaded (16-byte aligned where VEC > 1).
template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    *p = f[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}
template <int VEC>
__device__ __forceinline__ void add_f32(float (&acc)[VEC], const float* __restrict__ p) {
  if constexpr (VEC == 1) {
    acc[0] += __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p + i));
      acc[i] += x.x; acc[i + 1] += x.y; acc[i + 2] += x.z; acc[i + 3] += x.w;
    }
  }
}

// The lowest N set bits of `bits` (lanes, in ascending order), taken off it;
// -1 past the last.
template <int N>
__device__ __forceinline__ void take(unsigned& bits, int (&src)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    src[i] = bits ? __ffs(bits) - 1 : -1;
    bits &= bits - 1;
  }
}

// The mean of one column from its f32 sum, before the output's rounding:
// f32 multiplies by 1 / max(count, 1); bf16 rounds the sum to bf16 and
// divides, as the TPU kernel's bf16 sum and division do
// (ops/pallas/gather_mean.py:68-70).
template <typename T>
__device__ __forceinline__ float mean_of(float sum, float count, float inv);
template <>
__device__ __forceinline__ float mean_of<float>(float sum, float, float inv) {
  return sum * inv;
}
template <>
__device__ __forceinline__ float mean_of<bf16>(float sum, float count, float) {
  return __bfloat162float(__float2bfloat16_rn(sum)) / count;
}

// Loads a lane holds per pass over the slots: a warp's pass spans 256
// elements on the vector path (f32: 2 float4 a lane; bf16: one 8-element
// load a lane), 64 on the scalar path.
template <int VEC>
__host__ __device__ constexpr int chunks() { return VEC == 8 ? 1 : 2; }

// Slot base+lane of the row at `row`: its clipped id, or -1 where masked or past K.
__device__ __forceinline__ int slot_id(const int* __restrict__ nbr,
                                       const uint8_t* __restrict__ mask, size_t row, int K,
                                       int base, int lane, int N) {
  const int k = base + lane;
  if (k >= K || !mask[row + k]) return -1;
  return min(max(nbr[row + k], 0), N - 1);
}

// K <= 32, one warp a destination row.  T: the element type (f32 or bf16);
// VEC: elements a load; KS: the K compiled for (4 or 8), or 0 for any K.
template <typename T, int VEC, int KS>
__global__ void __launch_bounds__(WARPS * 32)
gather_mean_fwd_kernel(const T* __restrict__ h, const int* __restrict__ nbr,
                       const uint8_t* __restrict__ mask, int N, int B, int K_, int D,
                       T* __restrict__ out) {
  using P = Pack<T, VEC>;
  using V = typename P::Raw;
  constexpr int CH = chunks<VEC>();
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
  const float cnt = fmaxf((float)count, 1.f), inv = 1.f / cnt;
  const int dv = D / VEC;
  const V* hv = reinterpret_cast<const V*>(h);
  V* ov = reinterpret_cast<V*>(out) + (size_t)b * dv;
  for (int c0 = 0; c0 < dv; c0 += 32 * CH) {
    float acc[CH][VEC] = {};
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
            v[i][j] = (id[i] >= 0 && c < dv) ? x : P::zero();
          }
        }
#pragma unroll
        for (int i = 0; i < GS; ++i) {
#pragma unroll
          for (int j = 0; j < CH; ++j) add<T, VEC>(acc[j], v[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < dv) {
        float f[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = mean_of<T>(acc[j][e], cnt, inv);
        ov[c] = P::narrow(f);
      }
    }
  }
}

// K > 32: one block a destination row; warp w sums the valid slots of its
// contiguous run of 32-slot groups, GW rows at a time, in ascending order; the
// warps' partials are added through shared memory in warp order.
template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
gather_mean_fwd_wide_kernel(const T* __restrict__ h, const int* __restrict__ nbr,
                            const uint8_t* __restrict__ mask, int N, int K, int D,
                            T* __restrict__ out) {
  using P = Pack<T, VEC>;
  using V = typename P::Raw;
  constexpr int CH = chunks<VEC>();
  constexpr int PASS = 32 * CH * VEC;  // elements a pass over the columns
  static_assert(PASS <= WARPS * 32, "one element a thread in the final add");
  __shared__ float part[WARPS][PASS];
  __shared__ int counts[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const size_t row = (size_t)b * K;
  const int groups = (K + 31) / 32;
  const int g0 = warp * groups / WARPS, g1 = (warp + 1) * groups / WARPS;
  int count = 0;
  for (int g = g0; g < g1; ++g)
    count += __popc(__ballot_sync(FULL, slot_id(nbr, mask, row, K, 32 * g, lane, N) >= 0));
  if (lane == 0) counts[warp] = count;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += counts[w];
  const float cnt = fmaxf((float)total, 1.f), inv = 1.f / cnt;
  const int dv = D / VEC;
  const V* hv = reinterpret_cast<const V*>(h);
  for (int c0 = 0; c0 < dv; c0 += 32 * CH) {
    float acc[CH][VEC] = {};
    for (int g = g0; g < g1; ++g) {
      const int mine = slot_id(nbr, mask, row, K, 32 * g, lane, N);
      unsigned left = __ballot_sync(FULL, mine >= 0);
      while (left) {  // up to GW valid slots a round, lowest slot first
        int src[GW];
        take<GW>(left, src);
        int id[GW];
#pragma unroll
        for (int i = 0; i < GW; ++i) id[i] = __shfl_sync(FULL, mine, src[i] & 31);
        V v[GW][CH];  // the round's rows in flight before the first add
#pragma unroll
        for (int i = 0; i < GW; ++i) {
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            const int c = c0 + lane + 32 * j;
            v[i][j] = P::zero();
            if (src[i] >= 0 && c < dv) v[i][j] = __ldg(hv + (size_t)id[i] * dv + c);
          }
        }
#pragma unroll
        for (int i = 0; i < GW; ++i) {
          if (src[i] < 0) break;  // the same for the whole warp
#pragma unroll
          for (int j = 0; j < CH; ++j) add<T, VEC>(acc[j], v[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[warp][(lane + 32 * j) * VEC + e] = acc[j][e];
    }
    __syncthreads();
    const int t = threadIdx.x, col = c0 * VEC + t;
    if (t < PASS && col < D) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += part[w][t];
      const float f[1] = {mean_of<T>(sum, cnt, inv)};
      out[(size_t)b * D + col] = Pack<T, 1>::narrow(f);
    }
    __syncthreads();  // part is reused by the next pass
  }
}

// Whether slot k of the mask row at m (KS = 4 or 8 slots) is valid and,
// where it is, the row's valid slots in `count`.  On 4-byte-aligned rows
// (`words`) one load of the row's words gives both.
template <int KS>
__device__ __forceinline__ bool slot_valid(const uint8_t* __restrict__ m, int k, bool words,
                                           int& count) {
  static_assert(KS == 4 || KS == 8, "the warp-a-row backward is compiled for K = 4 and 8");
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
  if (!__ldg(m + k)) return false;
  count = 0;
#pragma unroll
  for (int j = 0; j < KS; ++j) count += __ldg(m + j);
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

// K = KS = 4 or 8, one warp a table row.
template <typename T, int VEC, int KS>
__global__ void __launch_bounds__(WARPS * 32, BWD_BLOCKS)
gather_mean_bwd_kernel(const T* __restrict__ dout, const uint8_t* __restrict__ mask,
                       const int* __restrict__ order, const int* __restrict__ start,
                       const int* __restrict__ rows_dev, int off, int N, int B, int D,
                       T* __restrict__ dh) {
  using P = Pack<T, VEC>;
  using V = typename P::Raw;
  constexpr int CH = chunks<VEC>();
  constexpr int K = KS;
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
    float acc[CH][VEC] = {};
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
          ok = slot_valid<KS>(m, q - b * K, words, cnt);
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
            v[i][j] = P::zero();
            if (src[i] >= 0 && c < dv) v[i][j] = __ldg(gv + (size_t)rb[i] * dv + c);
          }
        }
#pragma unroll
        for (int i = 0; i < U; ++i) {
          if (src[i] < 0) break;  // the same for the whole warp
#pragma unroll
          for (int j = 0; j < CH; ++j) fma_scaled<T, VEC>(acc[j], v[i][j], rs[i]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < dv) dv_row[c] = P::narrow(acc[j]);
    }
  }
}

// The any-K backward's scratch, carved from one buffer (bwd_layout): per
// destination row its scale; per table row its narrowed run [lo, hi) and its
// first chunk slot (cstart[N]: the slots used); per chunk slot a flag (any
// valid slot) and an f32 partial row.
struct Plan {
  float* inv;
  int* lo;
  int* hi;
  int* cstart;
  int* flag;
  float* partial;
};

// 1 / max(count_b, 1) for each destination row b < B (one warp each; word
// loads where the mask's rows are 4-byte aligned), and for each table row u
// < N its run narrowed to [off, off + rows*K) and its chunk count
// max(1, ceil(len / CHUNK)), into cstart[u] for the scan.
__global__ void __launch_bounds__(WARPS * 32)
gather_mean_bwd_prep_kernel(const uint8_t* __restrict__ mask, const int* __restrict__ order,
                            const int* __restrict__ start, const int* __restrict__ rows_dev,
                            const Plan plan, int off, int N, int B, int K) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w < B) {
    const uint8_t* m = mask + (size_t)w * K;
    int c = 0;
    if ((K & 3) == 0 && (reinterpret_cast<uintptr_t>(mask) & 3) == 0) {
      const unsigned* mw = reinterpret_cast<const unsigned*>(m);
      for (int i = lane; i < K / 4; i += 32) c += __popc(__ldg(mw + i) & 0x01010101u);
    } else {
      for (int i = lane; i < K; i += 32) c += __ldg(m + i);
    }
    c = __reduce_add_sync(FULL, c);
    if (lane == 0) plan.inv[w] = 1.f / (float)max(c, 1);
  }
  if (w < N) {
    const int rows = rows_dev ? min(max(__ldg(rows_dev), 0), B) : B;
    int lo = __ldg(start + w), hi = __ldg(start + w + 1);
    lo = warp_lower_bound(order, lo, hi, off, lane);
    hi = warp_lower_bound(order, lo, hi, off + rows * K, lane);
    if (lane == 0) {
      plan.lo[w] = lo;
      plan.hi[w] = hi;
      plan.cstart[w] = max(1, (hi - lo + CHUNK - 1) / CHUNK);
    }
  }
}

// One block: the chunk counts cstart[0..N) become their exclusive prefix
// sums, and cstart[N] the total (each thread a contiguous run of rows).
__global__ void __launch_bounds__(SCAN_THREADS)
gather_mean_bwd_scan_kernel(int* __restrict__ cstart, int N) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (N + SCAN_THREADS - 1) / SCAN_THREADS;
  const int a = min(t * per, N), e = min(a + per, N);
  int sum = 0;
  for (int i = a; i < e; ++i) sum += cstart[i];
  int x = sum;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    warp_sum[lane] = s;
  }
  __syncthreads();
  int run = x - sum + (warp ? warp_sum[warp - 1] : 0);
  for (int i = a; i < e; ++i) {
    const int v = cstart[i];
    cstart[i] = run;
    run += v;
  }
  if (t == SCAN_THREADS - 1) cstart[N] = run;
}

// One warp a chunk slot j < cstart[N]: row u and its chunk j - cstart[u],
// whose CHUNK entries (STEPS loads of 32) are loaded with their mask bytes
// and scales before any cotangent row; then the valid slots' rows, U at a
// time, in ascending order.  A row of one chunk is written here; otherwise
// the chunk's f32 partial (where any slot was valid) and its flag.
template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32, WALK_BLOCKS)
gather_mean_bwd_walk_kernel(const T* __restrict__ dout, const uint8_t* __restrict__ mask,
                            const int* __restrict__ order, const Plan plan, int off, int N,
                            int K, int D, int slots, T* __restrict__ dh) {
  using P = Pack<T, VEC>;
  using V = typename P::Raw;
  constexpr int CH = chunks<VEC>();
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (j >= slots || j >= __ldg(plan.cstart + N)) return;  // whole warps leave together
  const int u = warp_lower_bound(plan.cstart, 0, N, j + 1, lane) - 1;  // cstart[u] <= j
  const int first = __ldg(plan.cstart + u), nch = __ldg(plan.cstart + u + 1) - first;
  const int lo = __ldg(plan.lo + u) + (j - first) * CHUNK;
  const int hi = min(lo + CHUNK, __ldg(plan.hi + u));
  int q[STEPS];  // this lane's entries' slot positions, -1 past the chunk
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int e = lo + 32 * s + lane;
    q[s] = e < hi ? __ldg(order + e) - off : -1;
  }
  bool valid[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) valid[s] = q[s] >= 0 && __ldg(mask + q[s]);
  int rb[STEPS];
  float rs[STEPS];
  unsigned bits[STEPS];
  unsigned any = 0;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    rb[s] = valid[s] ? q[s] / K : 0;
    rs[s] = valid[s] ? __ldg(plan.inv + rb[s]) : 0.f;
    bits[s] = __ballot_sync(FULL, valid[s]);
    any |= bits[s];
  }
  const int dv = D / VEC;
  const V* gv = reinterpret_cast<const V*>(dout);
  for (int c0 = 0; c0 < dv; c0 += 32 * CH) {
    float acc[CH][VEC] = {};
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      unsigned left = bits[s];
      while (left) {  // up to U valid slots a round, lowest entry first
        int src[U];
        take<U>(left, src);
        int b[U];
        float sc[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          b[i] = __shfl_sync(FULL, rb[s], src[i] & 31);
          sc[i] = __shfl_sync(FULL, rs[s], src[i] & 31);
        }
        V v[U][CH];  // the round's cotangent rows in flight before the first add
#pragma unroll
        for (int i = 0; i < U; ++i) {
#pragma unroll
          for (int jj = 0; jj < CH; ++jj) {
            const int c = c0 + lane + 32 * jj;
            v[i][jj] = P::zero();
            if (src[i] >= 0 && c < dv) v[i][jj] = __ldg(gv + (size_t)b[i] * dv + c);
          }
        }
#pragma unroll
        for (int i = 0; i < U; ++i) {
          if (src[i] < 0) break;  // the same for the whole warp
#pragma unroll
          for (int jj = 0; jj < CH; ++jj) fma_scaled<T, VEC>(acc[jj], v[i][jj], sc[i]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      const int c = c0 + lane + 32 * jj;
      if (c >= dv) continue;
      if (nch == 1)
        reinterpret_cast<V*>(dh)[(size_t)u * dv + c] = P::narrow(acc[jj]);
      else if (any)
        store_f32<VEC>(plan.partial + (size_t)j * D + (size_t)c * VEC, acc[jj]);
    }
  }
  if (nch > 1 && lane == 0) plan.flag[j] = any != 0;
}

// One warp a table row of several chunks: the flagged partials added in
// chunk order (RU rows in flight), the row written once.
template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
gather_mean_bwd_reduce_kernel(const Plan plan, int N, int D, T* __restrict__ dh) {
  using P = Pack<T, VEC>;
  using V = typename P::Raw;
  constexpr int CH = chunks<VEC>();
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (u >= N) return;
  const int j0 = __ldg(plan.cstart + u), j1 = __ldg(plan.cstart + u + 1);
  if (j1 - j0 < 2) return;  // written by the walk
  const int dv = D / VEC;
  for (int c0 = 0; c0 < dv; c0 += 32 * CH) {
    float acc[CH][VEC] = {};
    for (int base = j0; base < j1; base += 32 * FL) {
      int f[FL];
#pragma unroll
      for (int i = 0; i < FL; ++i) {
        const int e = base + 32 * i + lane;
        f[i] = e < j1 ? __ldg(plan.flag + e) : 0;
      }
#pragma unroll
      for (int i = 0; i < FL; ++i) {
        unsigned left = __ballot_sync(FULL, f[i] != 0);
        while (left) {
          int src[RU];
          take<RU>(left, src);
          float x[RU][CH][VEC] = {};
#pragma unroll
          for (int r = 0; r < RU; ++r) {
#pragma unroll
            for (int jj = 0; jj < CH; ++jj) {
              const int c = c0 + lane + 32 * jj;
              if (src[r] >= 0 && c < dv)
                add_f32<VEC>(x[r][jj], plan.partial + (size_t)(base + 32 * i + src[r]) * D +
                                           (size_t)c * VEC);
            }
          }
#pragma unroll
          for (int r = 0; r < RU; ++r) {
            if (src[r] < 0) break;
#pragma unroll
            for (int jj = 0; jj < CH; ++jj) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[jj][e] += x[r][jj][e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      const int c = c0 + lane + 32 * jj;
      if (c < dv) reinterpret_cast<V*>(dh)[(size_t)u * dv + c] = P::narrow(acc[jj]);
    }
  }
}

// The chunk slots of an any-K backward: every row gets at least one, and a
// row's narrowed run (at most rows*K entries over all rows) one more for each
// CHUNK entries.
long long chunk_slots(int N, int B, int K) {
  return (long long)N + ((long long)B * K + CHUNK - 1) / CHUNK;
}

struct Layout {
  long long inv, lo, hi, cstart, flag, partial, bytes;
};

// The any-K backward's scratch layout in bytes (ops/cuda/gather_mean.py:
// bwd_scratch_bytes mirrors its size).
Layout bwd_layout(int N, int B, int K, int D) {
  const long long slots = chunk_slots(N, B, K);
  Layout l;
  long long o = 0;
  l.inv = o;
  o += 4LL * B;
  l.lo = o;
  o += 4LL * N;
  l.hi = o;
  o += 4LL * N;
  l.cstart = o;
  o += 4LL * (N + 1);
  l.flag = o;
  o += 4LL * slots;
  o = (o + 15) / 16 * 16;
  l.partial = o;
  o += 4LL * slots * D;
  l.bytes = o;
  return l;
}

template <typename T_, int VEC_>
struct Cfg {
  using T = T_;
  static constexpr int VEC = VEC_;
};

// Calls f(Cfg<T, VEC>{}) for f32 or bf16 and the 16-byte or scalar path.
template <typename F>
void dispatch(int bf16_, int vec, F&& f) {
  if (bf16_) {
    if (vec) f(Cfg<bf16, 8>{});
    else f(Cfg<bf16, 1>{});
  } else {
    if (vec) f(Cfg<float, 4>{});
    else f(Cfg<float, 1>{});
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vec: D a multiple of a 16-byte load's elements and every pointer 16-byte
// aligned (the wrapper decides); bf16: h and out are bf16, else f32.
int gather_mean_fwd_launch(const void* h, const void* nbr, const void* mask, int N, int B,
                           int K, int D, int vec, int bf16_, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ip = static_cast<const int*>(nbr);
  const auto* mp = static_cast<const uint8_t*>(mask);
  dispatch(bf16_, vec, [&](auto cfg) {
    using T = typename decltype(cfg)::T;
    constexpr int VEC = decltype(cfg)::VEC;
    const auto* hp = static_cast<const T*>(h);
    auto* op = static_cast<T*>(out);
    const dim3 grid((B + WARPS - 1) / WARPS);
    if (K > 32)
      gather_mean_fwd_wide_kernel<T, VEC><<<B, WARPS * 32, 0, s>>>(hp, ip, mp, N, K, D, op);
    else if (K == 8)
      gather_mean_fwd_kernel<T, VEC, 8><<<grid, WARPS * 32, 0, s>>>(hp, ip, mp, N, B, K, D, op);
    else if (K == 4)
      gather_mean_fwd_kernel<T, VEC, 4><<<grid, WARPS * 32, 0, s>>>(hp, ip, mp, N, B, K, D, op);
    else
      gather_mean_fwd_kernel<T, VEC, 0><<<grid, WARPS * 32, 0, s>>>(hp, ip, mp, N, B, K, D, op);
  });
  return (int)cudaGetLastError();
}

// Entries one warp of the any-K backward walks.
int gather_mean_bwd_chunk() { return CHUNK; }

// Bytes of scratch the backward needs at these shapes (0 at K = 4 and 8).
long long gather_mean_bwd_scratch_bytes(int N, int B, int K, int D) {
  return (K == 4 || K == 8) ? 0 : bwd_layout(N, B, K, D).bytes;
}

// dh [N, D] from dout [B, D], the mask [B, K] and the transpose: order [L]
// and start [N + 1] int32, the gather's first entry `off`, and `rows` (an
// int32 on the device, or null for B): the entries walked are
// [off, off + rows*K).  Every row of dh is written.  bf16: dout and dh are
// bf16, else f32.  scratch: gather_mean_bwd_scratch_bytes(N, B, K, D) bytes,
// 16-byte aligned (unused at K = 4 and 8).
int gather_mean_bwd_launch(const void* dout, const void* mask, const void* order,
                           const void* start, const void* rows, int off, int N, int B, int K,
                           int D, int vec, int bf16_, void* dh, void* scratch, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* mp = static_cast<const uint8_t*>(mask);
  const auto* op = static_cast<const int*>(order);
  const auto* sp = static_cast<const int*>(start);
  const auto* rp = static_cast<const int*>(rows);
  int err = 0;
  dispatch(bf16_, vec, [&](auto cfg) {
    using T = typename decltype(cfg)::T;
    constexpr int VEC = decltype(cfg)::VEC;
    const auto* gp = static_cast<const T*>(dout);
    auto* hp = static_cast<T*>(dh);
    const dim3 rows_grid((N + WARPS - 1) / WARPS);
    if (K == 8 || K == 4) {
      if (K == 8)
        gather_mean_bwd_kernel<T, VEC, 8><<<rows_grid, WARPS * 32, 0, s>>>(
            gp, mp, op, sp, rp, off, N, B, D, hp);
      else
        gather_mean_bwd_kernel<T, VEC, 4><<<rows_grid, WARPS * 32, 0, s>>>(
            gp, mp, op, sp, rp, off, N, B, D, hp);
      err = (int)cudaGetLastError();
      return;
    }
    const Layout l = bwd_layout(N, B, K, D);
    char* base = static_cast<char*>(scratch);
    const Plan plan{reinterpret_cast<float*>(base + l.inv), reinterpret_cast<int*>(base + l.lo),
                    reinterpret_cast<int*>(base + l.hi), reinterpret_cast<int*>(base + l.cstart),
                    reinterpret_cast<int*>(base + l.flag),
                    reinterpret_cast<float*>(base + l.partial)};
    const int slots = (int)chunk_slots(N, B, K);
    gather_mean_bwd_prep_kernel<<<(max(B, N) + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
        mp, op, sp, rp, plan, off, N, B, K);
    if ((err = (int)cudaGetLastError())) return;
    gather_mean_bwd_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(plan.cstart, N);
    if ((err = (int)cudaGetLastError())) return;
    gather_mean_bwd_walk_kernel<T, VEC><<<(slots + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
        gp, mp, op, plan, off, N, K, D, slots, hp);
    if ((err = (int)cudaGetLastError())) return;
    gather_mean_bwd_reduce_kernel<T, VEC><<<rows_grid, WARPS * 32, 0, s>>>(plan, N, D, hp);
    err = (int)cudaGetLastError();
  });
  return err;
}

}  // extern "C"
