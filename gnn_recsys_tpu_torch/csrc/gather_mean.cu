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
// device memory would be about 319 MB in f32.  A table
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
// D in 16-byte columns (D=256: two float4 a lane in f32, one load of 8 bf16
// a lane in bf16), each widened to f32 as it is added.  K = 4 and 8 (the step's)
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // rows per block (one warp each)
constexpr int G = 8;      // forward, any K: slots whose loads issue together
constexpr int U = 2;      // backward: valid slots whose cotangent rows load together
constexpr int BWD_BLOCKS = 6;  // backward blocks resident an SM (at most 42 registers)

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

// T: the element type (f32 or bf16); VEC: elements a load; KS: the K
// compiled for (4 or 8), or 0 for any K.
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

template <typename T, int VEC, int KS>
__global__ void __launch_bounds__(WARPS * 32, BWD_BLOCKS)
gather_mean_bwd_kernel(const T* __restrict__ dout, const uint8_t* __restrict__ mask,
                       const int* __restrict__ order, const int* __restrict__ start,
                       const int* __restrict__ rows_dev, int off, int N, int B, int K_, int D,
                       T* __restrict__ dh) {
  using P = Pack<T, VEC>;
  using V = typename P::Raw;
  constexpr int CH = chunks<VEC>();
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

template <typename T_, int VEC_, int KS_>
struct Cfg {
  using T = T_;
  static constexpr int VEC = VEC_, KS = KS_;
};

// Calls f(Cfg<T, VEC, KS>{}) for K = 8, 4 or any.
template <typename T, int VEC, typename F>
void dispatch_k(int K, F&& f) {
  if (K == 8) f(Cfg<T, VEC, 8>{});
  else if (K == 4) f(Cfg<T, VEC, 4>{});
  else f(Cfg<T, VEC, 0>{});
}

// Calls f(Cfg<T, VEC, KS>{}) for f32 or bf16, the 16-byte or scalar path,
// and K = 8, 4 or any.
template <typename F>
void dispatch(int bf16_, int vec, int K, F&& f) {
  if (bf16_) {
    if (vec) dispatch_k<bf16, 8>(K, f);
    else dispatch_k<bf16, 1>(K, f);
  } else {
    if (vec) dispatch_k<float, 4>(K, f);
    else dispatch_k<float, 1>(K, f);
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
  const dim3 grid((B + WARPS - 1) / WARPS);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ip = static_cast<const int*>(nbr);
  const auto* mp = static_cast<const uint8_t*>(mask);
  dispatch(bf16_, vec, K, [&](auto cfg) {
    using C = decltype(cfg);
    using T = typename C::T;
    gather_mean_fwd_kernel<T, C::VEC, C::KS><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const T*>(h), ip, mp, N, B, K, D, static_cast<T*>(out));
  });
  return (int)cudaGetLastError();
}

// dh [N, D] from dout [B, D], the mask [B, K] and the transpose: order [L]
// and start [N + 1] int32, the gather's first entry `off`, and `rows` (an
// int32 on the device, or null for B): the entries walked are
// [off, off + rows*K).  Every row of dh is written.  bf16: dout and dh are
// bf16, else f32.
int gather_mean_bwd_launch(const void* dout, const void* mask, const void* order,
                           const void* start, const void* rows, int off, int N, int B, int K,
                           int D, int vec, int bf16_, void* dh, void* stream) {
  const dim3 grid((N + WARPS - 1) / WARPS);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* mp = static_cast<const uint8_t*>(mask);
  const auto* op = static_cast<const int*>(order);
  const auto* sp = static_cast<const int*>(start);
  const auto* rp = static_cast<const int*>(rows);
  dispatch(bf16_, vec, K, [&](auto cfg) {
    using C = decltype(cfg);
    using T = typename C::T;
    gather_mean_bwd_kernel<T, C::VEC, C::KS><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const T*>(dout), mp, op, sp, rp, off, N, B, K, D, static_cast<T*>(dh));
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
