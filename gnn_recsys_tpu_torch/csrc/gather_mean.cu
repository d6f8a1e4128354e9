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
//   dh[clip(nbr[b,k])] += dout[b] * m[b,k] / max(count_b, 1)
//
// into a dh that the caller has zeroed.  It adds with f32 atomics, whose
// order changes from run to run: the backward is not bit-reproducible.
//
// What bounds them.  Both move bytes and do almost no arithmetic (one add or
// one multiply-add a gathered element).  Counting each input once and each
// output once, the forward at the training step's widest call (B=38,912,
// K=8, N=30,000, D=256) moves about 72 MB, 0.022 ms at 3.35 TB/s; reading
// every valid slot's row from device memory would be about 319 MB.  The
// table (30.7 MB) fits in the 50 MB L2, so the repeated rows come from L2
// and the kernel's time lies between the two readings.  The backward moves
// the same bytes in the other direction; its atomics resolve in L2.
//
// The simple design.  One warp a destination row.  Lane j < K holds slot j's
// clipped id (or -1 where masked); the count is one ballot.  The lanes span
// D in 16-byte float4 columns (D=256: two a lane) and keep the sums in
// registers; the loop over the K slots takes each id from its lane with a
// shuffle, skips masked slots (a branch the whole warp takes together), and
// the row is written once, scaled by 1 / max(count, 1).  The backward reads
// its dout row once, scales it, and adds it into each valid slot's dh row
// (float4 atomics on Hopper).  Widths that are not a multiple of 4 take the
// same loops one float at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // destination rows per block
constexpr int CH = 2;     // vector columns a lane holds per pass over the slots

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  static __device__ __forceinline__ T scale(const T& a, float s) {
    return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
  }
  static __device__ __forceinline__ void atomic_add(T* p, const T& v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
    atomicAdd(p, v);  // one vector atomic (compute capability 9.x, CUDA 12.1 on)
#else
    float* f = reinterpret_cast<float*>(p);
    atomicAdd(f, v.x); atomicAdd(f + 1, v.y); atomicAdd(f + 2, v.z); atomicAdd(f + 3, v.w);
#endif
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
  static __device__ __forceinline__ T scale(const T& a, float s) { return a * s; }
  static __device__ __forceinline__ void atomic_add(T* p, const T& v) { atomicAdd(p, v); }
};

// Slot base..base+31 of row b: this lane's clipped id, or -1 where masked.
__device__ __forceinline__ int slot_id(const int* __restrict__ nbr,
                                       const uint8_t* __restrict__ mask, size_t row, int K,
                                       int base, int lane, int N) {
  const int k = base + lane;
  if (k >= K || !mask[row + k]) return -1;
  return min(max(nbr[row + k], 0), N - 1);
}

// Valid slots of row b (one ballot per 32 slots).
__device__ __forceinline__ int row_count(const int* __restrict__ nbr,
                                         const uint8_t* __restrict__ mask, size_t row, int K,
                                         int lane, int N) {
  int count = 0;
  for (int base = 0; base < K; base += 32)
    count += __popc(__ballot_sync(0xffffffffu, slot_id(nbr, mask, row, K, base, lane, N) >= 0));
  return count;
}

template <int VEC>
__global__ void __launch_bounds__(WARPS * 32)
gather_mean_fwd_kernel(const float* __restrict__ h, const int* __restrict__ nbr,
                       const uint8_t* __restrict__ mask, int N, int B, int K, int D,
                       float* __restrict__ out) {
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave together
  const size_t row = (size_t)b * K;
  const float inv = 1.f / fmaxf((float)row_count(nbr, mask, row, K, lane, N), 1.f);
  const int dv = D / VEC;
  const V* hv = reinterpret_cast<const V*>(h);
  V* ov = reinterpret_cast<V*>(out) + (size_t)b * dv;
  for (int c0 = 0; c0 < dv; c0 += 32 * CH) {
    V acc[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) acc[j] = Vec<VEC>::zero();
    for (int base = 0; base < K; base += 32) {
      const int mine = slot_id(nbr, mask, row, K, base, lane, N);
      const int n = min(32, K - base);
      for (int s = 0; s < n; ++s) {
        const int id = __shfl_sync(0xffffffffu, mine, s);
        if (id < 0) continue;
        const V* src = hv + (size_t)id * dv;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < dv) Vec<VEC>::add(acc[j], __ldg(src + c));
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

template <int VEC>
__global__ void __launch_bounds__(WARPS * 32)
gather_mean_bwd_kernel(const float* __restrict__ dout, const int* __restrict__ nbr,
                       const uint8_t* __restrict__ mask, int N, int B, int K, int D,
                       float* __restrict__ dh) {
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const size_t row = (size_t)b * K;
  const int count = row_count(nbr, mask, row, K, lane, N);
  if (count == 0) return;  // no valid slot: nothing flows back
  const float inv = 1.f / (float)count;
  const int dv = D / VEC;
  const V* gv = reinterpret_cast<const V*>(dout) + (size_t)b * dv;
  V* dhv = reinterpret_cast<V*>(dh);
  for (int c0 = 0; c0 < dv; c0 += 32 * CH) {
    V g[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = c0 + lane + 32 * j;
      g[j] = c < dv ? Vec<VEC>::scale(gv[c], inv) : Vec<VEC>::zero();
    }
    for (int base = 0; base < K; base += 32) {
      const int mine = slot_id(nbr, mask, row, K, base, lane, N);
      const int n = min(32, K - base);
      for (int s = 0; s < n; ++s) {
        const int id = __shfl_sync(0xffffffffu, mine, s);
        if (id < 0) continue;
        V* dst = dhv + (size_t)id * dv;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < dv) Vec<VEC>::atomic_add(dst + c, g[j]);
        }
      }
    }
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
  if (vec4)
    gather_mean_fwd_kernel<4><<<grid, WARPS * 32, 0, s>>>(hp, ip, mp, N, B, K, D,
                                                          static_cast<float*>(out));
  else
    gather_mean_fwd_kernel<1><<<grid, WARPS * 32, 0, s>>>(hp, ip, mp, N, B, K, D,
                                                          static_cast<float*>(out));
  return (int)cudaGetLastError();
}

int gather_mean_bwd_launch(const void* dout, const void* nbr, const void* mask, int N, int B,
                           int K, int D, int vec4, void* dh, void* stream) {
  const dim3 grid((B + WARPS - 1) / WARPS);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float*>(dout);
  const auto* ip = static_cast<const int*>(nbr);
  const auto* mp = static_cast<const uint8_t*>(mask);
  if (vec4)
    gather_mean_bwd_kernel<4><<<grid, WARPS * 32, 0, s>>>(gp, ip, mp, N, B, K, D,
                                                          static_cast<float*>(dh));
  else
    gather_mean_bwd_kernel<1><<<grid, WARPS * 32, 0, s>>>(gp, ip, mp, N, B, K, D,
                                                          static_cast<float*>(dh));
  return (int)cudaGetLastError();
}

}  // extern "C"
