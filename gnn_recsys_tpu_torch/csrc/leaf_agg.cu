// Fused leaf aggregation of the sampled tree for Hopper (sm_90a).
//
// Replaces leaf_mean_nn of gnn_recsys_tpu/ops/pallas/leaf_agg.py:
//   * forward  (_fwd_kernel, leaf_agg.py:78)  -> leaf_fwd_kernel
//   * backward (_bwd_kernel, leaf_agg.py:94)  -> leaf_bwd_kernel + leaf_bwd_reduce_kernel
//
//   agg[p, h] = sum_k ms[p, k] * relu(z[k, p, h]),   z = x[k, p, :] . W[:, h] + b[h]
//   gj[k, p, h] = z > 0 ? g[p, h] * ms[p, k] : 0
//   dW[f, h] = sum_{k, p} x[k, p, f] * gj[k, p, h],   db[h] = sum_{k, p} gj[k, p, h]
//
// x [K, P, F] (k-major), W [F, H], b [H], the output and g [P, H] are f32 or
// bf16 (one type for all); ms [P, K] is the validity mask with the mean's
// 1/count folded in, f32.  Arithmetic is f32 throughout (bf16 is widened as
// it is loaded), the output is written once in the input type, and dW, db
// are f32.  No gradient flows to x or the mask.
//
// What bounds it.  Per (k, p, h) the forward does 2F + 4 operations (the
// F-wide dot, bias, relu, the masked sum) and the backward 4F + 4, on the
// CUDA cores in f32; at the training shape (K=8, P=18,432, F=8, H=256) that
// is 0.76 and 1.36 GFLOP against about 24 MB of bytes each (x once, the mask,
// and the [P, H] output or cotangent), so both are bound by f32 operations
// (67 TFLOP/s) more than by the [P, H] bytes (3.35 TB/s).  The point of the
// kernel, as on the TPU, is that the [K, P, H] per-message activations
// (151 MB at that shape, f32) never reach device memory, forward or
// backward.
//
// The simple design.  A block of HT=128 threads owns HT output columns
// (one a thread) and tiles of TP=32 parents (8 when F > 32).  A thread
// keeps its column of W in registers (F rounded up to FT in {8, 16, 32, 64,
// 128}, zero-padded).
// For each k, the block stages the contiguous slice x[k, tile, :] and the
// tile's mask column in shared memory; every thread then reads the same
// staged row (a broadcast) and runs the F-wide dot for each parent of the
// tile.  The forward keeps TP accumulators in registers and writes each
// output row coalesced along H.  The backward recomputes z, forms gj, and
// accumulates its column of dW and db over `tiles_per_block` tiles in
// registers; each block writes its partial dW [F, H] and db [H], and a
// second kernel sums the partials of every (f, h) in block order.  There
// are no atomics, so two runs give bit-identical gradients.
//
// Left for later work: several columns a thread (fewer staged reads per
// FMA), cp.async double buffering of the x slices, and bf16 products on the
// tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HT = 128;  // output columns per block, one a thread

// Parents per tile: 32, or 8 for F > 32 (fewer registers and a shorter
// build for the wide-F instantiations, which only tests use).
constexpr int tile_parents(int ft) { return ft > 32 ? 8 : 32; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Stage x[k, p0 .. p0 + np, 0 .. F) into xs[TP][FT] (zero-padded) and the
// tile's mask column ms[p0 .. p0 + np, k] into mk[TP].  Called by the block.
template <typename T, int FT, int TP>
__device__ __forceinline__ void stage(const T* __restrict__ x, const float* __restrict__ ms,
                                      int k, int K, int P, int F, int p0, int np,
                                      float (*xs)[FT], float* mk) {
  const T* xk = x + ((size_t)k * P + p0) * F;
  for (int i = threadIdx.x; i < TP * FT; i += HT) {
    const int pp = i / FT, f = i % FT;
    xs[pp][f] = (pp < np && f < F) ? to_f(xk[pp * F + f]) : 0.f;
  }
  if (threadIdx.x < TP)
    mk[threadIdx.x] = threadIdx.x < np ? ms[(size_t)(p0 + threadIdx.x) * K + k] : 0.f;
}

// z = x_row . w (f ascending), then + b, as the plain version sums.
template <int FT>
__device__ __forceinline__ float dot_bias(const float* xrow, const float* wr, float bh) {
  const float4* x4 = reinterpret_cast<const float4*>(xrow);
  float z = 0.f;
#pragma unroll
  for (int q = 0; q < FT / 4; ++q) {
    const float4 v = x4[q];
    z = fmaf(v.x, wr[4 * q], z);
    z = fmaf(v.y, wr[4 * q + 1], z);
    z = fmaf(v.z, wr[4 * q + 2], z);
    z = fmaf(v.w, wr[4 * q + 3], z);
  }
  return z + bh;
}

template <typename T, int FT>
__device__ __forceinline__ void load_column(const T* __restrict__ w, const T* __restrict__ b,
                                            int F, int H, int h, float* wr, float* bh) {
  const bool hv = h < H;
#pragma unroll
  for (int f = 0; f < FT; ++f) wr[f] = (hv && f < F) ? to_f(w[(size_t)f * H + h]) : 0.f;
  *bh = hv ? to_f(b[h]) : 0.f;
}

template <typename T, int FT, int TP = tile_parents(FT)>
__global__ void __launch_bounds__(HT)
leaf_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ms, const T* __restrict__ w,
                const T* __restrict__ b, int K, int P, int F, int H, T* __restrict__ out) {
  __shared__ __align__(16) float xs[TP][FT];
  __shared__ float mk[TP];
  const int p0 = blockIdx.x * TP;
  const int np = min(TP, P - p0);
  const int h = blockIdx.y * HT + threadIdx.x;
  float wr[FT], bh;
  load_column<T, FT>(w, b, F, H, h, wr, &bh);
  float acc[TP];
#pragma unroll
  for (int pp = 0; pp < TP; ++pp) acc[pp] = 0.f;
  for (int k = 0; k < K; ++k) {
    __syncthreads();  // the previous slice is no longer read
    stage<T, FT, TP>(x, ms, k, K, P, F, p0, np, xs, mk);
    __syncthreads();
#pragma unroll
    for (int pp = 0; pp < TP; ++pp) {
      const float z = dot_bias<FT>(xs[pp], wr, bh);
      acc[pp] = fmaf(fmaxf(z, 0.f), mk[pp], acc[pp]);
    }
  }
  if (h < H) {
#pragma unroll
    for (int pp = 0; pp < TP; ++pp)  // static indices keep acc in registers
      if (pp < np) out[(size_t)(p0 + pp) * H + h] = from_f<T>(acc[pp]);
  }
}

template <typename T, int FT, int TP = tile_parents(FT)>
__global__ void __launch_bounds__(HT)
leaf_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ms, const T* __restrict__ w,
                const T* __restrict__ b, const T* __restrict__ g, int K, int P, int F, int H,
                int tiles_per_block, float* __restrict__ dw_part,
                float* __restrict__ db_part) {
  __shared__ __align__(16) float xs[TP][FT];
  __shared__ float mk[TP];
  const int h = blockIdx.y * HT + threadIdx.x;
  const bool hv = h < H;
  float wr[FT], bh;
  load_column<T, FT>(w, b, F, H, h, wr, &bh);
  float dw[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) dw[f] = 0.f;
  float db = 0.f;
  for (int t = 0; t < tiles_per_block; ++t) {
    const int p0 = (blockIdx.x * tiles_per_block + t) * TP;
    if (p0 >= P) break;  // the same for every thread of the block
    const int np = min(TP, P - p0);
    float gr[TP];
#pragma unroll
    for (int pp = 0; pp < TP; ++pp)
      gr[pp] = (hv && pp < np) ? to_f(g[(size_t)(p0 + pp) * H + h]) : 0.f;
    for (int k = 0; k < K; ++k) {
      __syncthreads();
      stage<T, FT, TP>(x, ms, k, K, P, F, p0, np, xs, mk);
      __syncthreads();
#pragma unroll
      for (int pp = 0; pp < TP; ++pp) {
        const float z = dot_bias<FT>(xs[pp], wr, bh);
        const float gj = z > 0.f ? gr[pp] * mk[pp] : 0.f;
#pragma unroll
        for (int f = 0; f < FT; ++f) dw[f] = fmaf(xs[pp][f], gj, dw[f]);
        db += gj;
      }
    }
  }
  if (hv) {
#pragma unroll
    for (int f = 0; f < FT; ++f)
      if (f < F) dw_part[((size_t)blockIdx.x * F + f) * H + h] = dw[f];
    db_part[(size_t)blockIdx.x * H + h] = db;
  }
}

// dW [F, H] and db [H] as sums of the per-block partials, in block order.
__global__ void leaf_bwd_reduce_kernel(const float* __restrict__ dw_part,
                                       const float* __restrict__ db_part, int blocks, int F,
                                       int H, float* __restrict__ dw, float* __restrict__ db) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int fh = F * H;
  if (i < fh) {
    float s = 0.f;
    for (int j = 0; j < blocks; ++j) s += dw_part[(size_t)j * fh + i];
    dw[i] = s;
  } else if (i < fh + H) {
    const int hh = i - fh;
    float s = 0.f;
    for (int j = 0; j < blocks; ++j) s += db_part[(size_t)j * H + hh];
    db[hh] = s;
  }
}

template <typename T, int FT>
cudaError_t fwd(const void* x, const void* ms, const void* w, const void* b, int K, int P,
                int F, int H, void* out, cudaStream_t st) {
  constexpr int TP = tile_parents(FT);
  const dim3 grid((P + TP - 1) / TP, (H + HT - 1) / HT);
  leaf_fwd_kernel<T, FT><<<grid, HT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(ms), static_cast<const T*>(w),
      static_cast<const T*>(b), K, P, F, H, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, int FT>
cudaError_t bwd(const void* x, const void* ms, const void* w, const void* b, const void* g,
                int K, int P, int F, int H, int tiles_per_block, void* dw_part,
                void* db_part, void* dw, void* db, cudaStream_t st) {
  constexpr int TP = tile_parents(FT);
  const int tiles = (P + TP - 1) / TP;
  const int blocks = (tiles + tiles_per_block - 1) / tiles_per_block;
  const dim3 grid(blocks, (H + HT - 1) / HT);
  leaf_bwd_kernel<T, FT><<<grid, HT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(ms), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const T*>(g), K, P, F, H, tiles_per_block,
      static_cast<float*>(dw_part), static_cast<float*>(db_part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = F * H + H;
  leaf_bwd_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(dw_part), static_cast<const float*>(db_part), blocks, F, H,
      static_cast<float*>(dw), static_cast<float*>(db));
  return cudaGetLastError();
}

// Instantiate F rounded up to a power of two in [8, 128].
#define LEAF_DISPATCH(T, F, CALL)         \
  if ((F) <= 8) return CALL(T, 8);        \
  if ((F) <= 16) return CALL(T, 16);      \
  if ((F) <= 32) return CALL(T, 32);      \
  if ((F) <= 64) return CALL(T, 64);      \
  return CALL(T, 128);

template <typename T>
cudaError_t fwd_any(const void* x, const void* ms, const void* w, const void* b, int K, int P,
                    int F, int H, void* out, cudaStream_t st) {
#define CALL(T_, FT_) fwd<T_, FT_>(x, ms, w, b, K, P, F, H, out, st)
  LEAF_DISPATCH(T, F, CALL)
#undef CALL
}

template <typename T>
cudaError_t bwd_any(const void* x, const void* ms, const void* w, const void* b, const void* g,
                    int K, int P, int F, int H, int tiles_per_block, void* dw_part,
                    void* db_part, void* dw, void* db, cudaStream_t st) {
#define CALL(T_, FT_) \
  bwd<T_, FT_>(x, ms, w, b, g, K, P, F, H, tiles_per_block, dw_part, db_part, dw, db, st)
  LEAF_DISPATCH(T, F, CALL)
#undef CALL
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Parents per tile at feature width F: the backward's partial buffers hold
// one [F, H] and one [H] block for every tiles_per_block tiles of this many
// parents.
int leaf_tile_parents(int F) { return tile_parents(F); }

int leaf_fwd_launch(const void* x, const void* ms, const void* w, const void* b, int K, int P,
                    int F, int H, int bf16, void* out, void* stream) {
  if (F < 1 || F > 128) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? fwd_any<__nv_bfloat16>(x, ms, w, b, K, P, F, H, out, st)
                    : fwd_any<float>(x, ms, w, b, K, P, F, H, out, st));
}

int leaf_bwd_launch(const void* x, const void* ms, const void* w, const void* b, const void* g,
                    int K, int P, int F, int H, int bf16, int tiles_per_block, void* dw_part,
                    void* db_part, void* dw, void* db, void* stream) {
  if (F < 1 || F > 128 || tiles_per_block < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? bwd_any<__nv_bfloat16>(x, ms, w, b, g, K, P, F, H, tiles_per_block,
                                             dw_part, db_part, dw, db, st)
                    : bwd_any<float>(x, ms, w, b, g, K, P, F, H, tiles_per_block, dw_part,
                                     db_part, dw, db, st));
}

}  // extern "C"
