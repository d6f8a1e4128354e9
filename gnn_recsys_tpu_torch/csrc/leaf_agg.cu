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
// What bounds it.  Per (k, p, h) the forward does 2F + 4 operations and the
// backward 4F + 4, on the CUDA cores in f32 (TF32 would keep three digits;
// the model and its tests hold f32).  At the training shape (K=8, P=18,432,
// F=8, H=256) that is 0.76 and 1.36 GFLOP against about 24 MB of bytes
// each, so both are bound by f32 operations (67 TFLOP/s: 0.0113 and 0.0203
// ms) more than by bytes (3.35 TB/s).  The [K, P, H] per-message activations
// (151 MB at that shape) never reach device memory, forward or backward.
//
// The design.  A block of 4 warps owns a tile of TP parents by BC columns.
// A lane owns CW contiguous columns (4 at F <= 16) for PT parents (8 at
// F = 8): each staged x row, read from shared memory as a broadcast, feeds
// CW columns, and output rows leave as coalesced 16-byte stores.  At F = 8
// the lane keeps its F x CW slab of W and its biases in registers; the wider
// instantiations (tests only) read the block's W slab from shared memory.
// The block stages every k-slice of a tile (x[k, p0 .. p0 + TP, :] is
// contiguous) and the tile's mask with cp.async 16-byte copies (4-byte
// copies when F % 4 != 0, plain loads for bf16), zero-filled past P and F,
// into one of two buffers.  A persistent block walks its tiles (blockIdx.x,
// + gridDim.x, ...) and copies the next tile while it computes this one:
// one barrier a stage, where the old design took two a k-slice.  K is
// staged in chunks of KC slices, so any K fits.  Each dot starts at the bias
// and runs over f ascending; the forward sums over k ascending.
// The backward recomputes z from the same slab two parents at a time (eight
// independent chains), forms gj and accumulates an F x CW slab of dW and CW
// values of db over every parent it walks; each pair's cotangent rows are
// loaded while the pair before computes.  The block's 4 warps own the same
// columns for other parents: their slabs are added through shared memory in
// warp order, and the block writes one [F, H] + [H] partial.
// leaf_bwd_reduce_kernel sums the partials of each (f, h) with 16 warps a
// group of 32 entries, in a fixed order.  No atomics: two runs give
// bit-identical dW and db.  At F = 8 the launch bounds hold the forward to
// 128 registers (4 blocks an SM) and the backward to 170 (3 blocks); no
// instantiation spills (chip_smoke.py checks the f32 F = 8 ones).
//
// What holds them now (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): the
// forward runs at about half its bound and the backward a little under.
// Neither the inner loops' issue rate nor their stalls are measured: no
// tool on the card's host breaks them down (no ncu).
//
// The old design (one column a thread, two barriers and a scalar staging
// loop a k-slice, a serial reduce) took 0.0347 ms forward and 0.0553 ms
// backward at the training shape (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;        // threads a block
constexpr int LANES = 32;      // column groups of a block: one a lane
constexpr int WARPS = NT / LANES;
constexpr int RED_WARPS = 16;  // warps of the reduce, each a share of the partials

// The tile of the F-padded instantiation FT.
template <int FT>
struct Tile {
  static constexpr int CW = FT <= 16 ? 4 : (FT == 32 ? 2 : 1);  // columns a lane
  static constexpr int PT = FT == 8 ? 8 : (FT == 128 ? 2 : 4);  // parents a warp
  static constexpr int TP = WARPS * PT;                          // parents a tile
  static constexpr int BC = LANES * CW;                          // columns a block
  static constexpr int KC_RAW = 12288 / (TP * FT * 4);           // k-slices a stage
  static constexpr int KC = KC_RAW > 0 ? KC_RAW : 1;
  static constexpr bool WSM = FT > 8;                            // W slab in shared memory
};

template <int FT>
struct Smem {
  using G = Tile<FT>;
  float ws[G::WSM ? FT : 1][G::WSM ? G::BC : 4];
  float xs[2][G::KC][G::TP][FT];
  float mk[2][G::KC][G::TP];
};

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// What a block walks: tiles blockIdx.x, + gridDim.x, ..., each in nkc
// k-chunks; stage s is chunk s % nkc of the block's (s / nkc)-th tile.
struct Walk {
  int tiles, nkc, stages;
  __device__ Walk(int P, int K, int TP, int KC) {
    tiles = (P + TP - 1) / TP;
    nkc = K > KC ? (K + KC - 1) / KC : 1;
    const int mine = (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    stages = mine * nkc;
  }
  __device__ int p0(int s, int TP) const { return ((int)blockIdx.x + (s / nkc) * (int)gridDim.x) * TP; }
  __device__ int chunk(int s) const { return s % nkc; }
};

// Stage chunk kci of the tile at p0 into buffer buf (the block calls it):
// x[k0 + kk, p0 + pp, :] into xs[buf][kk][pp][:] and ms[p0 + pp, k0 + kk]
// into mk[buf][kk][pp], zero past P, K's chunk and F.
template <typename T, int FT>
__device__ __forceinline__ void stage(Smem<FT>& sm, int buf, const T* __restrict__ x,
                                      const float* __restrict__ ms, int K, int P, int F,
                                      int p0, int kci, bool vec) {
  using G = Tile<FT>;
  const int k0 = kci * G::KC;
  const int kc = min(G::KC, K - k0);
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {  // F % 4 == 0: whole 16-byte chunks of a row
      constexpr int Q = FT / 4;
      for (int i = threadIdx.x; i < kc * G::TP * Q; i += NT) {
        const int kk = i / (G::TP * Q), pp = (i / Q) % G::TP, q = i % Q;
        const bool ok = p0 + pp < P && 4 * q < F;
        const T* src = ok ? x + ((size_t)(k0 + kk) * P + p0 + pp) * F + 4 * q : x;
        cp_async16(&sm.xs[buf][kk][pp][4 * q], src, ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < kc * G::TP * FT; i += NT) {
        const int kk = i / (G::TP * FT), pp = (i / FT) % G::TP, f = i % FT;
        const bool ok = p0 + pp < P && f < F;
        const T* src = ok ? x + ((size_t)(k0 + kk) * P + p0 + pp) * F + f : x;
        cp_async4(&sm.xs[buf][kk][pp][f], src, ok ? 4 : 0);
      }
    }
  } else {  // bf16: widened on load, synchronously
    for (int i = threadIdx.x; i < kc * G::TP * FT; i += NT) {
      const int kk = i / (G::TP * FT), pp = (i / FT) % G::TP, f = i % FT;
      const bool ok = p0 + pp < P && f < F;
      sm.xs[buf][kk][pp][f] = ok ? to_f(x[((size_t)(k0 + kk) * P + p0 + pp) * F + f]) : 0.f;
    }
  }
  // The mask: neighbouring threads on neighbouring entries of a row of ms.
  for (int i = threadIdx.x; i < kc * G::TP; i += NT) {
    const int pp = i / kc, kk = i % kc;
    const bool ok = p0 + pp < P;
    cp_async4(&sm.mk[buf][kk][pp], ok ? ms + (size_t)(p0 + pp) * K + k0 + kk : ms, ok ? 4 : 0);
  }
  cp_async_commit();
}

// The lane's W slab (registers at F = 8, else the block's slab in shared
// memory) and biases, zero past F and H.
template <typename T, int FT>
struct Weights {
  using G = Tile<FT>;
  float wr[G::WSM ? 1 : FT][G::CW];
  float bias[G::CW];
  int col;  // the lane's first column within the block

  __device__ __forceinline__ Weights(Smem<FT>& sm, const T* __restrict__ w,
                                     const T* __restrict__ b, int F, int H, int hb) {
    col = (threadIdx.x % LANES) * G::CW;
    if constexpr (G::WSM) {
      for (int i = threadIdx.x; i < FT * G::BC; i += NT) {
        const int f = i / G::BC, c = i % G::BC;
        sm.ws[f][c] = (f < F && hb + c < H) ? to_f(w[(size_t)f * H + hb + c]) : 0.f;
      }
    } else {
#pragma unroll
      for (int f = 0; f < FT; ++f)
#pragma unroll
        for (int c = 0; c < G::CW; ++c)
          wr[f][c] = (f < F && hb + col + c < H) ? to_f(w[(size_t)f * H + hb + col + c]) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < G::CW; ++c) bias[c] = hb + col + c < H ? to_f(b[hb + col + c]) : 0.f;
  }

  __device__ __forceinline__ float at(const Smem<FT>& sm, int f, int c) const {
    if constexpr (G::WSM) return sm.ws[f][col + c];
    else return wr[f][c];
  }

  // z[r][c] = b[c] + sum_f x_r[f] W[f, c] for R rows, f ascending.  The
  // chain starts at the bias: one add a column fewer than adding it last.
  template <int R>
  __device__ __forceinline__ void dot(const Smem<FT>& sm, const float* const* rows,
                                      float (*z)[G::CW]) const {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < G::CW; ++c) z[r][c] = bias[c];
#pragma unroll
    for (int q = 0; q < FT / 4; ++q) {
      float4 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = reinterpret_cast<const float4*>(rows[r])[q];
#pragma unroll
      for (int c = 0; c < G::CW; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          z[r][c] = fmaf(v[r].x, at(sm, 4 * q, c), z[r][c]);
          z[r][c] = fmaf(v[r].y, at(sm, 4 * q + 1, c), z[r][c]);
          z[r][c] = fmaf(v[r].z, at(sm, 4 * q + 2, c), z[r][c]);
          z[r][c] = fmaf(v[r].w, at(sm, 4 * q + 3, c), z[r][c]);
        }
    }
  }
};

// At F = 8 four blocks an SM (128 registers, which ptxas holds without
// spilling); the wide instantiations, with no minimum, spill nothing either.
template <typename T, int FT>
__global__ void __launch_bounds__(NT, FT == 8 ? 4 : 1)
leaf_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ms, const T* __restrict__ w,
                const T* __restrict__ b, int K, int P, int F, int H, T* __restrict__ out) {
  using G = Tile<FT>;
  __shared__ __align__(16) Smem<FT> sm;
  const int hb = blockIdx.y * G::BC;
  const int prow = (threadIdx.x / LANES) * G::PT;  // the warp's first parent in a tile
  const Weights<T, FT> wt(sm, w, b, F, H, hb);
  const int h0 = hb + wt.col;
  const Walk walk(P, K, G::TP, G::KC);
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vout = std::is_same<T, float>::value && G::CW % 4 == 0 && H % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (walk.stages == 0) return;  // the same for the whole block
  stage<T, FT>(sm, 0, x, ms, K, P, F, walk.p0(0, G::TP), 0, vec);
  float acc[G::PT][G::CW];
  for (int s = 0; s < walk.stages; ++s) {
    const int buf = s & 1, p0 = walk.p0(s, G::TP), kci = walk.chunk(s);
    cp_async_wait_all();
    __syncthreads();  // stage s has landed; stage s - 1's buffer is no longer read
    if (s + 1 < walk.stages)
      stage<T, FT>(sm, buf ^ 1, x, ms, K, P, F, walk.p0(s + 1, G::TP), walk.chunk(s + 1), vec);
    if (kci == 0) {
#pragma unroll
      for (int pp = 0; pp < G::PT; ++pp)
#pragma unroll
        for (int c = 0; c < G::CW; ++c) acc[pp][c] = 0.f;
    }
    const int kc = min(G::KC, K - kci * G::KC);
    for (int kk = 0; kk < kc; ++kk) {
#pragma unroll
      for (int pp = 0; pp < G::PT; ++pp) {
        const float* row = sm.xs[buf][kk][prow + pp];
        float z[1][G::CW];
        wt.template dot<1>(sm, &row, z);
        const float m = sm.mk[buf][kk][prow + pp];
#pragma unroll
        for (int c = 0; c < G::CW; ++c) acc[pp][c] = fmaf(fmaxf(z[0][c], 0.f), m, acc[pp][c]);
      }
    }
    if (kci == walk.nkc - 1 && h0 < H) {
#pragma unroll
      for (int pp = 0; pp < G::PT; ++pp) {
        const int p = p0 + prow + pp;
        if (p >= P) continue;
        T* o = out + (size_t)p * H + h0;
        if (vout) {  // H % 4 == 0: a group of 4 columns lies wholly below H or not
#pragma unroll
          for (int q = 0; q < G::CW / 4; ++q)
            if (h0 + 4 * q < H)
              *reinterpret_cast<float4*>(o + 4 * q) =
                  make_float4(acc[pp][4 * q], acc[pp][4 * q + 1], acc[pp][4 * q + 2],
                              acc[pp][4 * q + 3]);
        } else {
#pragma unroll
          for (int c = 0; c < G::CW; ++c)
            if (h0 + c < H) o[c] = from_f<T>(acc[pp][c]);
        }
      }
    }
  }
}

// The cotangent row of parent p for the lane's columns (0 past P and H).
template <typename T, int CW>
__device__ __forceinline__ void load_g(const T* __restrict__ g, int p, int P, int h0, int H,
                                       float* gr) {
#pragma unroll
  for (int c = 0; c < CW; ++c)
    gr[c] = (p < P && h0 + c < H) ? to_f(g[(size_t)p * H + h0 + c]) : 0.f;
}

// At F = 8 the register cap keeps three blocks an SM resident (ptxas holds
// it without spilling); the wide instantiations take what they need.
template <typename T, int FT>
__global__ void __launch_bounds__(NT, FT == 8 ? 3 : 1)
leaf_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ms, const T* __restrict__ w,
                const T* __restrict__ b, const T* __restrict__ g, int K, int P, int F, int H,
                float* __restrict__ dw_part, float* __restrict__ db_part) {
  using G = Tile<FT>;
  static_assert(G::PT % 2 == 0, "parents are walked in pairs");
  __shared__ __align__(16) Smem<FT> sm;
  const int hb = blockIdx.y * G::BC;
  const int warp = threadIdx.x / LANES, prow = warp * G::PT;
  const Weights<T, FT> wt(sm, w, b, F, H, hb);
  const int h0 = hb + wt.col;
  const Walk walk(P, K, G::TP, G::KC);
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  float dw[FT][G::CW], db[G::CW];
#pragma unroll
  for (int c = 0; c < G::CW; ++c) {
    db[c] = 0.f;
#pragma unroll
    for (int f = 0; f < FT; ++f) dw[f][c] = 0.f;
  }
  if (walk.stages > 0) stage<T, FT>(sm, 0, x, ms, K, P, F, walk.p0(0, G::TP), 0, vec);
  for (int s = 0; s < walk.stages; ++s) {
    const int buf = s & 1, p0 = walk.p0(s, G::TP), kci = walk.chunk(s);
    // The first pair's cotangent rows, loaded before the wait so that their
    // latency overlaps it; each later pair's while the one before computes.
    float g0[G::CW], g1[G::CW];
    load_g<T, G::CW>(g, p0 + prow, P, h0, H, g0);
    load_g<T, G::CW>(g, p0 + prow + 1, P, h0, H, g1);
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < walk.stages)
      stage<T, FT>(sm, buf ^ 1, x, ms, K, P, F, walk.p0(s + 1, G::TP), walk.chunk(s + 1), vec);
    const int kc = min(G::KC, K - kci * G::KC);
    // Two parents at a time: twice the independent dot chains in flight.
#pragma unroll 1
    for (int pp = 0; pp < G::PT; pp += 2) {
      float n0[G::CW], n1[G::CW];
      const int pn = pp + 2 < G::PT ? p0 + prow + pp + 2 : P;  // P: no row, zeros
      load_g<T, G::CW>(g, pn, P, h0, H, n0);
      load_g<T, G::CW>(g, pn + 1, P, h0, H, n1);
      for (int kk = 0; kk < kc; ++kk) {
        const float* rows[2] = {sm.xs[buf][kk][prow + pp], sm.xs[buf][kk][prow + pp + 1]};
        float z[2][G::CW];
        wt.template dot<2>(sm, rows, z);
        const float m0 = sm.mk[buf][kk][prow + pp], m1 = sm.mk[buf][kk][prow + pp + 1];
        float j0[G::CW], j1[G::CW];
#pragma unroll
        for (int c = 0; c < G::CW; ++c) {
          j0[c] = z[0][c] > 0.f ? g0[c] * m0 : 0.f;
          j1[c] = z[1][c] > 0.f ? g1[c] * m1 : 0.f;
          db[c] += j0[c];
          db[c] += j1[c];
        }
        // Wide F: read the rows again rather than keep them in registers
        // beside the F x CW slab of dW (__syncwarp orders the reads).
        if constexpr (FT > 64) __syncwarp();
        const float4* a4 = reinterpret_cast<const float4*>(rows[0]);
        const float4* b4 = reinterpret_cast<const float4*>(rows[1]);
#pragma unroll
        for (int q = 0; q < FT / 4; ++q) {
          const float4 u = a4[q], v = b4[q];
#pragma unroll
          for (int c = 0; c < G::CW; ++c) {
            dw[4 * q][c] = fmaf(v.x, j1[c], fmaf(u.x, j0[c], dw[4 * q][c]));
            dw[4 * q + 1][c] = fmaf(v.y, j1[c], fmaf(u.y, j0[c], dw[4 * q + 1][c]));
            dw[4 * q + 2][c] = fmaf(v.z, j1[c], fmaf(u.z, j0[c], dw[4 * q + 2][c]));
            dw[4 * q + 3][c] = fmaf(v.w, j1[c], fmaf(u.w, j0[c], dw[4 * q + 3][c]));
          }
        }
      }
#pragma unroll
      for (int c = 0; c < G::CW; ++c) {
        g0[c] = n0[c];
        g1[c] = n1[c];
      }
    }
  }
  // The warps' slabs, added in warp order through the staging buffers:
  // red[f][col] for dW, red[FT][col] for db.
  float(*red)[G::BC] = reinterpret_cast<float(*)[G::BC]>(&sm.xs[0][0][0][0]);
  static_assert((FT + 1) * G::BC <= 2 * G::KC * G::TP * FT, "staging buffers too small");
  __syncthreads();  // every warp is done with the staged tiles
  for (int r = 1; r < WARPS; ++r) {
    if (warp == r) {
#pragma unroll
      for (int c = 0; c < G::CW; ++c) {
#pragma unroll
        for (int f = 0; f < FT; ++f) red[f][wt.col + c] = dw[f][c];
        red[FT][wt.col + c] = db[c];
      }
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int c = 0; c < G::CW; ++c) {
#pragma unroll
        for (int f = 0; f < FT; ++f) dw[f][c] += red[f][wt.col + c];
        db[c] += red[FT][wt.col + c];
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < G::CW; ++c) {
      if (h0 + c >= H) continue;
#pragma unroll
      for (int f = 0; f < FT; ++f)
        if (f < F) dw_part[((size_t)blockIdx.x * F + f) * H + h0 + c] = dw[f][c];
      db_part[(size_t)blockIdx.x * H + h0 + c] = db[c];
    }
  }
}

// dW [F, H] and db [H] from the per-block partials.  A block takes 32
// entries (one a lane, coalesced along the partial); its warp j sums
// partials j, j + 16, ..., then lane l of warp 0 adds the 16 sums in warp
// order.  The order is fixed by the partial count alone.
__global__ void __launch_bounds__(RED_WARPS * LANES)
leaf_bwd_reduce_kernel(const float* __restrict__ dw_part, const float* __restrict__ db_part,
                       int blocks, int F, int H, float* __restrict__ dw,
                       float* __restrict__ db) {
  __shared__ float sums[RED_WARPS][LANES];
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const int e = blockIdx.x * LANES + lane;
  const int fh = F * H;
  const bool is_dw = e < fh;
  const float* src = is_dw ? dw_part + e : db_part + (e - fh);
  const size_t stride = is_dw ? (size_t)fh : (size_t)H;
  float s = 0.f;
  if (e < fh + H) {
#pragma unroll 4
    for (int j = warp; j < blocks; j += RED_WARPS) s += src[(size_t)j * stride];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < fh + H) {
    float t = sums[0][lane];
#pragma unroll
    for (int j = 1; j < RED_WARPS; ++j) t += sums[j][lane];
    if (is_dw) dw[e] = t;
    else db[e - fh] = t;
  }
}

template <typename T, int FT>
cudaError_t fwd(const void* x, const void* ms, const void* w, const void* b, int K, int P,
                int F, int H, int grid_x, void* out, cudaStream_t st) {
  const dim3 grid(grid_x, (H + Tile<FT>::BC - 1) / Tile<FT>::BC);
  leaf_fwd_kernel<T, FT><<<grid, NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(ms), static_cast<const T*>(w),
      static_cast<const T*>(b), K, P, F, H, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, int FT>
cudaError_t bwd(const void* x, const void* ms, const void* w, const void* b, const void* g,
                int K, int P, int F, int H, int grid_x, void* dw_part, void* db_part, void* dw,
                void* db, cudaStream_t st) {
  const dim3 grid(grid_x, (H + Tile<FT>::BC - 1) / Tile<FT>::BC);
  leaf_bwd_kernel<T, FT><<<grid, NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(ms), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const T*>(g), K, P, F, H,
      static_cast<float*>(dw_part), static_cast<float*>(db_part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = F * H + H;
  leaf_bwd_reduce_kernel<<<(n + LANES - 1) / LANES, RED_WARPS * LANES, 0, st>>>(
      static_cast<const float*>(dw_part), static_cast<const float*>(db_part), grid_x, F, H,
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
                    int F, int H, int grid_x, void* out, cudaStream_t st) {
#define CALL(T_, FT_) fwd<T_, FT_>(x, ms, w, b, K, P, F, H, grid_x, out, st)
  LEAF_DISPATCH(T, F, CALL)
#undef CALL
}

template <typename T>
cudaError_t bwd_any(const void* x, const void* ms, const void* w, const void* b, const void* g,
                    int K, int P, int F, int H, int grid_x, void* dw_part, void* db_part,
                    void* dw, void* db, cudaStream_t st) {
#define CALL(T_, FT_) bwd<T_, FT_>(x, ms, w, b, g, K, P, F, H, grid_x, dw_part, db_part, dw, db, st)
  LEAF_DISPATCH(T, F, CALL)
#undef CALL
}

template <int FT>
int shape_of(int* out) {
  out[0] = Tile<FT>::TP;
  out[1] = Tile<FT>::BC;
  return 0;
}

int shape_any(int F, int* out) {
#define CALL(T_, FT_) shape_of<FT_>(out)
  LEAF_DISPATCH(float, F, CALL)
#undef CALL
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The tile at feature width F: out[0] parents, out[1] columns.  A launch's
// grid is (grid_x, ceil(H / out[1])); block x walks tiles x, x + grid_x, ...
// of out[0] parents, and the backward writes one [F, H] + [H] partial a
// block x.
int leaf_tile_shape(int F, int* out) {
  if (F < 1 || F > 128) return (int)cudaErrorInvalidValue;
  return shape_any(F, out);
}

int leaf_fwd_launch(const void* x, const void* ms, const void* w, const void* b, int K, int P,
                    int F, int H, int bf16, int grid_x, void* out, void* stream) {
  if (F < 1 || F > 128 || grid_x < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? fwd_any<__nv_bfloat16>(x, ms, w, b, K, P, F, H, grid_x, out, st)
                    : fwd_any<float>(x, ms, w, b, K, P, F, H, grid_x, out, st));
}

int leaf_bwd_launch(const void* x, const void* ms, const void* w, const void* b, const void* g,
                    int K, int P, int F, int H, int bf16, int grid_x, void* dw_part,
                    void* db_part, void* dw, void* db, void* stream) {
  if (F < 1 || F > 128 || grid_x < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? bwd_any<__nv_bfloat16>(x, ms, w, b, g, K, P, F, H, grid_x, dw_part,
                                             db_part, dw, db, st)
                    : bwd_any<float>(x, ms, w, b, g, K, P, F, H, grid_x, dw_part, db_part, dw,
                                     db, st));
}

}  // extern "C"
