// The MLP scoring head's tower over every (user, pool item) pair of the
// dense pool, for Hopper (sm_90a), forward and backward.
//
// Replaces no Pallas kernel.  The JAX package runs the head
// (gnn_recsys_tpu/models/layers.py:PredictingLayer) in XLA, on the concat of
// each positive's row with each pool row.  Run as PyTorch operations, the
// port's head wrote a [B, P, 256] concat, [B, P, 128] and [B, P, 32]
// activations and, backward, every one of their gradients: about 17 ms of a
// bf16 step at B = 1,024 and P = 2,560, against a least time of 0.13 ms.
// These kernels keep every per-pair tensor in registers and write only the
// scores (the wrappers are gnn_recsys_tpu_torch/ops/cuda/pred_tower.py).
//
// Layer 1 is factorised by the caller: Dense(concat(u, i)) = u W1_u^T +
// i W1_i^T + b1, so A_u = u W1_u^T [B, 128] and A_i = pool W1_i^T [P, 128]
// arrive as f32 products (cuBLAS GEMMs, with their own backward).  For the
// pair (b, p), in the tower's type T (bf16 or f32):
//
//   z1 = (A_u[b] + b1) + A_i[p]       f32
//   h1 = T(relu(z1))                   rounded once
//   z2 = h1 W2^T + b2                  f32 sums; W2 [32, 128] in T
//   z3 = relu(z2) . w3 + b3            f32
//   s  = 1 / (1 + exp(-z3))            f32, the only output [B, P]
//
// The backward takes dS [B, P] and the saved s, recomputes z1, h1 and z2,
// and forms
//
//   dz3 = dS s (1 - s)     dz2 = dz3 w3 [z2 > 0]     dz1 = (T(dz2) W2) [z1 > 0]
//   dA_u[b] = sum_p dz1    dA_i[p] = sum_b dz1       db1 = sum dz1
//   dW2 = sum T(dz2)^T h1  db2 = sum dz2  dw3 = sum dz3 relu(z2)  db3 = sum dz3
//
// over every pair.  In bf16, T(dz2) is the tensor cores' operand (the
// unfactorised head rounds dz1 to bf16 instead); every sum is f32.
//
// Products.  In bf16 they run on the tensor cores as mma.sync.m16n8k16 with
// f32 accumulators; in f32 the same fragments go through an emulation of
// that instruction in f32 FMAs (Ops<float>), since the f32 configurations
// keep TF32 off.  A warp's MMA tile is 16 pairs: one user against 16 pool
// items (the rows).  Each kernel holds the fragment layouts so that one
// product's accumulator is the next one's operand: z2's accumulator packs
// into dz2's A fragments for dz1 = dz2 W2, whose accumulator has the same
// (row, column) per thread as h1's A fragment, so the ReLU mask of z1 lines
// up; dW2 = dz2^T h1 takes both operands transposed (movmatrix).
//
// What bounds them: the tensor cores.  A pair needs 8,256 operations
// forward (layers 2 and 3) and twice that backward, so the head's least time
// at 989 TFLOP/s is 0.13 ms a step of the bench configuration
// (portbench/counts/pred_nn.py); mma.sync reaches about two thirds of that
// peak.  What the design does about it: no per-pair byte reaches device
// memory but the scores and their gradients (4 + 4 bytes a pair); a block
// stages its 128 pool rows of A_i, its 32 user rows of A_u + b1 and W2 in
// shared memory, each warp keeps 16 pool items and walks the block's users.
// The fragments come from shared memory (about 16 KB a tile forward, 24 KB
// in the backward's dA pass), which with the MMAs and the per-pair
// elementwise work sets a tile's time.  On an H100 80GB HBM3 at 700 W, in
// bf16 at B = 1,024 and P = 2,560: 0.150 ms forward (0.022 ms least) and
// 0.602 ms backward (0.044 ms least) a call.
//
// Sums across blocks take per-block partials and a fixed-order second pass
// (pred_tower_sum_kernel), as the gather-mean backward avoids atomics, so
// two runs give the same bits.  The backward is two passes over the pairs:
// pred_tower_bwd_kernel (dA_u, dA_i and the small gradients) and
// pred_tower_dw2_kernel (dW2), because dW2's accumulator (128 floats a
// thread) and dA_i's (64) do not fit one thread's registers together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr unsigned FULL = 0xffffffffu;
constexpr int H1 = 128;              // layer 1's width
constexpr int H2 = 32;               // layer 2's width
constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;       // threads a block
constexpr int TP = 16 * WARPS;       // pool items a block: 16 a warp
constexpr int TB = 32;               // users a block
constexpr int US = 2;                // users between two barriers of the dA pass
constexpr int AI_LD = H1 + 8;        // row strides in shared memory, chosen so
constexpr int W2_LD = H1 + 8;        // that each fragment load is free of bank
constexpr int W2T_LD = H2 + 8;       // conflicts
constexpr int SMALL = H1 + 2 * H2 + 1;  // db1, db2, dw3, db3
constexpr int SUM_ROWS = 8;          // threads that share a column of a sum
static_assert(US * H1 <= NT && TB % US == 0, "a thread for each column of a step's users");
static_assert(H1 + 2 * H2 + 1 <= NT, "a thread for each small gradient");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return make_float2(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src));
}

// A pair of consecutive elements of a fragment (the lower index first), the
// m16n8k16 product and the 8 x 8 transpose, by the tower's type.
template <typename T>
struct Ops;

template <>
struct Ops<bf16> {
  typedef uint32_t P;
  static __device__ __forceinline__ P pack(float x, float y) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ P load(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const P (&a)[4], const P (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ P trans(P v) {
    uint32_t d;
    asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(v));
    return d;
  }
};

// f32: the same fragments, each element a float.  The product of a thread's
// accumulator entry gathers its A row and B column from the lanes that hold
// them (16 shuffles for each quarter of k) and adds in f32 FMAs.  The loop
// over k stays rolled: unrolled, the f32 kernels spilled and the library
// took three times as long to build.
template <>
struct Ops<float> {
  typedef float2 P;
  static __device__ __forceinline__ P pack(float x, float y) { return make_float2(x, y); }
  static __device__ __forceinline__ P load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const P (&a)[4], const P (&b)[2]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 1
    for (int kk = 0; kk < 4; ++kk) {
      const int la = 4 * g + kk, lb0 = 8 * q + kk, lb1 = 8 * q + 4 + kk;
      const float2 r0 = shfl2(a[0], la), r8 = shfl2(a[1], la);
      const float2 r0h = shfl2(a[2], la), r8h = shfl2(a[3], la);
      const float2 x0 = shfl2(b[0], lb0), x0h = shfl2(b[1], lb0);
      const float2 x1 = shfl2(b[0], lb1), x1h = shfl2(b[1], lb1);
      c[0] = fmaf(r0h.y, x0h.y, fmaf(r0h.x, x0h.x, fmaf(r0.y, x0.y, fmaf(r0.x, x0.x, c[0]))));
      c[1] = fmaf(r0h.y, x1h.y, fmaf(r0h.x, x1h.x, fmaf(r0.y, x1.y, fmaf(r0.x, x1.x, c[1]))));
      c[2] = fmaf(r8h.y, x0h.y, fmaf(r8h.x, x0h.x, fmaf(r8.y, x0.y, fmaf(r8.x, x0.x, c[2]))));
      c[3] = fmaf(r8h.y, x1h.y, fmaf(r8h.x, x1h.x, fmaf(r8.y, x1.y, fmaf(r8.x, x1.x, c[3]))));
    }
  }
  static __device__ __forceinline__ P trans(P v) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int s0 = 8 * q + (g >> 1), s1 = 8 * q + 4 + (g >> 1);
    const float x0 = __shfl_sync(FULL, v.x, s0), y0 = __shfl_sync(FULL, v.y, s0);
    const float x1 = __shfl_sync(FULL, v.x, s1), y1 = __shfl_sync(FULL, v.y, s1);
    return (g & 1) ? make_float2(y0, y1) : make_float2(x0, x1);
  }
};

constexpr int align16(int x) { return (x + 15) / 16 * 16; }

// Byte offsets into a block's dynamic shared memory.
template <typename T>
struct Smem {
  static constexpr int ai = 0;                                      // f32 [TP][AI_LD]
  static constexpr int ab = ai + TP * AI_LD * 4;                    // f32 [TB][H1]
  static constexpr int w2 = ab + TB * H1 * 4;                       // T [H2][W2_LD]
  static constexpr int w2t = align16(w2 + H2 * W2_LD * (int)sizeof(T));  // T [H1][W2T_LD]
  static constexpr int fwd = w2t;                                   // forward and dW2 pass
  static constexpr int su = align16(w2t + H1 * W2T_LD * (int)sizeof(T));  // f32 [2][WARPS][US][H1]
  static constexpr int red = su + 2 * WARPS * US * H1 * 4;          // f32 [WARPS][2 H2 + 1]
  static constexpr int d1 = red + WARPS * (2 * H2 + 1) * 4;         // f32 [US][H1]
  static constexpr int l2 = d1 + US * H1 * 4;                       // f32 b2 [H2], w3 [H2]
  static constexpr int bwd = l2 + 2 * H2 * 4;
};

// The block's pool rows of A_i (zero past P), its user rows of A_u + b1
// (zero past B) and W2, and W2^T where w2t is given.
template <typename T>
__device__ void stage(const float* __restrict__ a_u, const float* __restrict__ a_i,
                      const T* __restrict__ b1, const T* __restrict__ w2, int B, int P, int u0,
                      int p0, float* ai, float* ab, T* w2s, T* w2t) {
  for (int i = threadIdx.x; i < TP * (H1 / 4); i += NT) {
    const int r = i / (H1 / 4), c = 4 * (i % (H1 / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 + r < P) v = *reinterpret_cast<const float4*>(a_i + (long long)(p0 + r) * H1 + c);
    *reinterpret_cast<float4*>(ai + r * AI_LD + c) = v;
  }
  for (int i = threadIdx.x; i < TB * (H1 / 4); i += NT) {
    const int r = i / (H1 / 4), c = 4 * (i % (H1 / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u0 + r < B) {
      v = *reinterpret_cast<const float4*>(a_u + (long long)(u0 + r) * H1 + c);
      v.x += to_f(b1[c]);
      v.y += to_f(b1[c + 1]);
      v.z += to_f(b1[c + 2]);
      v.w += to_f(b1[c + 3]);
    }
    *reinterpret_cast<float4*>(ab + r * H1 + c) = v;
  }
  for (int i = threadIdx.x; i < H2 * H1; i += NT) {
    const int j = i / H1, k = i % H1;
    const T v = w2[i];
    w2s[j * W2_LD + k] = v;
    if (w2t != nullptr) w2t[k * W2T_LD + j] = v;
  }
}

// z2 - b2 of one tile: a user row of A_u + b1 (ab_row) against the warp's 16
// pool rows (row g at ai_g, row g + 8 at ai_g8).  z2[nt][0..1] is row g,
// columns 8 nt + 2q + (0, 1); z2[nt][2..3] row g + 8.  ha[kc] is h1's A
// fragment for k = 16 kc .. 16 kc + 15, and bit 8 kc + 2 r + e of mask is
// z1 > 0 for element e of its register r.
template <typename T>
__device__ __forceinline__ void tower_z2(const float* ab_row, const float* ai_g,
                                         const float* ai_g8, const T* w2s, int g, int q,
                                         float (&z2)[4][4], typename Ops<T>::P (&ha)[8][4],
                                         uint64_t& mask) {
  typedef typename Ops<T>::P Fr;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) z2[nt][c] = 0.f;
  mask = 0;
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    const int k0 = 16 * kc + 2 * q;
    const float2 ul = *reinterpret_cast<const float2*>(ab_row + k0);
    const float2 uh = *reinterpret_cast<const float2*>(ab_row + k0 + 8);
    const float2 x[4] = {*reinterpret_cast<const float2*>(ai_g + k0),
                         *reinterpret_cast<const float2*>(ai_g8 + k0),
                         *reinterpret_cast<const float2*>(ai_g + k0 + 8),
                         *reinterpret_cast<const float2*>(ai_g8 + k0 + 8)};
    Fr a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 u = r < 2 ? ul : uh;
      const float z0 = u.x + x[r].x, z1 = u.y + x[r].y;
      mask |= (uint64_t)(z0 > 0.f) << (8 * kc + 2 * r);
      mask |= (uint64_t)(z1 > 0.f) << (8 * kc + 2 * r + 1);
      a[r] = Ops<T>::pack(fmaxf(z0, 0.f), fmaxf(z1, 0.f));
      ha[kc][r] = a[r];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const T* wrow = w2s + (8 * nt + g) * W2_LD + k0;
      const Fr b[2] = {Ops<T>::load(wrow), Ops<T>::load(wrow + 8)};
      Ops<T>::mma(z2[nt], a, b);
    }
  }
}

// b2 and w3 at a thread's accumulator columns 8 nt + 2q + e.
template <typename T>
__device__ __forceinline__ void layer2_params(const T* __restrict__ b2, const T* __restrict__ w3,
                                              int q, float (&b2v)[4][2], float (&w3v)[4][2]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      b2v[nt][e] = to_f(b2[8 * nt + 2 * q + e]);
      w3v[nt][e] = to_f(w3[8 * nt + 2 * q + e]);
    }
}

// dz3 of a pair: dS s (1 - s), or 0 for a pair outside [B, P].
__device__ __forceinline__ float score_grad(const float* __restrict__ ds,
                                            const float* __restrict__ s, int b, int p, int B,
                                            int P) {
  if (b >= B || p >= P) return 0.f;
  const long long i = (long long)b * P + p;
  const float sv = s[i];
  return ds[i] * (sv * (1.f - sv));
}

// dz2 of a tile from z2 - b2 and the rows' dz3 (row g: dg, row g + 8: dg8).
__device__ __forceinline__ void layer2_grad(const float (&z2)[4][4], const float (&b2v)[4][2],
                                            const float (&w3v)[4][2], float dg, float dg8,
                                            float (&dz2)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dz2[nt][e] = z2[nt][e] + b2v[nt][e] > 0.f ? dg * w3v[nt][e] : 0.f;
      dz2[nt][2 + e] = z2[nt][2 + e] + b2v[nt][e] > 0.f ? dg8 * w3v[nt][e] : 0.f;
    }
}

// One step of a sum over lanes that also spreads the values: lane pairs H
// apart (H = 8, 4) swap halves of v[0 .. 2H), and each keeps the sum of its
// half in v[0 .. H): the upper lane the upper half.
template <int H, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 2 : 1)
    pred_tower_fwd_kernel(const float* __restrict__ a_u, const float* __restrict__ a_i,
                          const T* __restrict__ b1, const T* __restrict__ w2,
                          const T* __restrict__ b2, const T* __restrict__ w3,
                          const T* __restrict__ b3, int B, int P, float* __restrict__ s) {
  typedef typename Ops<T>::P Fr;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ai = reinterpret_cast<float*>(smem + Smem<T>::ai);
  float* ab = reinterpret_cast<float*>(smem + Smem<T>::ab);
  T* w2s = reinterpret_cast<T*>(smem + Smem<T>::w2);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int p0 = blockIdx.x * TP, u0 = blockIdx.y * TB;
  stage<T>(a_u, a_i, b1, w2, B, P, u0, p0, ai, ab, w2s, nullptr);
  __syncthreads();
  float b2v[4][2], w3v[4][2];
  layer2_params<T>(b2, w3, q, b2v, w3v);
  const float b3v = to_f(b3[0]);
  const float* ai_g = ai + (16 * w + g) * AI_LD;
  const float* ai_g8 = ai_g + 8 * AI_LD;
  const int pg = p0 + 16 * w + g, pg8 = pg + 8;
  for (int u = 0; u < TB && u0 + u < B; ++u) {
    float z2[4][4];
    Fr ha[8][4];
    uint64_t mask;
    tower_z2<T>(ab + u * H1, ai_g, ai_g8, w2s, g, q, z2, ha, mask);
    float zg = 0.f, zg8 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        zg = fmaf(fmaxf(z2[nt][e] + b2v[nt][e], 0.f), w3v[nt][e], zg);
        zg8 = fmaf(fmaxf(z2[nt][2 + e] + b2v[nt][e], 0.f), w3v[nt][e], zg8);
      }
    zg += __shfl_xor_sync(FULL, zg, 1);
    zg += __shfl_xor_sync(FULL, zg, 2);
    zg8 += __shfl_xor_sync(FULL, zg8, 1);
    zg8 += __shfl_xor_sync(FULL, zg8, 2);
    const long long row = (long long)(u0 + u) * P;
    if (q == 0 && pg < P) s[row + pg] = 1.f / (1.f + expf(-(zg + b3v)));
    if (q == 1 && pg8 < P) s[row + pg8] = 1.f / (1.f + expf(-(zg8 + b3v)));
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    pred_tower_bwd_kernel(const float* __restrict__ ds, const float* __restrict__ s,
                          const float* __restrict__ a_u, const float* __restrict__ a_i,
                          const T* __restrict__ b1, const T* __restrict__ w2,
                          const T* __restrict__ b2, const T* __restrict__ w3, int B, int P,
                          float* __restrict__ part_u, float* __restrict__ part_i,
                          float* __restrict__ part_small) {
  typedef typename Ops<T>::P Fr;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ai = reinterpret_cast<float*>(smem + Smem<T>::ai);
  float* ab = reinterpret_cast<float*>(smem + Smem<T>::ab);
  T* w2s = reinterpret_cast<T*>(smem + Smem<T>::w2);
  T* w2t = reinterpret_cast<T*>(smem + Smem<T>::w2t);
  float* su = reinterpret_cast<float*>(smem + Smem<T>::su);
  float* red = reinterpret_cast<float*>(smem + Smem<T>::red);
  float* d1 = reinterpret_cast<float*>(smem + Smem<T>::d1);
  float* l2 = reinterpret_cast<float*>(smem + Smem<T>::l2);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int p0 = blockIdx.x * TP, u0 = blockIdx.y * TB;
  stage<T>(a_u, a_i, b1, w2, B, P, u0, p0, ai, ab, w2s, w2t);
  if (tid < 2 * H2) l2[tid] = to_f(tid < H2 ? b2[tid] : w3[tid - H2]);
  __syncthreads();
  const float* ai_g = ai + (16 * w + g) * AI_LD;
  const float* ai_g8 = ai_g + 8 * AI_LD;
  const int pg = p0 + 16 * w + g, pg8 = pg + 8;

  float dai[16][4];  // dA_i of rows g ([0..1]) and g + 8 ([2..3]), columns 8 nf + 2q + e
#pragma unroll
  for (int nf = 0; nf < 16; ++nf)
#pragma unroll
    for (int c = 0; c < 4; ++c) dai[nf][c] = 0.f;
  float db2[4][2], dw3[4][2], db3 = 0.f, d1acc = 0.f;  // db2, dw3 at columns j = 8 nt + 2q + e
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) db2[nt][e] = dw3[nt][e] = 0.f;

  int buf = 0;
  for (int t = 0; t < TB; t += US) {  // every block walks all TB users: barriers inside
    for (int uu = 0; uu < US; ++uu) {
      const int b = u0 + t + uu;
      float z2[4][4];
      Fr ha[8][4];
      uint64_t mask;
      tower_z2<T>(ab + (t + uu) * H1, ai_g, ai_g8, w2s, g, q, z2, ha, mask);
      const float dg = score_grad(ds, s, b, pg, B, P), dg8 = score_grad(ds, s, b, pg8, B, P);
      float b2v[4][2], w3v[4][2];  // from shared memory here: registers are short
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          b2v[nt][e] = l2[8 * nt + 2 * q + e];
          w3v[nt][e] = l2[H2 + 8 * nt + 2 * q + e];
        }
      float dz2[4][4];
      layer2_grad(z2, b2v, w3v, dg, dg8, dz2);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          db2[nt][e] += dz2[nt][e] + dz2[nt][2 + e];
          dw3[nt][e] = fmaf(dg, fmaxf(z2[nt][e] + b2v[nt][e], 0.f), dw3[nt][e]);
          dw3[nt][e] = fmaf(dg8, fmaxf(z2[nt][2 + e] + b2v[nt][e], 0.f), dw3[nt][e]);
        }
      db3 += dg + dg8;
      // dz2 as A fragments over k = j: z2's accumulator layout is already
      // the A layout, two n-tiles a k-step.
      Fr da[2][4];
#pragma unroll
      for (int kj = 0; kj < 2; ++kj) {
        da[kj][0] = Ops<T>::pack(dz2[2 * kj][0], dz2[2 * kj][1]);
        da[kj][1] = Ops<T>::pack(dz2[2 * kj][2], dz2[2 * kj][3]);
        da[kj][2] = Ops<T>::pack(dz2[2 * kj + 1][0], dz2[2 * kj + 1][1]);
        da[kj][3] = Ops<T>::pack(dz2[2 * kj + 1][2], dz2[2 * kj + 1][3]);
      }
      // This user's dA_u: the tile's rows summed, then over the 8 lanes of a
      // column set (g), whose first step (lanes 16 apart) meets columns
      // 8 n + 2q + e and 8 (n + 8) + 2q + e as soon as both are made.  Lane
      // (g, q) ends with columns 16 g + 2q + (0, 1) and 16 g + 8 + 2q + (0, 1).
      float dau[16];
      const bool up = lane & 16;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float v[2][2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int nf = n + 8 * hf;
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kj = 0; kj < 2; ++kj) {
            const T* wrow = w2t + (8 * nf + g) * W2T_LD + 16 * kj + 2 * q;
            const Fr bw[2] = {Ops<T>::load(wrow), Ops<T>::load(wrow + 8)};
            Ops<T>::mma(c, da[kj], bw);
          }
          // h1's fragment register of row g for columns 8 nf ..: 2 (nf & 1); row g + 8: one more.
          const int bit = 8 * (nf >> 1) + 4 * (nf & 1);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float vg = (mask >> (bit + e)) & 1 ? c[e] : 0.f;
            const float vg8 = (mask >> (bit + 2 + e)) & 1 ? c[2 + e] : 0.f;
            dai[nf][e] += vg;
            dai[nf][2 + e] += vg8;
            v[hf][e] = vg + vg8;
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float send = up ? v[0][e] : v[1][e];
          const float keep = up ? v[1][e] : v[0][e];
          dau[2 * n + e] = keep + __shfl_xor_sync(FULL, send, 16);
        }
      }
      halve<8>(dau, lane);
      halve<4>(dau, lane);
      float* slot = su + ((buf * WARPS + w) * US + uu) * H1 + 16 * g + 2 * q;
      slot[0] = dau[0];
      slot[1] = dau[1];
      slot[8] = dau[2];
      slot[9] = dau[3];
    }
    __syncthreads();
    if (tid < US * H1) {  // the block's dA_u of these users, warps in order
      const int uu = tid / H1, k = tid % H1, b = u0 + t + uu;
      float v = 0.f;
#pragma unroll
      for (int ww = 0; ww < WARPS; ++ww) v += su[((buf * WARPS + ww) * US + uu) * H1 + k];
      if (b < B) part_u[((long long)blockIdx.x * B + b) * H1 + k] = v;
      d1acc += v;
    }
    buf ^= 1;
  }

  float* rows_i = part_i + (long long)blockIdx.y * P * H1;
#pragma unroll
  for (int nf = 0; nf < 16; ++nf) {
    const int col = 8 * nf + 2 * q;
    if (pg < P)
      *reinterpret_cast<float2*>(rows_i + (long long)pg * H1 + col) =
          make_float2(dai[nf][0], dai[nf][1]);
    if (pg8 < P)
      *reinterpret_cast<float2*>(rows_i + (long long)pg8 * H1 + col) =
          make_float2(dai[nf][2], dai[nf][3]);
  }
  // The small gradients: over a column set's 8 lanes, then the warps in
  // order; db1 is the block's dA_u summed over its users.
#pragma unroll
  for (int o = 4; o <= 16; o <<= 1) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        db2[nt][e] += __shfl_xor_sync(FULL, db2[nt][e], o);
        dw3[nt][e] += __shfl_xor_sync(FULL, dw3[nt][e], o);
      }
    db3 += __shfl_xor_sync(FULL, db3, o);
  }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[w * (2 * H2 + 1) + 8 * nt + 2 * q + e] = db2[nt][e];
        red[w * (2 * H2 + 1) + H2 + 8 * nt + 2 * q + e] = dw3[nt][e];
      }
    if (q == 0) red[w * (2 * H2 + 1) + 2 * H2] = db3;  // every lane of a row holds its dz3
  }
  if (tid < US * H1) d1[tid] = d1acc;
  __syncthreads();
  float* out = part_small + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * SMALL;
  if (tid < H1) {
    float v = 0.f;
#pragma unroll
    for (int uu = 0; uu < US; ++uu) v += d1[uu * H1 + tid];
    out[tid] = v;
  } else if (tid < SMALL) {
    const int i = tid - H1;
    float v = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) v += red[ww * (2 * H2 + 1) + i];
    out[tid] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    pred_tower_dw2_kernel(const float* __restrict__ ds, const float* __restrict__ s,
                          const float* __restrict__ a_u, const float* __restrict__ a_i,
                          const T* __restrict__ b1, const T* __restrict__ w2,
                          const T* __restrict__ b2, const T* __restrict__ w3, int B, int P,
                          float* __restrict__ part_w2) {
  typedef typename Ops<T>::P Fr;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ai = reinterpret_cast<float*>(smem + Smem<T>::ai);
  float* ab = reinterpret_cast<float*>(smem + Smem<T>::ab);
  T* w2s = reinterpret_cast<T*>(smem + Smem<T>::w2);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int p0 = blockIdx.x * TP, u0 = blockIdx.y * TB;
  stage<T>(a_u, a_i, b1, w2, B, P, u0, p0, ai, ab, w2s, nullptr);
  __syncthreads();
  float b2v[4][2], w3v[4][2];
  layer2_params<T>(b2, w3, q, b2v, w3v);
  const float* ai_g = ai + (16 * w + g) * AI_LD;
  const float* ai_g8 = ai_g + 8 * AI_LD;
  const int pg = p0 + 16 * w + g, pg8 = pg + 8;

  float acc[2][16][4];  // dW2: rows j = 16 mj + g (+ 8), columns 8 nf + 2q + (0, 1)
#pragma unroll
  for (int mj = 0; mj < 2; ++mj)
#pragma unroll
    for (int nf = 0; nf < 16; ++nf)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mj][nf][c] = 0.f;

  for (int u = 0; u < TB && u0 + u < B; ++u) {
    const int b = u0 + u;
    float z2[4][4];
    Fr ha[8][4];
    uint64_t mask;
    tower_z2<T>(ab + u * H1, ai_g, ai_g8, w2s, g, q, z2, ha, mask);
    const float dg = score_grad(ds, s, b, pg, B, P), dg8 = score_grad(ds, s, b, pg8, B, P);
    float dz2[4][4];
    layer2_grad(z2, b2v, w3v, dg, dg8, dz2);
    // dz2^T as A fragments over k = the tile's 16 rows: each 8 x 8 block of
    // dz2's accumulator, transposed.
    Fr pc[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      pc[nt][0] = Ops<T>::trans(Ops<T>::pack(dz2[nt][0], dz2[nt][1]));
      pc[nt][1] = Ops<T>::trans(Ops<T>::pack(dz2[nt][2], dz2[nt][3]));
    }
    Fr a[2][4];
#pragma unroll
    for (int mj = 0; mj < 2; ++mj) {
      a[mj][0] = pc[2 * mj][0];
      a[mj][1] = pc[2 * mj + 1][0];
      a[mj][2] = pc[2 * mj][1];
      a[mj][3] = pc[2 * mj + 1][1];
    }
    // h1 as B fragments over the same k: h1's A fragment blocks, transposed.
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      const Fr lo[2] = {Ops<T>::trans(ha[kc][0]), Ops<T>::trans(ha[kc][1])};
      const Fr hi[2] = {Ops<T>::trans(ha[kc][2]), Ops<T>::trans(ha[kc][3])};
#pragma unroll
      for (int mj = 0; mj < 2; ++mj) {
        Ops<T>::mma(acc[mj][2 * kc], a[mj], lo);
        Ops<T>::mma(acc[mj][2 * kc + 1], a[mj], hi);
      }
    }
  }

  // The warps' sums in a fixed tree, in the pool rows' shared memory.
  __syncthreads();
  float* tree = ai;
  for (int half = WARPS / 2; half >= 1; half >>= 1) {
    if (w >= half && w < 2 * half) {
      float* dst = tree + (w - half) * (H2 * H1) + lane;
#pragma unroll
      for (int mj = 0; mj < 2; ++mj)
#pragma unroll
        for (int nf = 0; nf < 16; ++nf)
#pragma unroll
          for (int c = 0; c < 4; ++c) dst[((mj * 16 + nf) * 4 + c) * 32] = acc[mj][nf][c];
    }
    __syncthreads();
    if (w < half) {
      const float* src = tree + w * (H2 * H1) + lane;
#pragma unroll
      for (int mj = 0; mj < 2; ++mj)
#pragma unroll
        for (int nf = 0; nf < 16; ++nf)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mj][nf][c] += src[((mj * 16 + nf) * 4 + c) * 32];
    }
    __syncthreads();
  }
  if (w == 0) {
    float* out = part_w2 + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * (H2 * H1);
#pragma unroll
    for (int mj = 0; mj < 2; ++mj)
#pragma unroll
      for (int nf = 0; nf < 16; ++nf) {
        const int j = 16 * mj + g, col = 8 * nf + 2 * q;
        *reinterpret_cast<float2*>(out + j * H1 + col) =
            make_float2(acc[mj][nf][0], acc[mj][nf][1]);
        *reinterpret_cast<float2*>(out + (j + 8) * H1 + col) =
            make_float2(acc[mj][nf][2], acc[mj][nf][3]);
      }
  }
}

// dst[c] = the sum over r < n of src[r m + c]: thread (x, y) adds rows y,
// y + SUM_ROWS, ... of column c in order, then the SUM_ROWS partial sums
// are added in order of y.
__global__ void __launch_bounds__(32 * SUM_ROWS)
    pred_tower_sum_kernel(const float* __restrict__ src, int n, long long m,
                          float* __restrict__ dst) {
  __shared__ float part[SUM_ROWS][33];
  const long long c = (long long)blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (c < m)
    for (int r = threadIdx.y; r < n; r += SUM_ROWS) v += src[(long long)r * m + c];
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < m) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < SUM_ROWS; ++y) t += part[y][threadIdx.x];
    dst[c] = t;
  }
}

struct Grid {
  int pb, ub;  // blocks along the pool and along the users
  long long u, i, small, w2, total;  // scratch offsets in floats, and its size
};

constexpr long long align64(long long x) { return (x + 63) / 64 * 64; }

Grid grid_of(int B, int P) {
  Grid gr;
  gr.pb = (P + TP - 1) / TP;
  gr.ub = (B + TB - 1) / TB;
  const long long blocks = (long long)gr.pb * gr.ub;
  gr.u = 0;
  gr.i = align64(gr.u + (long long)gr.pb * B * H1);
  gr.small = align64(gr.i + (long long)gr.ub * P * H1);
  gr.w2 = align64(gr.small + blocks * SMALL);
  gr.total = gr.w2 + blocks * H2 * H1;
  return gr;
}

cudaError_t sum_rows(const float* src, int n, long long m, float* dst, cudaStream_t st) {
  const long long blocks = (m + 31) / 32;
  pred_tower_sum_kernel<<<(unsigned)blocks, dim3(32, SUM_ROWS), 0, st>>>(src, n, m, dst);
  return cudaGetLastError();
}

// A pair kernel's dynamic shared memory above 48 KB.  The limit is an
// attribute of the kernel in the current device's context, so it is set
// before every launch (it is not a stream operation, and may be set while a
// CUDA graph captures): one process may launch on several cards.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
cudaError_t fwd(const void* a_u, const void* a_i, const void* b1, const void* w2, const void* b2,
                const void* w3, const void* b3, int B, int P, void* s, cudaStream_t st) {
  const Grid gr = grid_of(B, P);
  const cudaError_t err = allow_smem(pred_tower_fwd_kernel<T>, Smem<T>::fwd);
  if (err != cudaSuccess) return err;
  pred_tower_fwd_kernel<T><<<dim3(gr.pb, gr.ub), NT, Smem<T>::fwd, st>>>(
      static_cast<const float*>(a_u), static_cast<const float*>(a_i),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const T*>(w3), static_cast<const T*>(b3), B, P, static_cast<float*>(s));
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* ds, const void* s, const void* a_u, const void* a_i, const void* b1,
                const void* w2, const void* b2, const void* w3, int B, int P, void* scratch,
                void* da_u, void* da_i, void* dsmall, void* dw2, cudaStream_t st) {
  const Grid gr = grid_of(B, P);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err = allow_smem(pred_tower_bwd_kernel<T>, Smem<T>::bwd);
  if (err == cudaSuccess) err = allow_smem(pred_tower_dw2_kernel<T>, Smem<T>::fwd);
  if (err != cudaSuccess) return err;
  const float *fds = static_cast<const float*>(ds), *fs = static_cast<const float*>(s);
  const float *fau = static_cast<const float*>(a_u), *fai = static_cast<const float*>(a_i);
  const T *tb1 = static_cast<const T*>(b1), *tw2 = static_cast<const T*>(w2);
  const T *tb2 = static_cast<const T*>(b2), *tw3 = static_cast<const T*>(w3);
  pred_tower_bwd_kernel<T><<<dim3(gr.pb, gr.ub), NT, Smem<T>::bwd, st>>>(
      fds, fs, fau, fai, tb1, tw2, tb2, tw3, B, P, sc + gr.u, sc + gr.i, sc + gr.small);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pred_tower_dw2_kernel<T><<<dim3(gr.pb, gr.ub), NT, Smem<T>::fwd, st>>>(
      fds, fs, fau, fai, tb1, tw2, tb2, tw3, B, P, sc + gr.w2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int blocks = gr.pb * gr.ub;
  if ((err = sum_rows(sc + gr.u, gr.pb, (long long)B * H1, static_cast<float*>(da_u), st)))
    return err;
  if ((err = sum_rows(sc + gr.i, gr.ub, (long long)P * H1, static_cast<float*>(da_i), st)))
    return err;
  if ((err = sum_rows(sc + gr.small, blocks, SMALL, static_cast<float*>(dsmall), st)))
    return err;
  return sum_rows(sc + gr.w2, blocks, H2 * H1, static_cast<float*>(dw2), st);
}

bool valid_shape(int B, int P) {
  return B >= 1 && P >= 1 && (B + TB - 1) / TB <= 65535;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The tower's fixed widths, (H1, H2), and the f32 scratch the backward needs.
int pred_tower_widths(int which) { return which == 0 ? H1 : H2; }

long long pred_tower_scratch_floats(int B, int P) { return grid_of(B, P).total; }

// a_u [B, H1] and a_i [P, H1] f32; b1 [H1], w2 [H2, H1], b2 [H2], w3 [H2]
// and b3 [1] in the tower's type (bf16 where is_bf16, else f32); s [B, P]
// f32 out.  Every pointer 16-byte aligned, every tensor contiguous.
int pred_tower_fwd_launch(const void* a_u, const void* a_i, const void* b1, const void* w2,
                          const void* b2, const void* w3, const void* b3, int B, int P,
                          int is_bf16, void* s, void* stream) {
  if (!valid_shape(B, P)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)fwd<bf16>(a_u, a_i, b1, w2, b2, w3, b3, B, P, s, st);
  return (int)fwd<float>(a_u, a_i, b1, w2, b2, w3, b3, B, P, s, st);
}

// ds and s [B, P] f32; the forward's inputs but b3; scratch of
// pred_tower_scratch_floats(B, P) floats.  Out, f32: da_u [B, H1], da_i
// [P, H1], dsmall [H1 + 2 H2 + 1] (db1, db2, dw3, db3) and dw2 [H2, H1].
int pred_tower_bwd_launch(const void* ds, const void* s, const void* a_u, const void* a_i,
                          const void* b1, const void* w2, const void* b2, const void* w3, int B,
                          int P, int is_bf16, void* scratch, void* da_u, void* da_i,
                          void* dsmall, void* dw2, void* stream) {
  if (!valid_shape(B, P)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)bwd<bf16>(ds, s, a_u, a_i, b1, w2, b2, w3, B, P, scratch, da_u, da_i, dsmall,
                          dw2, st);
  return (int)bwd<float>(ds, s, a_u, a_i, b1, w2, b2, w3, B, P, scratch, da_u, da_i, dsmall,
                         dw2, st);
}

}  // extern "C"
