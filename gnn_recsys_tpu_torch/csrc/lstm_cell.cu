// The masked LSTM reducer's cell update for Hopper (sm_90a), forward and
// backward.
//
// Replaces no Pallas kernel.  The JAX package's MaskedLSTMReducer
// (gnn_recsys_tpu/models/layers.py:79-109) is a plain nn.scan of flax's
// LSTMCell, which XLA fuses on the TPU.  Run as PyTorch operations, one slot
// of the port's reducer took about 30 launches forward and 50 backward, each
// reading and writing a whole [N, H] or [N, 4H] tensor.  These two kernels
// are a slot's gate math and carry update (the wrappers are
// gnn_recsys_tpu_torch/ops/cuda/lstm_cell.py); the slot's two products stay
// cuBLAS GEMMs, and autograd keeps their backward.
//
// Forward, for each row n < N and column j < H (gates packed i, f, g, o
// along 4H):
//
//   z_q = xw[n, qH + j] + (hw[n, qH + j] + b[qH + j])
//   i = sigma(z_i)   f = sigma(z_f)   g = tanh(z_g)   o = sigma(z_o)
//   c' = f c + i g   h' = o tanh(c')
//   c_out, h_out = c', h' where mask[n], else c, h (the carry stays)
//
// and, where a gradient will be taken, the activations (i, f, g, o) into
// acts [N, 4H].  The backward takes dh' and dc' (either may be absent: a
// zero), acts, c, c' and the mask, and writes
//
//   dc~ = dc' + dh' o (1 - tanh(c')^2)
//   dz = (dc~ g i (1 - i), dc~ c f (1 - f), dc~ i (1 - g^2), dh' tanh(c') o (1 - o))
//   dc = dc~ f,   dh = 0   where mask[n];   dz = 0, dc = dc', dh = dh' elsewhere
//
// (dh is the pass-through part; autograd adds dz W_hh from the GEMM).
//
// Types: the gates (xw, hw, b, acts, dz) are TG and the carry (c, h and
// their gradients) TC, f32 or bf16, with TC = TG or f32.  The forward rounds
// where the port's plain cell (PyTorch operations) rounds: each operation's
// result in the promoted type of its operands.  In bf16 that is the bias
// sum, the gate sum, each of sigma = 1 / (1 + exp(-z))'s three operations
// (XLA's expansion of lax.logistic, which flax's bf16 cell equals bit for
// bit), tanh, and each product and sum of the carry; in f32 it is
// torch.sigmoid's 1 / (1 + exp(-z)).  Every product and sum is __fmul_rn /
// __fadd_rn, which the compiler never fuses into an FMA, and exp and tanh
// are expf and tanhf, as PyTorch's kernels call them: the forward equals
// the plain one bit for bit up to a rare ulp of those two functions.  The
// backward computes in f32 and rounds only its outputs; its products and
// sums are the plain backward's, in its order and unfused, so it too equals
// the plain one up to a rare ulp of tanhf.
//
// What bounds them: bytes, a few operations for every 2 or 4 bytes moved.
// The least a cell update must move is 21 H elements a row: forward the 4H
// pre-activations and the carry (2H) in and the carry (2H) out; backward
// the pre-activations, c, dh' and dc' in (7H) and dz, dc and dh out (6H).
// This design moves 30 H (at best 70% of that bound): the gate sum arrives
// as its two rounded products (the plain cell rounds each before the sum,
// +4H), and the forward writes the four activations for the backward, which
// reads them and c' in place of the pre-activations (+5H).  What its design
// does about the bytes: one pass.  A thread takes VEC consecutive columns of
// one row (16 bytes of each gate: 8 bf16 or 4 f32), reads every operand
// with 16-byte loads, keeps every intermediate in registers and writes
// every result with 16-byte stores; no shared memory, nothing passes
// between threads.  A masked row reads no gate and no activation: it copies
// its carry forward and its carry's gradients backward, and writes a zero
// dz.  Where H is not a multiple of VEC or a pointer is not aligned to its
// vector, the scalar instantiation (VEC = 1) runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads a block

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T, as a PyTorch operation whose result is a T rounds it.
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// VEC elements moved as one (or, for 32 bytes, two) 16-byte access.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const Pack<T, N>& x) {
  *reinterpret_cast<Pack<T, N>*>(p) = x;
}

// dh' or dc' where the caller has one, else zeros.
template <typename T, int N>
__device__ __forceinline__ void load_or_zero(const T* p, long long i, float (&out)[N]) {
  if (p != nullptr) {
    const Pack<T, N> x = load<T, N>(p + i);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f(x.v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = 0.0f;
  }
}

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> pack(const float (&x)[N]) {
  Pack<T, N> out;
#pragma unroll
  for (int e = 0; e < N; ++e) out.v[e] = from_f<T>(x[e]);
  return out;
}

// A gate's sigmoid in TG: 1 / (1 + exp(-z)), each operation rounded to TG.
template <typename TG>
__device__ __forceinline__ float gate_sigmoid(float z) {
  const float e = rnd<TG>(expf(-z));
  const float d = rnd<TG>(__fadd_rn(1.0f, e));
  return rnd<TG>(__fdiv_rn(1.0f, d));
}

template <typename TG, typename TC, int VEC>
__global__ void __launch_bounds__(NT)
lstm_cell_fwd_kernel(const TG* __restrict__ xw, const TG* __restrict__ hw,
                     const TG* __restrict__ bias, const TC* __restrict__ c,
                     const TC* __restrict__ h, const uint8_t* __restrict__ mask,
                     long long mask_stride, int N, int H, TC* __restrict__ c_out,
                     TC* __restrict__ h_out, TG* __restrict__ acts) {
  const int per_row = H / VEC;
  const long long t = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (t >= static_cast<long long>(N) * per_row) return;
  const int n = static_cast<int>(t / per_row);
  const int j = static_cast<int>(t - static_cast<long long>(n) * per_row) * VEC;
  const long long ci = static_cast<long long>(n) * H + j;
  const Pack<TC, VEC> cv = load<TC, VEC>(c + ci);
  const Pack<TC, VEC> hv = load<TC, VEC>(h + ci);
  if (!mask[n * mask_stride]) {
    store(c_out + ci, cv);
    store(h_out + ci, hv);
    return;
  }
  const long long gi = static_cast<long long>(n) * 4 * H + j;
  float z[4][VEC];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const Pack<TG, VEC> xq = load<TG, VEC>(xw + gi + q * H);
    const Pack<TG, VEC> hq = load<TG, VEC>(hw + gi + q * H);
    const Pack<TG, VEC> bq = load<TG, VEC>(bias + q * H + j);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float rec = rnd<TG>(__fadd_rn(to_f(hq.v[e]), to_f(bq.v[e])));
      z[q][e] = rnd<TG>(__fadd_rn(to_f(xq.v[e]), rec));
    }
  }
  float act[4][VEC], cn[VEC], hn[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float i = gate_sigmoid<TG>(z[0][e]);
    const float f = gate_sigmoid<TG>(z[1][e]);
    const float g = rnd<TG>(tanhf(z[2][e]));
    const float o = gate_sigmoid<TG>(z[3][e]);
    // f c is TC (TC is TG or f32, the promoted type); i g is TG.
    const float fc = rnd<TC>(__fmul_rn(f, to_f(cv.v[e])));
    const float ig = rnd<TG>(__fmul_rn(i, g));
    cn[e] = rnd<TC>(__fadd_rn(fc, ig));
    hn[e] = rnd<TC>(__fmul_rn(o, rnd<TC>(tanhf(cn[e]))));
    act[0][e] = i;
    act[1][e] = f;
    act[2][e] = g;
    act[3][e] = o;
  }
  store(c_out + ci, pack<TC, VEC>(cn));
  store(h_out + ci, pack<TC, VEC>(hn));
  if (acts != nullptr) {
#pragma unroll
    for (int q = 0; q < 4; ++q) store(acts + gi + q * H, pack<TG, VEC>(act[q]));
  }
}

template <typename TG, typename TC, int VEC>
__global__ void __launch_bounds__(NT)
lstm_cell_bwd_kernel(const TG* __restrict__ acts, const TC* __restrict__ c,
                     const TC* __restrict__ c_new, const uint8_t* __restrict__ mask,
                     long long mask_stride, const TC* __restrict__ dh_new,
                     const TC* __restrict__ dc_new, int N, int H, TG* __restrict__ dz,
                     TC* __restrict__ dc, TC* __restrict__ dh) {
  const int per_row = H / VEC;
  const long long t = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (t >= static_cast<long long>(N) * per_row) return;
  const int n = static_cast<int>(t / per_row);
  const int j = static_cast<int>(t - static_cast<long long>(n) * per_row) * VEC;
  const long long ci = static_cast<long long>(n) * H + j;
  const long long gi = static_cast<long long>(n) * 4 * H + j;
  float dhv[VEC], dcv[VEC];
  load_or_zero<TC, VEC>(dh_new, ci, dhv);
  load_or_zero<TC, VEC>(dc_new, ci, dcv);
  if (!mask[n * mask_stride]) {
    float zero[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) zero[e] = 0.0f;
    const Pack<TG, VEC> zg = pack<TG, VEC>(zero);
#pragma unroll
    for (int q = 0; q < 4; ++q) store(dz + gi + q * H, zg);
    store(dc + ci, pack<TC, VEC>(dcv));
    store(dh + ci, pack<TC, VEC>(dhv));
    return;
  }
  const Pack<TG, VEC> ai = load<TG, VEC>(acts + gi);
  const Pack<TG, VEC> af = load<TG, VEC>(acts + gi + H);
  const Pack<TG, VEC> ag = load<TG, VEC>(acts + gi + 2 * H);
  const Pack<TG, VEC> ao = load<TG, VEC>(acts + gi + 3 * H);
  const Pack<TC, VEC> cv = load<TC, VEC>(c + ci);
  const Pack<TC, VEC> cnv = load<TC, VEC>(c_new + ci);
  float d[4][VEC], dco[VEC], dho[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float i = to_f(ai.v[e]), f = to_f(af.v[e]), g = to_f(ag.v[e]), o = to_f(ao.v[e]);
    const float tc = tanhf(to_f(cnv.v[e]));
    const float dct =
        __fadd_rn(dcv[e], __fmul_rn(__fmul_rn(dhv[e], o), __fsub_rn(1.0f, __fmul_rn(tc, tc))));
    d[0][e] = __fmul_rn(__fmul_rn(__fmul_rn(dct, g), i), __fsub_rn(1.0f, i));
    d[1][e] = __fmul_rn(__fmul_rn(__fmul_rn(dct, to_f(cv.v[e])), f), __fsub_rn(1.0f, f));
    d[2][e] = __fmul_rn(__fmul_rn(dct, i), __fsub_rn(1.0f, __fmul_rn(g, g)));
    d[3][e] = __fmul_rn(__fmul_rn(__fmul_rn(dhv[e], tc), o), __fsub_rn(1.0f, o));
    dco[e] = __fmul_rn(dct, f);
    dho[e] = 0.0f;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) store(dz + gi + q * H, pack<TG, VEC>(d[q]));
  store(dc + ci, pack<TC, VEC>(dco));
  store(dh + ci, pack<TC, VEC>(dho));
}

bool aligned(const void* p, size_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

unsigned blocks(int N, int H, int vec) {
  const long long threads = static_cast<long long>(N) * (H / vec);
  return static_cast<unsigned>((threads + NT - 1) / NT);
}

template <typename TG, typename TC>
cudaError_t fwd(const void* xw, const void* hw, const void* bias, const void* c, const void* h,
                const void* mask, long long mask_stride, int N, int H, void* c_out, void* h_out,
                void* acts, cudaStream_t st) {
  constexpr int V = 16 / sizeof(TG);
  const bool vec = H % V == 0 && aligned(xw, 16) && aligned(hw, 16) && aligned(bias, 16) &&
                   aligned(acts, 16) && aligned(c, V * sizeof(TC)) &&
                   aligned(h, V * sizeof(TC)) && aligned(c_out, V * sizeof(TC)) &&
                   aligned(h_out, V * sizeof(TC));
#define LSTM_FWD(VEC_)                                                                       \
  lstm_cell_fwd_kernel<TG, TC, VEC_><<<blocks(N, H, VEC_), NT, 0, st>>>(                     \
      static_cast<const TG*>(xw), static_cast<const TG*>(hw), static_cast<const TG*>(bias), \
      static_cast<const TC*>(c), static_cast<const TC*>(h),                                  \
      static_cast<const uint8_t*>(mask), mask_stride, N, H, static_cast<TC*>(c_out),         \
      static_cast<TC*>(h_out), static_cast<TG*>(acts))
  if (vec)
    LSTM_FWD(V);
  else
    LSTM_FWD(1);
#undef LSTM_FWD
  return cudaGetLastError();
}

template <typename TG, typename TC>
cudaError_t bwd(const void* acts, const void* c, const void* c_new, const void* mask,
                long long mask_stride, const void* dh_new, const void* dc_new, int N, int H,
                void* dz, void* dc, void* dh, cudaStream_t st) {
  constexpr int V = 16 / sizeof(TG);
  const bool vec = H % V == 0 && aligned(acts, 16) && aligned(dz, 16) &&
                   aligned(c, V * sizeof(TC)) && aligned(c_new, V * sizeof(TC)) &&
                   aligned(dh_new, V * sizeof(TC)) && aligned(dc_new, V * sizeof(TC)) &&
                   aligned(dc, V * sizeof(TC)) && aligned(dh, V * sizeof(TC));
#define LSTM_BWD(VEC_)                                                                      \
  lstm_cell_bwd_kernel<TG, TC, VEC_><<<blocks(N, H, VEC_), NT, 0, st>>>(                    \
      static_cast<const TG*>(acts), static_cast<const TC*>(c), static_cast<const TC*>(c_new), \
      static_cast<const uint8_t*>(mask), mask_stride, static_cast<const TC*>(dh_new),       \
      static_cast<const TC*>(dc_new), N, H, static_cast<TG*>(dz), static_cast<TC*>(dc),     \
      static_cast<TC*>(dh))
  if (vec)
    LSTM_BWD(V);
  else
    LSTM_BWD(1);
#undef LSTM_BWD
  return cudaGetLastError();
}

// The (gate, carry) types the kernels take: (bf16, bf16), (f32, f32),
// (bf16, f32).
bool valid_types(int gate_bf16, int carry_bf16) { return gate_bf16 || !carry_bf16; }

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// acts may be null (no gradient will be taken: nothing is saved).  The mask
// is N bytes, row n at mask[n * mask_stride].
int lstm_cell_fwd_launch(const void* xw, const void* hw, const void* bias, const void* c,
                         const void* h, const void* mask, long long mask_stride, int N, int H,
                         int gate_bf16, int carry_bf16, void* c_out, void* h_out, void* acts,
                         void* stream) {
  if (N < 1 || H < 1 || !valid_types(gate_bf16, carry_bf16)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!gate_bf16)
    return (int)fwd<float, float>(xw, hw, bias, c, h, mask, mask_stride, N, H, c_out, h_out,
                                  acts, st);
  if (carry_bf16)
    return (int)fwd<bf16, bf16>(xw, hw, bias, c, h, mask, mask_stride, N, H, c_out, h_out,
                                acts, st);
  return (int)fwd<bf16, float>(xw, hw, bias, c, h, mask, mask_stride, N, H, c_out, h_out, acts,
                               st);
}

// dh_new and dc_new may be null (that output took no gradient: a zero).
int lstm_cell_bwd_launch(const void* acts, const void* c, const void* c_new, const void* mask,
                         long long mask_stride, const void* dh_new, const void* dc_new, int N,
                         int H, int gate_bf16, int carry_bf16, void* dz, void* dc, void* dh,
                         void* stream) {
  if (N < 1 || H < 1 || !valid_types(gate_bf16, carry_bf16)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!gate_bf16)
    return (int)bwd<float, float>(acts, c, c_new, mask, mask_stride, dh_new, dc_new, N, H, dz,
                                  dc, dh, st);
  if (carry_bf16)
    return (int)bwd<bf16, bf16>(acts, c, c_new, mask, mask_stride, dh_new, dc_new, N, H, dz, dc,
                                dh, st);
  return (int)bwd<bf16, float>(acts, c, c_new, mask, mask_stride, dh_new, dc_new, N, H, dz, dc,
                               dh, st);
}

}  // extern "C"
