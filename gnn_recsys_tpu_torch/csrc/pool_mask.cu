// Dense-pool false-negative mask for Hopper (sm_90a).
//
// Replaces pool_membership_mask of gnn_recsys_tpu/ops/pallas/pool_mask.py
// (_kernel, pool_mask.py:31):
//
//   out[b, p] = 1.0 if pool[p] is among rows[b, 0..K) and pool[p] >= 0
//
// rows [B, K] int32 are the padded already-seen rows of the batch's users
// (-1 padding never matches), pool [P] int32 the step's negative pool, out
// [B, P] f32 the mask the max-margin loss subtracts.
//
// What bounds it.  The function writes B*P floats (10.5 MB at B=1024,
// P=2560) and reads only B*K + P ints, so the output write bounds it at
// 3.35 TB/s; the B*P*K int compares are about as many operations as the
// card's integer units retire in that time.
//
// The simple design.  A block of TP=256 threads owns TP pool entries (one a
// thread, held in a register) and TB=32 rows, staged in shared memory.  A
// thread compares its entry against each staged row, K slots a row; every
// thread of a warp reads the same slot, so the shared-memory reads are
// broadcasts.  The writes of one row go out coalesced along P.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 256;  // pool entries per block, one per thread
constexpr int TB = 32;   // rows per block

__global__ void __launch_bounds__(TP)
pool_mask_kernel(const int* __restrict__ rows, const int* __restrict__ pool, int B, int K,
                 int P, float* __restrict__ out) {
  extern __shared__ int srows[];  // [TB][K]
  const int b0 = blockIdx.y * TB;
  const int nb = min(TB, B - b0);
  const int* src = rows + (size_t)b0 * K;
  for (int i = threadIdx.x; i < nb * K; i += TP) srows[i] = src[i];
  __syncthreads();
  const int p = blockIdx.x * TP + threadIdx.x;
  if (p >= P) return;
  const int v = pool[p];
  const bool valid = v >= 0;
  for (int r = 0; r < nb; ++r) {
    const int* row = srows + r * K;
    bool hit = false;
    for (int j = 0; j < K; ++j) hit |= row[j] == v;
    out[(size_t)(b0 + r) * P + p] = (hit && valid) ? 1.f : 0.f;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pool_mask_launch(const void* rows, const void* pool, int B, int K, int P, void* out,
                     void* stream) {
  const dim3 grid((P + TP - 1) / TP, (B + TB - 1) / TB);
  pool_mask_kernel<<<grid, TP, TB * K * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(pool), B, K, P,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
