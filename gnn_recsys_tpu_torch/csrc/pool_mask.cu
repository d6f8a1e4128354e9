// Dense-pool false-negative mask for Hopper (sm_90a).
//
// Replaces pool_membership_mask of gnn_recsys_tpu/ops/pallas/pool_mask.py
// (_kernel, pool_mask.py:31):
//
//   out[b, p] = 1.0 if pool[p] is among rows[b, 0..K) and pool[p] >= 0
//
// rows [B, K] int32 are the padded already-seen rows of the batch's users
// (-1 padding never matches), pool [P] int32 the step's negative pool, out
// [B, P] f32 the mask the max-margin loss subtracts.  Pool entries and row
// slots may repeat.
//
// What bounds it.  The function writes B*P floats (10.5 MB at B=1024,
// P=2560) and reads only B*K + P ints, so the output write bounds it at
// 3.35 TB/s.  Comparing every pool entry with every row slot is B*P*K
// compares (84M at K=32): about as long as the write on the card's integer
// units, so a compare loop cannot come near the bound.
//
// The design: a small hash set per row.  A block owns TB rows and TP pool
// positions.  It builds each of its rows as an open-addressed set in shared
// memory (a power of two of slots: 32K, or 2048 where that is fewer, but
// never under 16K, so a set is at most a sixteenth full; -1 marks an empty slot, negative ids are not inserted) with
// atomicCAS and linear probing, behind one barrier.  A thread owns VEC
// consecutive pool positions, held in registers with their home slots, and
// for each row probes that row's set once per position (most probes end at
// their first slot) and writes the row's VEC outputs with one 16-byte store
// (a scalar tail where P % 4 != 0 or the row's start is not 16-byte
// aligned).  The pool is cut into equal chunks of at most TP positions, one
// a block column, so that every block writes as much as every other; with
// TB = 4 and 32 registers a thread, the whole grid of the training shape is
// resident at once.
// Work falls from B*P*K compares to about B*P probes, so the write sets the
// pace.  If every id hashes to one slot a probe takes up to K reads, no
// worse than the compare loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;                  // pool positions a thread: one float4 a row
constexpr int TP = THREADS * VEC;       // pool positions a block, at most
constexpr int TB = 4;                   // rows a block
constexpr int MAX_K = 128;              // widest row (the wrapper's MAX_ROW)
constexpr int ROW_LOADS = (TB * MAX_K + THREADS - 1) / THREADS;

// Multiplicative hash of an id into a set of 2^(32 - shift) slots.
__device__ __forceinline__ unsigned home_slot(int id, int shift) {
  return (static_cast<unsigned>(id) * 0x9E3779B1u) >> shift;
}

__global__ void __launch_bounds__(THREADS)
pool_mask_kernel(const int* __restrict__ rows, const int* __restrict__ pool, int B, int K,
                 int P, int chunk, int slots, float* __restrict__ out) {
  extern __shared__ int sets[];  // [TB][slots]
  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * TB;
  const int nb = min(TB, B - b0);
  const int shift = 32 - (__ffs(slots) - 1);
  const unsigned wrap = static_cast<unsigned>(slots - 1);

  // Loads first, so that their latencies overlap: this thread's pool
  // positions (the block owns [x * chunk, (x + 1) * chunk)) and its share
  // of the block's row slots.
  const int p0 = blockIdx.x * chunk + tid * VEC;
  const int p_end = min(P, (blockIdx.x + 1) * chunk);
  int v[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) v[q] = p0 + q < p_end ? pool[p0 + q] : -1;
  const int* src = rows + static_cast<size_t>(b0) * K;
  int ids[ROW_LOADS];
#pragma unroll
  for (int j = 0; j < ROW_LOADS; ++j) {
    const int i = j * THREADS + tid;
    ids[j] = i < nb * K ? src[i] : -1;
  }
  for (int i = tid; i < TB * slots; i += THREADS) sets[i] = -1;
  __syncthreads();

#pragma unroll
  for (int j = 0; j < ROW_LOADS; ++j) {
    const int id = ids[j];
    if (id < 0) continue;
    int* set = sets + ((j * THREADS + tid) / K) * slots;
    unsigned s = home_slot(id, shift);
    while (true) {
      const int old = atomicCAS(&set[s], -1, id);
      if (old == -1 || old == id) break;
      s = (s + 1) & wrap;
    }
  }
  __syncthreads();
  if (p0 >= p_end) return;

  unsigned home[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) home[q] = v[q] >= 0 ? home_slot(v[q], shift) : 0u;
  const bool vec_ok = p0 + VEC <= p_end;
  for (int r = 0; r < nb; ++r) {
    const int* set = sets + r * slots;
    float o[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      o[q] = 0.f;
      if (v[q] < 0) continue;
      unsigned s = home[q];
      while (true) {
        const int x = set[s];
        if (x == v[q]) {
          o[q] = 1.f;
          break;
        }
        if (x < 0) break;
        s = (s + 1) & wrap;
      }
    }
    float* dst = out + static_cast<size_t>(b0 + r) * P + p0;
    if (vec_ok && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        if (p0 + q < p_end) dst[q] = o[q];
    }
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The kernel's tile: rows and pool positions a block (the host's geometry
// must use the same).
int pool_mask_tile(int* out) {
  out[0] = TB;
  out[1] = TP;
  return 0;
}

// grid_x blocks along the pool, chunk positions each (a multiple of VEC, at
// most TP), and grid_y along the rows; slots a row's set (a power of two, at
// least 16K; TB sets must fit the 48 KB a launch gets without opting in).
int pool_mask_launch(const void* rows, const void* pool, int B, int K, int P, int grid_x,
                     int chunk, int grid_y, int slots, void* out, void* stream) {
  if (K < 1 || K > MAX_K || slots < 16 * K || TB * slots * 4 > 48 * 1024 || (slots & (slots - 1)) || chunk % VEC ||
      chunk > TP || grid_x * chunk < P)
    return (int)cudaErrorInvalidValue;
  pool_mask_kernel<<<dim3(grid_x, grid_y), THREADS, TB * slots * sizeof(int),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(pool), B, K, P, chunk, slots,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
