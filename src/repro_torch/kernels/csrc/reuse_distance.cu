// Reuse distances (Mattson LRU stack distances) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/reuse_distance.py:
// reuse_distance_kernel (body _dominance_kernel) and computes exactly the
// integers of the plain PyTorch version repro_torch/kernels/ref.py:
// reuse_distance_ref. Per row s and position j, with P = prev[s] and
// V = valid[s]:
//
//   d_j = #{ k : P[j] < k < j, P[k] <= P[j], V[k] }   if V[j] and P[j] >= 0
//   d_j = 2^31 - 1 (DIST_INF)                          if V[j] and P[j] < 0
//   d_j = -1                                           if not V[j] (a pad)
//
// A first access inside a gap (P[k] = -1) counts: it is a distinct page.
//
// What bounds it: the compares. A direct count needs sum_j (j - P[j] - 1)
// of them over the reused positions, which at a deployment's row lengths is
// hundreds of times the 9 bytes a position the kernel must move. The design:
// one block of 256 threads per (row, query tile of 256 positions), one
// thread per query. The block stages the row's keys through shared memory,
// 2,048 at a time, as one int each (P[k], or INT_MAX at a pad so that it
// never counts), starting at the smallest P[j] + 1 among its queries and
// ending at its largest j; tiles holding only first accesses and pads scan
// nothing. Each warp walks the union of its lanes' key ranges with one
// broadcast shared-memory read a key and a predicated add a lane. Blocks of
// late query tiles (the longest scans) are launched first.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQueries = 256;   // threads a block, one query each
constexpr int kKeys = 2048;     // keys staged in shared memory at a time
constexpr int kWarps = kQueries / 32;
constexpr int kDistInf = INT_MAX;

__global__ void __launch_bounds__(kQueries)
reuse_distance_kernel(const int* __restrict__ prev,
                      const uint8_t* __restrict__ valid,
                      int* __restrict__ out, int S, int L, int n_tiles) {
  __shared__ int s_keys[kKeys];
  __shared__ int s_lo[kWarps];
  __shared__ int s_hi[kWarps];

  // Linear block b: row b % S, query tile counted from the row's end.
  const long long b = blockIdx.x;
  const int row = static_cast<int>(b % S);
  const int tile = n_tiles - 1 - static_cast<int>(b / S);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j = tile * kQueries + tid;
  const int* P = prev + static_cast<long long>(row) * L;
  const uint8_t* V = valid + static_cast<long long>(row) * L;

  int pj = -1;
  bool vj = false;
  if (j < L) {
    pj = P[j];
    vj = V[j] != 0;
  }
  const bool scan = vj && pj >= 0;
  // Keys k in [pj + 1, j) of the scanning lanes; empty for the others.
  int lo = scan ? pj + 1 : INT_MAX;
  int hi = scan ? j : INT_MIN;
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  const int w_lo = lo, w_hi = hi;  // this warp's key range
  int b_lo = INT_MAX, b_hi = INT_MIN;  // the block's
  for (int w = 0; w < kWarps; ++w) {
    b_lo = min(b_lo, s_lo[w]);
    b_hi = max(b_hi, s_hi[w]);
  }

  int count = 0;
  for (int k0 = b_lo; k0 < b_hi; k0 += kKeys) {
    const int n = min(kKeys, b_hi - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < n; i += kQueries) {
      const int k = k0 + i;
      s_keys[i] = V[k] ? P[k] : INT_MAX;
    }
    __syncthreads();
    const int a = max(w_lo, k0), e = min(w_hi, k0 + n);
#pragma unroll 8
    for (int k = a; k < e; ++k) {
      const int pk = s_keys[k - k0];
      count += (k > pj) & (k < j) & (pk <= pj);
    }
  }
  if (j < L) {
    out[static_cast<long long>(row) * L + j] =
        vj ? (pj >= 0 ? count : kDistInf) : -1;
  }
}

}  // namespace

extern "C" {

const char* reuse_distance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// prev int32 [S, L], valid uint8 [S, L], out int32 [S, L], all row-major on
// the device. Launches on `stream`; returns cudaGetLastError().
int reuse_distance_launch(const int* prev, const uint8_t* valid, int* out,
                          int S, int L, void* stream) {
  const int n_tiles = (L + kQueries - 1) / kQueries;
  const long long blocks = static_cast<long long>(S) * n_tiles;
  if (blocks <= 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  reuse_distance_kernel<<<static_cast<unsigned>(blocks), kQueries, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      prev, valid, out, S, L, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
