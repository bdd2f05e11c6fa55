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
// for any int32 P and any mask V (P need not be a previous-occurrence
// array, nor V a prefix).
//
// The count, in O(L log L) per row instead of the direct sum_j (j - P[j])
// compares:
//
//   F_j  = #{ k < j : V[k], P[k] <= P[j] }
//   G(x) = #{ k : V[k], max(k, P[k]) <= x }
//   d_j  = F_j - G(P[j])  if 0 <= P[j] < j,  0 if P[j] >= j
//
// (the keys k <= P[j] with P[k] <= P[j] are exactly those that F counts
// and the gap excludes). G is a histogram of max(k, P[k]) over the valid
// positions and its prefix sum. F is the count a merge sort gives on the
// way: sorting the row by the key (P[k], k), with a pad's P taken above
// every int32 so that it never counts, each element of a right run adds
// the number of left-run elements below it; every k < j meets j in exactly
// one merge, as a left-run element. Keys are distinct (the position is in
// the low bits), so a merge is a plain merge of distinct keys.
//
// What bounds it: the bytes of the merge passes. The count's compares,
// n ceil(log2 n) for a row of n real positions, are tens of millions at a
// deployment's sizes; each pass moves 12 bytes a position (the 8-byte key
// and the 4-byte count) in and out. The design keeps as few passes in
// device memory as it can and skips a row's pad tail:
//
//   1. extent_hist: each row's extent n (one past its last valid
//      position; the rest is pads, written -1 at the end) and the
//      histogram of max(k, P[k]) by integer atomics;
//   2. tile_sort: per tile of kTile = 2,048 positions, the first 11 merge
//      levels in shared memory (each element finds its place in the other
//      run by binary search), and the histogram's prefix sum inside the
//      tile;
//   3. tile_prefix: each row's exclusive prefix of the tiles' histogram
//      totals;
//   4. merge_level, once per remaining level (8 at a row of 2^19): each
//      block takes kTile outputs of one merge, finds its two input
//      segments by a merge-path search, merges them in shared memory and
//      stores the result coalesced;
//   5. finish: d_j from the sorted keys and counts, scattered back to j,
//      and -1 past each row's extent.
//
// Everything is exact integer arithmetic and deterministic.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 2048;            // positions a block sorts or merges
constexpr int kThreads = 256;
constexpr int kPer = kTile / kThreads;  // elements a thread
constexpr int kDistInf = INT_MAX;
constexpr int kPosBits = 31;
constexpr u64 kPosMask = (1ull << kPosBits) - 1;
constexpr u64 kPadKey = 1ull << 32;     // above every P, flipped to unsigned
constexpr u64 kFillKey = kPadKey + 1;   // a tile's unused slots, above pads
// Shared memory of tile_sort and merge_level: two buffers of kTile keys
// and counts.
constexpr size_t kSmemBytes = 2 * kTile * (sizeof(u64) + sizeof(int));

// The sort key of position k: (P[k] with its sign bit flipped, or kPadKey
// at a pad) above the position.
__device__ __forceinline__ u64 make_key(int p, bool v, int k) {
  const u64 hi = v ? static_cast<u64>(static_cast<unsigned>(p) ^ 0x80000000u)
                   : kPadKey;
  return (hi << kPosBits) | static_cast<u64>(k);
}

// Number of a[0 .. n) below key (a sorted).
__device__ __forceinline__ int lower_bound(const u64* a, int n, u64 key) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] < key) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// Number of A's elements among the first d of merge(A[0 .. a), B[0 .. b)).
__device__ int merge_split(const u64* A, int a, const u64* B, int b, int d) {
  int lo = max(0, d - b), hi = min(d, a);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(A + mid) < __ldg(B + d - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
extent_hist_kernel(const int* __restrict__ prev,
                   const uint8_t* __restrict__ valid, int* __restrict__ hist,
                   int* __restrict__ extent, int L) {
  __shared__ int s_last[kThreads / 32];
  const int row = blockIdx.y;
  const long long off = static_cast<long long>(row) * L;
  const int base = blockIdx.x * kTile;
  int last = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int k = base + e * kThreads + threadIdx.x;
    if (k < L && valid[off + k]) {
      const int m = max(k, prev[off + k]);
      if (m < L) atomicAdd(hist + off + m, 1);
      last = k + 1;
    }
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) s_last[threadIdx.x >> 5] = last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int w = 0; w < kThreads / 32; ++w) m = max(m, s_last[w]);
    if (m > 0) atomicMax(extent + row, m);
  }
}

// Inclusive prefix sum of hist over the tile, in place; the tile's total
// to tile_sum. Each thread sums kPer consecutive values.
__device__ void scan_hist_tile(int* hist, int* tile_sum, int base, int L,
                               int* s_warp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int k0 = base + tid * kPer;
  int v[kPer];
  int run = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    v[e] = k0 + e < L ? hist[k0 + e] : 0;
    run += v[e];
    v[e] = run;
  }
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = incl - run;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (k0 + e < L) hist[k0 + e] = v[e] + before;
  }
  if (tid == kThreads - 1) *tile_sum = before + run;
}

__global__ void __launch_bounds__(kThreads)
tile_sort_kernel(const int* __restrict__ prev,
                 const uint8_t* __restrict__ valid, int* __restrict__ hist,
                 const int* __restrict__ extent, int* __restrict__ tile_sum,
                 u64* __restrict__ keys, int* __restrict__ counts, int L,
                 int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* sk[2] = {reinterpret_cast<u64*>(smem),
                reinterpret_cast<u64*>(smem) + kTile};
  int* sc[2] = {reinterpret_cast<int*>(smem + 2 * kTile * sizeof(u64)),
                reinterpret_cast<int*>(smem + 2 * kTile * sizeof(u64)) + kTile};
  __shared__ int s_warp[kThreads / 32];
  const int row = blockIdx.y;
  const long long off = static_cast<long long>(row) * L;
  const int base = blockIdx.x * kTile;
  const int n = extent[row];
  int* tsum = tile_sum + static_cast<long long>(row) * n_tiles + blockIdx.x;
  if (base >= n) {
    if (threadIdx.x == 0) *tsum = 0;
    return;
  }
  scan_hist_tile(hist + off, tsum, base, L, s_warp);

  const int cnt = min(kTile, n - base);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int k = base + i;
    sk[0][i] = i < cnt ? make_key(prev[off + k], valid[off + k] != 0, k)
                       : (kFillKey << kPosBits) | static_cast<u64>(i);
    sc[0][i] = 0;
  }
  __syncthreads();
  int cur = 0;
  for (int r = 1; r < kTile; r <<= 1, cur ^= 1) {
    const u64* in = sk[cur];
    const int* ic = sc[cur];
#pragma unroll 2
    for (int e = 0; e < kPer; ++e) {
      const int i = e * kThreads + threadIdx.x;
      const u64 key = in[i];
      const int start = i & ~(2 * r - 1);
      const bool right = (i & r) != 0;
      // Runs are full (the unused slots hold distinct fill keys), so the
      // search runs over r = 2^level elements.
      const u64* other = in + start + (right ? 0 : r);
      int lb = 0;
      for (int half = r >> 1; half > 0; half >>= 1) {
        if (other[lb + half - 1] < key) lb += half;
      }
      if (other[lb] < key) ++lb;
      const int dst = start + (i & (r - 1)) + lb;
      sk[cur ^ 1][dst] = key;
      sc[cur ^ 1][dst] = ic[i] + (right ? lb : 0);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    keys[off + base + i] = sk[cur][i];
    counts[off + base + i] = sc[cur][i];
  }
}

// Exclusive prefix over a row's tile totals, in place (one block a row).
__global__ void __launch_bounds__(kThreads)
tile_prefix_kernel(int* __restrict__ tile_sum, int n_tiles) {
  __shared__ int s_warp[kThreads / 32];
  int* t = tile_sum + static_cast<long long>(blockIdx.x) * n_tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int i0 = 0; i0 < n_tiles; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const int v = i < n_tiles ? t[i] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = carry + incl - v;
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) before += s_warp[w];
      total += s_warp[w];
    }
    if (i < n_tiles) t[i] = before;
    carry += total;
    __syncthreads();
  }
}

// One merge level: runs of length r (a multiple of kTile) merged in pairs.
// Block (tile, row) writes outputs [tile kTile, tile kTile + kTile) of the
// row, all inside one pair.
__global__ void __launch_bounds__(kThreads)
merge_level_kernel(const u64* __restrict__ keys_in,
                   const int* __restrict__ counts_in,
                   u64* __restrict__ keys_out, int* __restrict__ counts_out,
                   const int* __restrict__ extent, int L, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* s_in = reinterpret_cast<u64*>(smem);
  u64* s_out = s_in + kTile;
  int* c_in = reinterpret_cast<int*>(smem + 2 * kTile * sizeof(u64));
  int* c_out = c_in + kTile;
  __shared__ int s_split[2];
  const int row = blockIdx.y;
  const long long off = static_cast<long long>(row) * L;
  const int g0 = blockIdx.x * kTile;
  const int n = extent[row];
  if (g0 >= n) return;
  const int start = g0 & ~(2 * r - 1);
  const int a = min(r, n - start);
  const int b = max(0, min(r, n - start - r));
  const u64* A = keys_in + off + start;
  const u64* B = A + r;
  const int d0 = g0 - start;
  const int d1 = min(d0 + kTile, a + b);
  if (threadIdx.x < 2) {
    s_split[threadIdx.x] =
        merge_split(A, a, B, b, threadIdx.x == 0 ? d0 : d1);
  }
  __syncthreads();
  const int i0 = s_split[0], i1 = s_split[1];
  const int na = i1 - i0, nb = (d1 - i1) - (d0 - i0);
  const int m = na + nb;
  const int* cA = counts_in + off + start;
  const int* cB = cA + r;
  for (int e = threadIdx.x; e < m; e += kThreads) {
    if (e < na) {
      s_in[e] = A[i0 + e];
      c_in[e] = cA[i0 + e];
    } else {
      s_in[e] = B[d0 - i0 + e - na];
      c_in[e] = cB[d0 - i0 + e - na];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < m; e += kThreads) {
    const u64 key = s_in[e];
    if (e < na) {
      const int dst = e + lower_bound(s_in + na, nb, key);
      s_out[dst] = key;
      c_out[dst] = c_in[e];
    } else {
      // Below it: A[0 .. i0) (they precede this segment in the merge) and
      // the lower part of A's segment.
      const int lb = lower_bound(s_in, na, key);
      const int dst = e - na + lb;
      s_out[dst] = key;
      c_out[dst] = c_in[e] + i0 + lb;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < m; e += kThreads) {
    keys_out[off + g0 + e] = s_out[e];
    counts_out[off + g0 + e] = c_out[e];
  }
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const u64* __restrict__ keys, const int* __restrict__ counts,
              const int* __restrict__ hist, const int* __restrict__ tile_sum,
              const int* __restrict__ extent, int* __restrict__ out, int L,
              int n_tiles) {
  const int row = blockIdx.y;
  const long long off = static_cast<long long>(row) * L;
  const int* tpre = tile_sum + static_cast<long long>(row) * n_tiles;
  const int n = extent[row];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int g = blockIdx.x * kTile + e * kThreads + threadIdx.x;
    if (g >= L) break;
    if (g >= n) {
      out[off + g] = -1;  // past the row's last valid position
      continue;
    }
    const u64 key = keys[off + g];
    const int j = static_cast<int>(key & kPosMask);
    const u64 hi = key >> kPosBits;
    int d;
    if (hi >= kPadKey) {
      d = -1;
    } else {
      const int p = static_cast<int>(static_cast<unsigned>(hi) ^ 0x80000000u);
      if (p < 0) {
        d = kDistInf;
      } else if (p >= j) {
        d = 0;
      } else {
        d = counts[off + g] - (hist[off + p] + tpre[p / kTile]);
      }
    }
    out[off + j] = d;
  }
}

// Workspace layout (bytes from its start), for S rows of L.
struct Layout {
  size_t keys0, keys1, counts0, counts1, hist, extent, tile_sum, total;
};

Layout layout(int S, int L) {
  const size_t n = static_cast<size_t>(S) * L;
  const size_t n_tiles = (static_cast<size_t>(L) + kTile - 1) / kTile;
  Layout w;
  w.keys0 = 0;
  w.keys1 = w.keys0 + n * sizeof(u64);
  w.counts0 = w.keys1 + n * sizeof(u64);
  w.counts1 = w.counts0 + n * sizeof(int);
  w.hist = w.counts1 + n * sizeof(int);  // hist and extent are zeroed
  w.extent = w.hist + n * sizeof(int);
  w.tile_sum = w.extent + static_cast<size_t>(S) * sizeof(int);
  w.total = w.tile_sum + static_cast<size_t>(S) * n_tiles * sizeof(int);
  return w;
}

}  // namespace

extern "C" {

const char* reuse_distance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of device scratch reuse_distance_launch needs for S rows of L.
long long reuse_distance_workspace_bytes(int S, int L) {
  return static_cast<long long>(layout(S, L).total);
}

// prev int32 [S, L], valid uint8 [S, L], out int32 [S, L], all row-major on
// the device; work: reuse_distance_workspace_bytes(S, L) bytes, 16-byte
// aligned. Launches on `stream`; returns the first launch error.
int reuse_distance_launch(const int* prev, const uint8_t* valid, int* out,
                          void* work, int S, int L, void* stream) {
  if (S <= 0 || L <= 0) return 0;
  if (S > 65535 || L > INT_MAX - kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout w = layout(S, L);
  char* base = static_cast<char*>(work);
  u64* keys[2] = {reinterpret_cast<u64*>(base + w.keys0),
                  reinterpret_cast<u64*>(base + w.keys1)};
  int* counts[2] = {reinterpret_cast<int*>(base + w.counts0),
                    reinterpret_cast<int*>(base + w.counts1)};
  int* hist = reinterpret_cast<int*>(base + w.hist);
  int* extent = reinterpret_cast<int*>(base + w.extent);
  int* tile_sum = reinterpret_cast<int*>(base + w.tile_sum);
  const int n_tiles = (L + kTile - 1) / kTile;
  const dim3 grid(n_tiles, S);
  cudaError_t err;
  err = cudaMemsetAsync(hist, 0, w.tile_sum - w.hist, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(tile_sort_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(merge_level_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);

  extent_hist_kernel<<<grid, kThreads, 0, st>>>(prev, valid, hist, extent, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  tile_sort_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      prev, valid, hist, extent, tile_sum, keys[0], counts[0], L, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  tile_prefix_kernel<<<S, kThreads, 0, st>>>(tile_sum, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  int cur = 0;
  for (long long r = kTile; r < L; r *= 2, cur ^= 1) {
    merge_level_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        keys[cur], counts[cur], keys[cur ^ 1], counts[cur ^ 1], extent, L,
        static_cast<int>(r));
    if ((err = cudaGetLastError()) != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  finish_kernel<<<grid, kThreads, 0, st>>>(keys[cur], counts[cur], hist,
                                           tile_sum, extent, out, L, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
