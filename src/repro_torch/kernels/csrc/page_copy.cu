// Batched page copy between pool rows for Hopper (sm_90a):
//
//   dst[dst_idx[i]] = src[src_idx[i]]   for each pair i with both >= 0,
//
// in place. Replaces the Pallas TPU kernel repro/kernels/page_gather.py:
// page_copy (one grid step per pair, the destination aliased in and out);
// the plain PyTorch version is repro_torch/kernels/ref.py: page_copy_ref.
//
// A row is `row_bytes` contiguous bytes; consecutive rows of dst and of
// src lie `dst_stride` and `src_stride` bytes apart. So one layer's slice
// of a pool slot is a row (prefill population: the row stride is the
// slot's, the base pointer is the layer's), and so is a whole slot
// (write-back on eviction, promotion), and so is an int8 pool's f32 scale
// row. Destinations must be unique and must not overlap the source rows:
// pairs run in no order. A pair with a -1, or an index out of its pool's
// rows, copies nothing. Offsets are 64-bit: a slot times the stride of an
// 80 GB pool exceeds 2^31.
//
// What bounds it: bytes, each moved byte read once and written once. What
// the design does about it: a persistent schedule keeps enough bytes in
// flight on every SM whatever the number of pairs. The work is a flat list
// of items, one item a chunk (at most 16 KiB) of one pair's row; a grid of
// a few blocks an SM walks it with a grid-stride loop (the host's plan,
// kernels/page_gather.py: copy_plan, picks the path, the chunk and the
// grid from the SM count, the row size and the alignment). Two paths:
//
// - vector: each thread keeps kUnroll independent 16-byte loads in flight
//   (ld.global.nc, no L1 allocation) before its streaming stores
//   (st.global.cs), so a block of 128 threads holds a whole 16 KiB chunk
//   in registers. Needs 16-byte-aligned bases and strides and a row of a
//   multiple of 16 bytes.
// - bytes: rows that break the 16-byte rule, a byte a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Path { kBytes = 0, kVector = 1 };

constexpr int kThreads = 128;
constexpr int kUnroll = 8;  // 128 x 8 x 16 B = 16 KiB in flight a block

struct Args {
  char* dst;
  const char* src;
  const int* dst_idx;
  const int* src_idx;
  long long n, row_bytes, dst_stride, src_stride;
  int dst_rows, src_rows;
  long long chunk, chunks;  // a row's chunks of `chunk` bytes (last ragged)
};

// Pair p's destination and source rows; false for a pair that copies
// nothing.
__device__ __forceinline__ bool rows_of(const Args& a, long long p, char*& d,
                                        const char*& s) {
  const int di = __ldg(a.dst_idx + p), si = __ldg(a.src_idx + p);
  if (di < 0 || si < 0 || di >= a.dst_rows || si >= a.src_rows) return false;
  d = a.dst + di * a.dst_stride;
  s = a.src + si * a.src_stride;
  return true;
}

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
copy_bytes(Args a) {
  const long long items = a.n * a.chunks;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    char* d;
    const char* s;
    if (!rows_of(a, it / a.chunks, d, s)) continue;
    const long long lo = (it % a.chunks) * a.chunk;
    const long long hi = min(lo + a.chunk, a.row_bytes);
    for (long long b = lo + threadIdx.x; b < hi; b += kThreads) d[b] = s[b];
  }
}

__global__ void __launch_bounds__(kThreads)
copy_vector(Args a) {
  const long long items = a.n * a.chunks;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    char* d;
    const char* s;
    if (!rows_of(a, it / a.chunks, d, s)) continue;
    const long long lo = (it % a.chunks) * a.chunk;
    const long long nv = (min(lo + a.chunk, a.row_bytes) - lo) / 16;
    const uint4* sv = reinterpret_cast<const uint4*>(s + lo);
    uint4* dv = reinterpret_cast<uint4*>(d + lo);
    for (long long base = threadIdx.x; base < nv;
         base += kThreads * kUnroll) {
      uint4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = base + u * kThreads;
        if (v < nv) r[u] = load_stream(sv + v);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = base + u * kThreads;
        if (v < nv) store_stream(dv + v, r[u]);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* page_copy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dst/src: device pointers to row 0; dst_idx/src_idx: int32 [n] on the
// device; `path`, `chunk` and `blocks` from the host's plan. Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for a plan
// that the path does not take.
int page_copy_launch(void* dst, const void* src, const int* dst_idx,
                     const int* src_idx, long long n, long long row_bytes,
                     long long dst_stride, long long src_stride,
                     int dst_rows, int src_rows, int path, long long chunk,
                     int blocks, void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(dst) |
                          reinterpret_cast<uintptr_t>(src) |
                          static_cast<uintptr_t>(row_bytes) |
                          static_cast<uintptr_t>(dst_stride) |
                          static_cast<uintptr_t>(src_stride) |
                          static_cast<uintptr_t>(chunk);
  const bool bad =
      chunk <= 0 || blocks <= 0 || (path != kBytes && align % 16 != 0) ||
      path < kBytes || path > kVector;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<char*>(dst), static_cast<const char*>(src),
               dst_idx, src_idx, n, row_bytes, dst_stride, src_stride,
               dst_rows, src_rows, chunk, (row_bytes + chunk - 1) / chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == kBytes) {
    copy_bytes<<<blocks, kThreads, 0, st>>>(a);
  } else {
    copy_vector<<<blocks, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
