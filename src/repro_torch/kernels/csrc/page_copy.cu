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
// (write-back on eviction, promotion). Destinations must be unique: pairs
// run in no order.
//
// What bounds it: bytes, each moved byte read once and written once. The
// design: a block row of `blockIdx.y` chunks per pair, 64 KiB a chunk, 256
// threads each moving 16-byte vectors (when every base, stride and the
// row length are multiples of 16; bytes otherwise), so a pair of 20 MiB
// (a whole slot of the 40-layer pool) spreads over 320 blocks. A pair with
// a -1, or an index out of its pool's rows, copies nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 64 * 1024;

template <typename V>
__global__ void __launch_bounds__(kThreads)
page_copy_kernel(char* __restrict__ dst, const char* __restrict__ src,
                 const int* __restrict__ dst_idx,
                 const int* __restrict__ src_idx, long long row_bytes,
                 long long dst_stride, long long src_stride, int dst_rows,
                 int src_rows) {
  const int di = dst_idx[blockIdx.x];
  const int si = src_idx[blockIdx.x];
  if (di < 0 || si < 0 || di >= dst_rows || si >= src_rows) return;
  const long long lo = static_cast<long long>(blockIdx.y) * kChunk;
  const long long hi = min(lo + kChunk, row_bytes);
  V* d = reinterpret_cast<V*>(dst + di * dst_stride + lo);
  const V* s = reinterpret_cast<const V*>(src + si * src_stride + lo);
  const long long n = (hi - lo) / static_cast<long long>(sizeof(V));
  for (long long i = threadIdx.x; i < n; i += kThreads) d[i] = s[i];
}

}  // namespace

extern "C" {

const char* page_copy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dst/src: device pointers to row 0; dst_idx/src_idx: int32 [n] on the
// device. Launches on `stream`; returns cudaGetLastError().
int page_copy_launch(void* dst, const void* src, const int* dst_idx,
                     const int* src_idx, int n, long long row_bytes,
                     long long dst_stride, long long src_stride,
                     int dst_rows, int src_rows, void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  const long long chunks = (row_bytes + kChunk - 1) / kChunk;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(chunks));
  const uintptr_t align = reinterpret_cast<uintptr_t>(dst) |
                          reinterpret_cast<uintptr_t>(src) |
                          static_cast<uintptr_t>(row_bytes) |
                          static_cast<uintptr_t>(dst_stride) |
                          static_cast<uintptr_t>(src_stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  if (align % 16 == 0) {
    page_copy_kernel<uint4><<<grid, kThreads, 0, st>>>(
        d, s, dst_idx, src_idx, row_bytes, dst_stride, src_stride, dst_rows,
        src_rows);
  } else {
    page_copy_kernel<char><<<grid, kThreads, 0, st>>>(
        d, s, dst_idx, src_idx, row_bytes, dst_stride, src_stride, dst_rows,
        src_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
