// Measurement probes for the bound of the cache-scan kernel on Hopper
// (sm_90a). They have no TPU counterpart and nothing on the main path
// launches them: chip_smoke.py times them to price two terms of the
// cache-scan bound on the card it runs on.
//
// l2_read_probe: a full-card grid reads an L2-resident buffer in sweeps,
//   four 16-byte vectors a thread a sweep, `reps` sweeps in turn over the
//   buffer, with loads that bypass L1. Bytes over time is the card's L2
//   read rate.
// chain_probe: the skeleton of one cache-scan request step, `steps` times
//   over, one block per row: thread 0 makes one dependent L2 load (the next
//   index comes from the last one), publishes it in shared memory, a block
//   barrier, every thread reads it, a second barrier. Time over steps is
//   the least time of one step of a design that runs a row on one block and
//   keeps per-line state that outgrows the SM in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int4 ld_cg_v4(const int4* p) {
  int4 v;
  asm volatile("ld.global.cg.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ int ld_cg(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__global__ void l2_read_probe(const int4* __restrict__ buf, int sweeps,
                              int reps, int* __restrict__ out) {
  // Rep r reads sweep r % sweeps of the buffer, four vectors a thread, so
  // no load repeats the address of the one before it and the compiler
  // cannot hoist a load out of the loop.
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int4* base = buf + blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
  int acc = 0, s = 0;
  for (int r = 0; r < reps; ++r) {
    const int4* p = base + 4 * s * stride;
    const int4 a = ld_cg_v4(p);
    const int4 b = ld_cg_v4(p + stride);
    const int4 c = ld_cg_v4(p + 2 * stride);
    const int4 d = ld_cg_v4(p + 3 * stride);
    acc += (a.x ^ b.y) + (c.z ^ d.w) + (a.w ^ b.z) + (c.y ^ d.x);
    s = s + 1 == sweeps ? 0 : s + 1;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

__global__ void chain_probe(const int* __restrict__ next, int steps,
                            int* __restrict__ out) {
  __shared__ int s_idx;
  int idx = 0, acc = 0;
  for (int t = 0; t < steps; ++t) {
    if (threadIdx.x == 0) {
      idx = ld_cg(next + idx);
      s_idx = idx;
    }
    __syncthreads();
    acc += s_idx;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

}  // namespace

extern "C" {

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// `buf` holds sweeps * 4 * blocks * threads int4 vectors; `out` blocks *
// threads ints. Returns cudaGetLastError().
int l2_read_probe_launch(const void* buf, int sweeps, int reps, int* out,
                         int blocks, int threads, void* stream) {
  l2_read_probe<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(buf), sweeps, reps, out);
  return static_cast<int>(cudaGetLastError());
}

// `next` is a cycle of indices; `out` holds `blocks` ints. Returns
// cudaGetLastError().
int chain_probe_launch(const int* next, int steps, int* out, int blocks,
                       int threads, void* stream) {
  chain_probe<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      next, steps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
