// Measurement probes for the bound of the cache-scan kernel on Hopper
// (sm_90a). They have no TPU counterpart and nothing on the main path
// launches them: chip_smoke.py times them to price the cache-scan bound's
// step and state-bytes terms on the card it runs on.
//
// l2_read_probe: a full-card grid reads an L2-resident buffer in sweeps,
//   four 16-byte vectors a thread a sweep, `reps` sweeps in turn over the
//   buffer, with loads that bypass L1. Bytes over time is the card's L2
//   read rate.
// chain_probe: the skeleton of one request step of the cache-scan design
//   with a block barrier a step, `steps` times over, one block per row:
//   thread 0 makes
//   one dependent L2 load (the next index comes from the last one),
//   publishes it in shared memory, a block barrier, every thread reads it,
//   a second barrier. Time over steps is the least time of one step of a
//   design that runs a row on one block with a block barrier a step and
//   keeps per-line state that outgrows the SM in L2.
// walker_probe: the skeleton of the look-ahead design, one block per row:
//   per window of K steps, the block pass (every line's tag read once, the
//   window's looked-up lines written, four block barriers), then one warp
//   walks the K steps: each reads the step's page and looked-up line, the
//   line's tag (a dependent shared load), and on the hit lane 0 updates the
//   line's freq and ts, with a warp barrier a step. Every step is a hit, so
//   the walk takes no eviction and no learner work: time over steps is the
//   least time of one step of that design.
// smem_read_probe: a full-card grid reads its blocks' shared memory, 16
//   bytes a thread a load; bytes over time is the card's shared-memory read
//   rate.

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

__global__ void walker_probe(int steps, int K, int n_lines,
                             int* __restrict__ out) {
  extern __shared__ int sm[];
  int* tags = sm;
  int* freq = tags + n_lines;
  int* ts = freq + n_lines;
  int* hit = ts + n_lines;
  int* pg = hit + K;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  for (int l = tid; l < n_lines; l += nt) { tags[l] = l; freq[l] = 0; ts[l] = 0; }
  __syncthreads();
  int acc = 0;
  for (int t0 = 0; t0 < steps; t0 += K) {
    const int kw = min(K, steps - t0);
    for (int l = tid; l < n_lines; l += nt) acc ^= tags[l];
    __syncthreads();
    for (int k = tid; k < kw; k += nt) {
      const int h = static_cast<int>((static_cast<long long>(t0 + k) * 7919)
                                     % n_lines);
      hit[k] = h;
      pg[k] = h;
    }
    __syncthreads();
    __syncthreads();
    __syncthreads();
    if (tid < 32) {
      for (int k = 0; k < kw; ++k) {
        const int page = pg[k];
        const int h = hit[k];
        const bool is_hit = h >= 0 && tags[h] == page;
        __syncwarp();
        if (lane == 0 && is_hit) {
          freq[h] += 1;
          ts[h] = t0 + k;
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  if (tid == 0) out[blockIdx.x] = acc + freq[0] + ts[1];
}

__global__ void smem_read_probe(int reps, int n_vec, int* __restrict__ out) {
  extern __shared__ int4 sv[];
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x)
    sv[i] = make_int4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  int acc = 0;
  int i = threadIdx.x;
  for (int r = 0; r < reps; ++r) {
    const int4 v = sv[i];
    acc += v.x ^ v.w;
    i += blockDim.x + (v.y & 1);  // the next address depends on the data
    if (i >= n_vec) i -= n_vec;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
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

// `out` holds `blocks` ints; shared memory 3 n_lines + 2 K ints. Returns
// cudaGetLastError().
int walker_probe_launch(int steps, int K, int n_lines, int* out, int blocks,
                        int threads, void* stream) {
  const size_t smem = sizeof(int) * (3 * static_cast<size_t>(n_lines) + 2 * K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        walker_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  walker_probe<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      steps, K, n_lines, out);
  return static_cast<int>(cudaGetLastError());
}

// `out` holds blocks * threads ints; each block reads n_vec int4 of shared
// memory. Returns cudaGetLastError().
int smem_read_probe_launch(int reps, int n_vec, int* out, int blocks,
                           int threads, void* stream) {
  const size_t smem = sizeof(int4) * static_cast<size_t>(n_vec);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        smem_read_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  smem_read_probe<<<blocks, threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(reps, n_vec, out);
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
