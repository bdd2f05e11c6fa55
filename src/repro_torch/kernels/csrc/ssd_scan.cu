// The Mamba-2 chunked SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py: ssd_scan_kernel
// (grid (batch, head, chunk) with the chunk axis innermost and sequential,
// the state h [N, P] in VMEM scratch, three MXU products a chunk). The
// plain PyTorch version is repro_torch/kernels/ssd_scan.py: ssd_scan_plain.
// For sequence b, head h and each chunk of Q steps, in f32:
//
//   cum_t = sum_{s <= t} dt_s A                  (within the chunk)
//   y_t   = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//           + exp(cum_t) C_t . h
//   h'    = exp(cum_Q) h + sum_s B_s^T exp(cum_Q - cum_s) dt_s x_s
//
// y is stored in x's dtype; the state after the last chunk is written as a
// second output, f32 [B, H, N, P] (the prefill hands it to decode; the TPU
// kernel does not return it). The decay is selected where t >= s and
// never computed above the diagonal, where cum_t - cum_s > 0 can overflow.
//
// What bounds it: operations. At mamba2-370m's prefill (Q = 256, N = 128,
// P = 64) a chunk does 2 Q^2 N + 2 Q^2 P + 4 Q N P flops for 2 Q P + 2 Q N
// elements read or written, far above the card's balance point; the bound
// is the bf16 tensor-core rate. This first version runs on the CUDA cores
// in f32 (no mma/wgmma yet), so it sits far above that bound. The design:
// one block of 256 threads per (b, head) walks the chunks in order with h
// in shared memory (N P f32: 32 KiB). The [Q, Q] matrix CB * decay does not
// fit (256 KiB in f32 at Q = 256), so y is built a tile of 64 query rows at
// a time: the tile's C rows are staged once, C . h gives the inter-chunk
// term, and for each 64-row key tile at or before it (causal) the B rows
// and dt x are staged, the 64 x 64 block of CB * decay is formed in shared
// memory, and folded into y. Thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j (i, j < 4) of every 64 x 64 product, so a warp reads
// one row value (broadcast) and 16 consecutive column values; the staged
// rows of C and B are padded by one float against bank conflicts. The new
// state is summed in registers (N P / 256 elements a thread) over the key
// tiles, after every y tile of the chunk has read the old one (P divides
// the 256 threads, so each thread keeps one column p of the state). The
// within-chunk cumulative sum is one thread's sequential loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // rows of a query or key tile
constexpr int kMaxState = 8192;  // N * P
constexpr int kPerThread = kMaxState / kThreads;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ inline size_t smem_floats(int N, int P, int Q) {
  return static_cast<size_t>(N) * P + 2 * Q + 2 * kT * (N + 1) + kT * P +
         kT * (kT + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ h_out, int S, int H, int P, int N,
                int Q) {
  extern __shared__ __align__(16) float smem[];
  const int NP1 = N + 1;
  const int NP = N * P;
  float* h_s = smem;               // [N, P]
  float* cum_s = h_s + NP;         // [Q]
  float* dt_s = cum_s + Q;         // [Q]
  float* c_s = dt_s + Q;           // [kT, N + 1]
  float* b_s = c_s + kT * NP1;     // [kT, N + 1]
  float* x_s = b_s + kT * NP1;     // [kT, P]
  float* w_s = x_s + kT * P;       // [kT, kT + 1]

  const int b = blockIdx.x / H, hh = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float a = A[hh];
  const long long x_row = static_cast<long long>(H) * P;  // x, y: per step
  const T* xb = x + static_cast<long long>(b) * S * x_row + hh * P;
  T* yb = y + static_cast<long long>(b) * S * x_row + hh * P;
  const float* dtb = dt + static_cast<long long>(b) * S * H + hh;
  const T* bb = Bm + static_cast<long long>(b) * S * N;
  const T* cb = Cm + static_cast<long long>(b) * S * N;

  // The state columns and rows this thread updates after each chunk.
  const int p_own = tid % P, n_own = tid / P, n_step = kThreads / P;

  for (int e = tid; e < NP; e += kThreads) h_s[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk is done with dt_s and cum_s
    for (int s = tid; s < Q; s += kThreads)
      dt_s[s] = dtb[static_cast<long long>(c0 + s) * H];
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int s = 0; s < Q; ++s) {
        acc += dt_s[s] * a;
        cum_s[s] = acc;
      }
    }
    __syncthreads();
    const float cum_end = cum_s[Q - 1];

    // y, kT query rows at a time.
    for (int t0 = 0; t0 < Q; t0 += kT) {
      const int nt = min(kT, Q - t0);
      __syncthreads();  // c_s is free
      for (int e = tid; e < kT * N; e += kThreads) {
        const int i = e / N, n = e - i * N;
        c_s[i * NP1 + n] =
            i < nt ? to_f32(cb[static_cast<long long>(c0 + t0 + i) * N + n])
                   : 0.f;
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      // Inter-chunk term: exp(cum_t) C_t . h.
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * NP1 + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          hv[j] = p < P ? h_s[n * P + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float e = t < nt ? expf(cum_s[t0 + t]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      // Intra-chunk term over the key tiles at or before the query tile.
      for (int s0 = 0; s0 <= t0; s0 += kT) {
        const int ns = min(kT, Q - s0);
        __syncthreads();  // b_s, x_s and w_s are free
        for (int e = tid; e < kT * N; e += kThreads) {
          const int s = e / N, n = e - s * N;
          b_s[s * NP1 + n] =
              s < ns ? to_f32(bb[static_cast<long long>(c0 + s0 + s) * N + n])
                     : 0.f;
        }
        for (int e = tid; e < kT * P; e += kThreads) {
          const int s = e / P, p = e - s * P;
          x_s[e] = s < ns ? dt_s[s0 + s] *
                                to_f32(xb[(c0 + s0 + s) * x_row + p])
                          : 0.f;
        }
        __syncthreads();
        float w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * NP1 + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * NP1 + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) w[i][j] = fmaf(cv[i], bv[j], w[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            const bool vis = t - t0 < nt && s <= t;  // s < Q follows
            w_s[(ty + 16 * i) * (kT + 1) + tx + 16 * j] =
                vis ? w[i][j] * expf(cum_s[t] - cum_s[s]) : 0.f;
          }
        }
        __syncthreads();
        for (int s = 0; s < kT; ++s) {
          float wv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = w_s[(ty + 16 * i) * (kT + 1) + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = tx + 16 * j;
            xv[j] = p < P ? x_s[s * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= nt) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) store(yb + (c0 + t0 + t) * x_row + p, acc[i][j]);
        }
      }
    }

    // The state after the chunk, in registers: thread tid owns column
    // p = tid % P of rows n0 + k kThreads / P (P divides kThreads), i.e.
    // elements e = tid + k kThreads of h.
    float hn[kPerThread];
    const float decay_end = expf(cum_end);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int e = tid + k * kThreads;
      hn[k] = e < NP ? h_s[e] * decay_end : 0.f;
    }
    for (int s0 = 0; s0 < Q; s0 += kT) {
      const int ns = min(kT, Q - s0);
      __syncthreads();  // b_s and x_s are free
      for (int e = tid; e < kT * N; e += kThreads) {
        const int s = e / N, n = e - s * N;
        b_s[s * NP1 + n] =
            s < ns ? to_f32(bb[static_cast<long long>(c0 + s0 + s) * N + n])
                   : 0.f;
      }
      for (int e = tid; e < kT * P; e += kThreads) {
        const int s = e / P, p = e - s * P;
        x_s[e] = s < ns ? expf(cum_end - cum_s[s0 + s]) * dt_s[s0 + s] *
                              to_f32(xb[(c0 + s0 + s) * x_row + p])
                        : 0.f;
      }
      __syncthreads();
      for (int s = 0; s < ns; ++s) {
        const float xv = x_s[s * P + p_own];
        const float* brow = b_s + s * NP1 + n_own;
#pragma unroll
        for (int k = 0; k < kPerThread; ++k)
          if (n_own + k * n_step < N) hn[k] = fmaf(brow[k * n_step], xv, hn[k]);
      }
    }
    __syncthreads();  // every read of the old state is done
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int e = tid + k * kThreads;
      if (e < NP) h_s[e] = hn[k];
    }
  }
  __syncthreads();
  float* hb = h_out + static_cast<long long>(blockIdx.x) * NP;
  for (int e = tid; e < NP; e += kThreads) hb[e] = h_s[e];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* h, int B, int S, int H, int P,
           int N, int Q, cudaStream_t stream) {
  if (N * P > kMaxState || P > 4 * 16 || kThreads % P || Q <= 0 || S % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(N, P, Q);
  auto kern = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), h, S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x/y: [B, S, H, P] and Bm/Cm: [B, S, N], contiguous, of element type
// `dtype` (0 = f32, 1 = bf16); dt f32 [B, S, H]; A f32 [H]; h f32
// [B, H, N, P] (the state after the last chunk). S a multiple of Q.
// Returns the launch error.
int ssd_scan_launch(const void* x, const float* dt, const float* A,
                    const void* Bm, const void* Cm, void* y, float* h,
                    int dtype, int B, int S, int H, int P, int N, int Q,
                    void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, h, B, S, H, P, N, Q, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h, B, S, H, P, N, Q,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
