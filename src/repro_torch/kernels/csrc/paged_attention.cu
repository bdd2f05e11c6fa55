// Paged decode attention for Hopper (sm_90a): the online-softmax partial
// of single-token GQA queries over the pages of one KV pool reached
// through a page table.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:
// paged_attention (grid (batch, page), the page table in scalar-prefetch
// memory as the pool's index map, (m, l, acc) carried across the page axis
// in VMEM scratch). The plain PyTorch version is
// repro_torch/kernels/ref.py: paged_attention_ref. Per sequence b and
// query head h (kv head h / G):
//
//   s_t  = q_h . k_t / sqrt(hd)   over tokens t of pages p with
//          page_slot[b, p] >= 0, t < lengths[b] and, with a sliding
//          window (window > 0), t >= lengths[b] - window
//   m    = max_t s_t (-1e30 if none),  l = sum_t exp(s_t - m),
//   acc  = sum_t exp(s_t - m) v_t      (f32; l = 0, acc = 0 if none)
//
// The pool is read in place through a base pointer (one layer of a
// [slots, layers, page, 2, KV, hd] pool) and a slot stride, so no layer
// is ever copied out. Inside a slot a token is [2, KV, hd] (k, then v).
//
// What bounds it: bytes. Decode reads every live K and V element once and
// does 4 flops on each per query head of its group (G = 4 for
// mistral-nemo: 2 flops a byte of bf16), far below the card's balance
// point. The design: one block per (b, kv head) serves the head's G query
// heads, so each K/V element is read from device memory once; pages are
// walked in order, skipped when their slot is -1, they start at or past
// the length or they end before the window; each page is staged 64 tokens at a time through shared
// memory with 16-byte loads, all of a thread's loads of a tile issued
// before any is stored (so a tile costs about one memory latency, not one
// a loaded element), K rows padded by 16 bytes so the 16-byte reads of
// the scores hit distinct banks; one thread computes one (query head,
// token) score, a warp per query head updates (m, l) and rescales, and
// the threads then fold the tile's probabilities into acc[G][hd] in
// shared memory. Simple first: no split over pages across blocks, so a
// batch of B sequences fills only B x KV blocks of the card. The head dim
// must be a multiple of 16 bytes' worth of elements, and the pool 16-byte
// aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // tokens staged at a time
constexpr int kUnroll = 4;  // 16-byte loads of K (and of V) in flight a thread
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__host__ __device__ constexpr int vec_elems() {  // elements in 16 bytes
  return 16 / static_cast<int>(sizeof(T));
}

// Bytes of the kernel's f32 shared-memory arrays, rounded up to 16 so the
// K/V tiles after them are 16-byte aligned.
__host__ __device__ inline int f32_region_bytes(int G, int hd) {
  const int n = 4 * (2 * G * hd + G * kTile + 3 * G);
  return (n + 15) / 16 * 16;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q, const T* __restrict__ pool,
                       long long slot_stride, int n_slots,
                       const int* __restrict__ page_slot,
                       const int* __restrict__ lengths,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int H, int KV, int hd,
                       int page, int n_pages, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int V = vec_elems<T>();
  const int ks = hd + V;   // K row padded by 16 bytes
  const int vpr = hd / V;  // 16-byte vectors a row

  float* q_s = reinterpret_cast<float*>(smem);  // [G, hd]
  float* acc_s = q_s + G * hd;                   // [G, hd]
  float* p_s = acc_s + G * hd;                   // [G, kTile]
  float* m_s = p_s + G * kTile;                  // [G]
  float* l_s = m_s + G;                          // [G]
  float* c_s = l_s + G;                          // [G] rescale of the tile
  T* k_s = reinterpret_cast<T*>(smem + f32_region_bytes(G, hd));  // [kTile, ks]
  T* v_s = k_s + kTile * ks;                     // [kTile, hd]

  const float* qb = q + (static_cast<long long>(b) * H + kvh * G) * hd;
  for (int e = tid; e < G * hd; e += kThreads) {
    q_s[e] = qb[e];
    acc_s[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }
  const int len = lengths[b];
  const int lo = window > 0 ? len - window : 0;  // first live token
  const long long tok_stride = 2LL * KV * hd;

  for (int p = 0; p < n_pages; ++p) {
    const int slot = page_slot[static_cast<long long>(b) * n_pages + p];
    const int first = p * page;
    if (first >= len) break;  // pages are walked in order
    if (slot < 0 || slot >= n_slots || first + page <= lo) continue;
    const T* base = pool + slot * slot_stride + static_cast<long long>(kvh) * hd;
    for (int t0 = 0; t0 < page && first + t0 < len; t0 += kTile) {
      const int n_live = min(min(kTile, page - t0), len - first - t0);
      const int t_lo = max(0, lo - first - t0);  // tokens below the window
      if (t_lo >= n_live) continue;
      __syncthreads();  // the previous tile is consumed; q/acc are set
      const int n_vec = kTile * vpr;
      for (int e0 = 0; e0 < n_vec; e0 += kThreads * kUnroll) {
        uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * kThreads + tid;
          const int t = e / vpr, c = e - t * vpr;
          if (e < n_vec && t < n_live) {
            const T* row = base + (t0 + t) * tok_stride + c * V;
            kr[u] = *reinterpret_cast<const uint4*>(row);
            vr[u] = *reinterpret_cast<const uint4*>(
                row + static_cast<long long>(KV) * hd);
          } else {
            kr[u] = make_uint4(0u, 0u, 0u, 0u);
            vr[u] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * kThreads + tid;
          if (e < n_vec) {
            const int t = e / vpr, c = e - t * vpr;
            *reinterpret_cast<uint4*>(k_s + t * ks + c * V) = kr[u];
            *reinterpret_cast<uint4*>(v_s + t * hd + c * V) = vr[u];
          }
        }
      }
      __syncthreads();
      for (int e = tid; e < G * kTile; e += kThreads) {
        const int g = e / kTile, t = e - (e / kTile) * kTile;
        float s = kNeg;
        if (t < n_live && t >= t_lo) {
          const float* qg = q_s + g * hd;
          const T* kt = k_s + t * ks;
          float dot = 0.f;
          for (int c = 0; c < vpr; ++c) {
            const uint4 raw = *reinterpret_cast<const uint4*>(kt + c * V);
            const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int j = 0; j < V; ++j)
              dot = fmaf(qg[c * V + j], to_f32(kv[j]), dot);
          }
          s = dot * scale;
        }
        p_s[e] = s;
      }
      __syncthreads();
      for (int g = warp; g < G; g += kWarps) {
        float* pg = p_s + g * kTile;
        const float s0 = pg[lane], s1 = pg[lane + 32];
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float e0 =
            lane < n_live && lane >= t_lo ? expf(s0 - m_new) : 0.f;
        const float e1 = lane + 32 < n_live && lane + 32 >= t_lo
                             ? expf(s1 - m_new) : 0.f;
        const float sum = warp_sum(e0 + e1);
        pg[lane] = e0;
        pg[lane + 32] = e1;
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          c_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
      for (int e = tid; e < G * hd; e += kThreads) {
        const int g = e / hd, d = e - (e / hd) * hd;
        const float* pg = p_s + g * kTile;
        float a = acc_s[e] * c_s[g];
        for (int t = 0; t < n_live; ++t) a = fmaf(pg[t], to_f32(v_s[t * hd + d]), a);
        acc_s[e] = a;
      }
    }
  }
  __syncthreads();
  const long long hb = static_cast<long long>(b) * H + kvh * G;
  for (int e = tid; e < G * hd; e += kThreads) acc_out[hb * hd + e] = acc_s[e];
  for (int g = tid; g < G; g += kThreads) {
    m_out[hb + g] = m_s[g];
    l_out[hb + g] = l_s[g];
  }
}

template <typename T>
int launch(const float* q, const void* pool, long long slot_stride,
           int n_slots, const int* page_slot, const int* lengths, float* acc,
           float* m, float* l, int B, int H, int KV, int hd, int page,
           int n_pages, int window, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = f32_region_bytes(G, hd) +
                      sizeof(T) * (kTile * (hd + vec_elems<T>()) + kTile * hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  paged_attention_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      q, static_cast<const T*>(pool), slot_stride, n_slots, page_slot, lengths,
      acc, m, l, H, KV, hd, page, n_pages, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q f32 [B, H, hd]; pool: element type `dtype` (0 = f32, 1 = bf16), slot 0
// of the layer at `pool`, slots `slot_stride` elements apart, each
// [page, 2, KV, hd] contiguous; page_slot int32 [B, n_pages]; lengths
// int32 [B]; window: tokens below lengths - window are masked (<= 0:
// none); acc f32 [B, H, hd], m/l f32 [B, H]. Returns the launch error.
int paged_attention_launch(const float* q, const void* pool, int dtype,
                           long long slot_stride, int n_slots,
                           const int* page_slot, const int* lengths,
                           float* acc, float* m, float* l, int B, int H,
                           int KV, int hd, int page, int n_pages,
                           int window, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, pool, slot_stride, n_slots, page_slot, lengths,
                         acc, m, l, B, H, KV, hd, page, n_pages, window,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pool, slot_stride, n_slots, page_slot,
                                 lengths, acc, m, l, B, H, KV, hd, page,
                                 n_pages, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
