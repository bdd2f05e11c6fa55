// Flash attention forward for Hopper (sm_90a): causal or sliding-window
// GQA attention with an online softmax, never materializing the scores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (grid (batch, q head, q block, kv block) with the kv
// block innermost and sequential, (m, l, acc) in VMEM scratch across it).
// The plain PyTorch version is repro_torch/kernels/ref.py: attention_ref.
// For query i of head h (kv head h / G) and keys j:
//
//   visible(i, j) = j < Skv and (not causal or (j <= i and
//                   (window < 0 or j > i - window)))
//   out[i] = sum_j softmax_j(q_i . k_j / sqrt(hd)) v_j   over visible j,
//
// divided by max(l, 1e-30) as the TPU kernel does, in q's dtype.
//
// Layouts come as element strides (batch, head, sequence; the head dim is
// contiguous), so the model's [B, S, H, hd] tensors are read and the
// output written in place, without transposes, and the [B, H, S, hd]
// layout of the TPU kernel works the same way.
//
// What bounds it: operations. At prefill shapes (S = 3072, hd = 128) it
// does ~S/2 multiply-adds per loaded K/V element and query; the card's
// bound is its bf16 tensor-core rate. This first version runs on the CUDA
// cores in f32 (no mma/wgmma yet), so it sits far above that bound. The
// design: one block of 128 threads per (b, q head, 64-query tile), tiles
// of late queries first (they see the most keys); 64-key K/V tiles are
// staged through shared memory (rows padded against bank conflicts);
// thread (r, c) computes the 4 x 8 scores of rows 4r..4r+3 and keys
// c, c+8, .., keeps those rows' running max and sum (reduced across the 8
// threads of the row group with shuffles) and accumulates the rows'
// output dims c, c+8, .. in registers; key tiles wholly masked by
// causality or the window are never loaded. At hd = 256 (recurrentgemma)
// the tiles take ~113 KB of shared memory, above the 48 KB default: the
// launch opts in to the larger size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // queries a block
constexpr int kBK = 64;  // keys a tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__host__ __device__ constexpr int pad_elems() {
  return sizeof(T) == 4 ? 1 : 2;
}

struct Strides {
  long long b, h, s;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Strides qs, Strides kst, Strides vs, Strides os,
                       int H, int KV, int Sq, int Skv, int causal, int window,
                       float scale) {
  constexpr int QS = HD + pad_elems<T>();  // padded Q/K rows
  constexpr int DV = HD / 8;               // output dims a thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);  // [kBQ, QS]
  T* k_s = q_s + kBQ * QS;              // [kBK, QS]
  T* v_s = k_s + kBK * QS;              // [kBK, HD]
  float* p_s = reinterpret_cast<float*>(v_s + kBK * HD);  // [kBQ, kBK + 1]

  const int qt = gridDim.x - 1 - blockIdx.x;  // late query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * kst.b + kvh * kst.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    q_s[i * QS + d] = q0 + i < Sq ? qb[(q0 + i) * qs.s + d] : T(0.f);
  }

  float m[4], l[4], o[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int x = 0; x < DV; ++x) o[i][x] = 0.f;
  }

  const int n_kt = (Skv + kBK - 1) / kBK;
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_lo = 0, kt_hi = n_kt;
  if (causal) {
    kt_hi = min(n_kt, q_last / kBK + 1);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / kBK;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      const bool in = k0 + j < Skv;
      k_s[j * QS + d] = in ? kb[(k0 + j) * kst.s + d] : T(0.f);
      v_s[j * HD + d] = in ? vb[(k0 + j) * vs.s + d] : T(0.f);
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f32(q_s[(4 * r + i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = to_f32(k_s[(c + 8 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * r + i;
      float mx = kNeg;
      bool ok[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + c + 8 * j;
        bool vis = kp < Skv;
        if (causal) {
          vis = vis && kp <= qp;
          if (window > 0) vis = vis && kp > qp - window;
        }
        ok[j] = vis;
        s[i][j] = vis ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(4 * r + i) * (kBK + 1) + c + 8 * j] = pj;
        sum += pj;
      }
      sum += __shfl_xor_sync(~0u, sum, 1);
      sum += __shfl_xor_sync(~0u, sum, 2);
      sum += __shfl_xor_sync(~0u, sum, 4);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int x = 0; x < DV; ++x) o[i][x] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(4 * r + i) * (kBK + 1) + j];
#pragma unroll
      for (int x = 0; x < DV; ++x) {
        const float vj = to_f32(v_s[j * HD + c + 8 * x]);
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][x] = fmaf(p[i], vj, o[i][x]);
      }
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * r + i;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int x = 0; x < DV; ++x) store(ob + qp * os.s + c + 8 * x, o[i][x] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
           int KV, int Sq, int Skv, int causal, int window,
           cudaStream_t stream) {
  constexpr int QS = HD + pad_elems<T>();
  const size_t smem = sizeof(T) * (2 * kBQ * QS + kBK * HD) +
                      sizeof(float) * kBQ * (kBK + 1);
  auto kern = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, H, KV,
      Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
             int KV, int Sq, int Skv, int causal, int window,
             cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq, Skv, causal, window, st);
    case 32: return launch<T, 32>(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq, Skv, causal, window, st);
    case 64: return launch<T, 64>(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq, Skv, causal, window, st);
    case 80: return launch<T, 80>(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq, Skv, causal, window, st);
    case 128: return launch<T, 128>(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq, Skv, causal, window, st);
    case 256: return launch<T, 256>(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq, Skv, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/out: [B, H, Sq, hd] and k/v: [B, KV, Skv, hd] as element strides
// (batch, head, sequence) with the head dim contiguous; dtype 0 = f32,
// 1 = bf16; window <= 0 = none. Returns the launch error.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, const long long* strides,
                           int B, int H, int KV, int Sq, int Skv, int hd,
                           int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, out, qs, ks, vs, os, B, H, KV, Sq,
                           Skv, causal, window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, out, qs, ks, vs, os, B, H,
                                   KV, Sq, Skv, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
