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
// Two paths. bf16, the serving path (prefill of every attention layer):
// the tensor-core kernel `tc::kernel`. f32, used only by the tests and the
// f32 serve check: `f32::kernel` on the CUDA cores, the first version of
// this port.
//
// What bounds the bf16 path: operations. At prefill shapes (S = 3072,
// hd 128 or 256) it does ~S/2 multiply-adds per loaded K/V element and
// query, far above the card's balance point, so the bound is the bf16
// tensor-core rate. The design (times on an H100 80GB HBM3 at 700 W in
// PERF.md):
//
// - A block of two warpgroups, each owning 64 query rows (late query
//   tiles first: they see the most keys), 256 threads, so each may hold
//   up to 255 registers (the f32 O accumulator at hd 256 alone is 128).
//   A separate producer warp or warpgroup would put three warps on an SM
//   sub-partition and cap every thread at 168, which spills at hd 256.
// - The copies are TMA's (one 4-D tensor map per operand over the strided
//   [B, heads, S, hd] view, rows past S as zeros): Q once, then K and V
//   tiles of 128 keys (hd <= 128) or 64 keys (hd 256) through a ring of
//   mbarrier-tracked stages, as many as fit in shared memory up to 4: 4
//   at hd <= 80, 2 at hd 128 and 256. Thread 0 fills the first stages;
//   after that the warpgroup that is second to finish reading a stage
//   refills it with the tile STAGES later, so neither warpgroup ever
//   waits for the other.
//   The boxes are whole rows of 128 bytes (hd a multiple of 64) or 32
//   bytes (hd 16, 32, 80), stored with that swizzle, which is how wgmma's
//   descriptors read them: narrower boxes read half sectors and ran 1.6x
//   slower.
// - S = Q K^T is wgmma m64n128k16 (m64n64k16 at hd 256, with 64-key
//   tiles) with both operands in shared memory (bf16 products are exact
//   in f32, so S matches the f32 kernel up to summation order). The
//   online softmax runs in registers on the
//   accumulator layout: row max and sum over the 4 threads of a quad,
//   exp2 with scale * log2(e) folded in, l summed from the unrounded f32
//   P. Key tiles wholly masked by causality or the window are skipped;
//   only tiles that cross the diagonal, the window's edge or the sequence
//   end are masked element by element.
// - O += P V is one wgmma m64n{hd}k16 a 16-key step, A = P from registers,
//   B = V through the transposed (MN-major) descriptor that 16-bit types
//   allow, so V is used as it is copied.
//
// Why P is split. O += P V takes P as wgmma's A operand in bf16. Rounding
// P once to bf16 puts a relative error of up to 2^-9 on every weight, and
// the output then misses the plain version's by more than one bf16 step
// (2^-7 of its value) on about a tenth of its elements (causal, S =
// 2,048, hd 128). So P is split into P_hi = bf16(P) and P_lo = bf16(P -
// P_hi), and O += P_hi V + P_lo V, accumulated in f32: P is then carried
// to ~2^-16, as good as an f32 reordering. This costs 1.5x the nominal
// multiply-adds of QK^T + PV.

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

struct Strides {
  long long b, h, s;
};

// ---------------------------------------------------------------------
// f32 on the CUDA cores: one block of 128 threads per (b, q head,
// 64-query tile); 64-key K/V tiles staged through shared memory (rows
// padded against bank conflicts); thread (r, c) computes the 4 x 8 scores
// of rows 4r..4r+3 and keys c, c+8, .., keeps those rows' running max and
// sum (reduced across the 8 threads of the row group with shuffles) and
// accumulates the rows' output dims c, c+8, .. in registers.
namespace f32 {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // queries a block
constexpr int kBK = 64;  // keys a tile

template <int HD>
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, float* __restrict__ out, Strides qs,
       Strides kst, Strides vs, Strides os, int H, int KV, int Sq, int Skv,
       int causal, int window, float scale) {
  constexpr int QS = HD + 1;  // padded Q/K rows
  constexpr int DV = HD / 8;  // output dims a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kBQ, QS]
  float* k_s = q_s + kBQ * QS;                  // [kBK, QS]
  float* v_s = k_s + kBK * QS;                  // [kBK, HD]
  float* p_s = v_s + kBK * HD;                  // [kBQ, kBK + 1]

  const int qt = gridDim.x - 1 - blockIdx.x;  // late query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * kst.b + kvh * kst.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    q_s[i * QS + d] = q0 + i < Sq ? qb[(q0 + i) * qs.s + d] : 0.f;
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
      k_s[j * QS + d] = in ? kb[(k0 + j) * kst.s + d] : 0.f;
      v_s[j * HD + d] = in ? vb[(k0 + j) * vs.s + d] : 0.f;
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
      for (int i = 0; i < 4; ++i) a[i] = q_s[(4 * r + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = k_s[(c + 8 * j) * QS + d];
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
        const float vj = v_s[j * HD + c + 8 * x];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][x] = fmaf(p[i], vj, o[i][x]);
      }
    }
  }

  float* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * r + i;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int x = 0; x < DV; ++x) ob[qp * os.s + c + 8 * x] = o[i][x] * inv;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
           int KV, int Sq, int Skv, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kBQ * (HD + 1) + kBK * HD +
                                       kBQ * (kBK + 1));
  auto kern = kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), qs, ks, vs, os,
      H, KV, Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------
// bf16 on the tensor cores (wgmma), as the note at the top describes.
namespace tc {

constexpr int kWG = 2;     // warpgroups a block, 64 query rows each
constexpr int kRows = 64;  // query rows a warpgroup
// 256 threads: two warps on each SM sub-partition, up to 255 registers.
constexpr int kThreads = 128 * kWG;

template <int HD>
struct Shape {
  // Keys a tile: S is one m64n128 product a k16 step, m64n64 at hd 256
  // (whose registers hold the 128 O accumulators).
  static constexpr int BK = HD <= 128 ? 128 : 64;
  // Tiles are stored as the TMA writes them: rows of W bytes (E elements
  // of the head dim), a box of rows a W-byte column, swizzled by W (128
  // bytes where the head dim is whole 64-element columns, else 32).
  static constexpr int W = HD % 64 == 0 ? 128 : 32;
  static constexpr int E = W / 2;
  static constexpr int LAYOUT = W == 128 ? 1 : 3;  // wgmma's swizzle code
  static constexpr int QTILE = kRows * HD * 2;  // bytes of a Q tile
  static constexpr int KTILE = BK * HD * 2;     // bytes of a K or V tile
  // K/V stages of the ring: as many as fit beside the Q tiles, up to 4.
  static constexpr int FIT = (220 * 1024 - kWG * QTILE) / (2 * KTILE);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int BARS = kWG * QTILE + 2 * STAGES * KTILE;  // offset
  // and 1 KiB to align the tiles to the 128-byte swizzle's 1 KiB atom.
  static constexpr int SMEM = BARS + 8 * (STAGES + kWG) + 4 * STAGES + 1024;
  static_assert(STAGES >= 2, "the ring needs two stages");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One box of a 4-D tensor map into shared memory; the copy's bytes count
// against the mbarrier's expected transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// mbarriers: a barrier completes when the copies it expects have landed
// (an arrival and their bytes for each tile of copies).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// Waits for the phase of `parity` to complete. A wait of more than ~2^35
// cycles (about 20 s) is a deadlock: trap, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_test(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_test(bar, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

// The 128 threads of warpgroup w (named barrier 1 + w).
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor of wgmma for a swizzled layout (`layout`
// 1 = 128-byte, 3 = 32-byte swizzle): `sbo` is the byte stride between
// groups of 8 rows, `lbo` (MN-major operands only) between column blocks.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// The products, with every accumulator register spelled out as PTX needs.
// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] B[16 x 16], A from registers, B from shared
// memory in the transposed (MN-major) layout.
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B from shared
// memory in the transposed (MN-major) layout.
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B from shared
// memory in the transposed (MN-major) layout.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 80] += A[64 x 16] B[16 x 80], A from registers, B from shared
// memory in the transposed (MN-major) layout.
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B from shared
// memory in the transposed (MN-major) layout.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], A from registers, B from shared
// memory in the transposed (MN-major) layout.
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O[64 x HD] += A[64 x 16] V[16 keys x HD], one k16 step, one product.
// V is the MN-major B operand: a key's E head-dim values form a swizzled
// W-byte row, 8 keys a group (8 W bytes), the E-wide column blocks BK W
// bytes apart.
template <int HD, int BK>
__device__ __forceinline__ void pv_step(float* o, const uint32_t* a,
                                        uint32_t vk) {
  using Sh = Shape<HD>;
  const uint64_t d = desc(vk, BK * Sh::W, 8 * Sh::W, Sh::LAYOUT);
  if constexpr (HD == 16) wgmma_rs_n16(o, a, d);
  if constexpr (HD == 32) wgmma_rs_n32(o, a, d);
  if constexpr (HD == 64) wgmma_rs_n64(o, a, d);
  if constexpr (HD == 80) wgmma_rs_n80(o, a, d);
  if constexpr (HD == 128) wgmma_rs_n128(o, a, d);
  if constexpr (HD == 256) wgmma_rs_n256(o, a, d);
}

// Rows [row0, row0 + ROWS) of a [B, heads, S, HD] bf16 tensor (`map`, at
// head h of sequence b; rows past S as zeros) into the tile at `dst`: one
// box of ROWS rows x W bytes a column block c of E elements, at dst + c
// ROWS W, swizzled by the copy as wgmma reads it.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row0, int h,
                                          int b) {
  using Sh = Shape<HD>;
  mbar_expect(bar, ROWS * HD * 2);
#pragma unroll
  for (int c = 0; c < HD / Sh::E; ++c)
    tma_load(dst + c * ROWS * Sh::W, map, bar, Sh::E * c, row0, h, b);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const __grid_constant__ CUtensorMap tq,
       const __grid_constant__ CUtensorMap tk,
       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
       Strides os, int H, int KV, int Sq, int Skv, int causal, int window,
       float scale_log2) {
  using Sh = Shape<HD>;
  constexpr int BK = Sh::BK, STAGES = Sh::STAGES;
  constexpr int QTILE = Sh::QTILE, KTILE = Sh::KTILE;
  constexpr int NO = HD / 2;  // O accumulators a thread
  constexpr int NS = BK / 2;  // S accumulators a thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const uint32_t s_q = smem_addr(smem);       // [kWG] Q tiles
  const uint32_t s_k = s_q + kWG * QTILE;     // [STAGES] K tiles
  const uint32_t s_v = s_k + STAGES * KTILE;  // [STAGES] V tiles
  const uint32_t bar_full = s_q + Sh::BARS;  // [STAGES] tile landed
  const uint32_t bar_q = bar_full + 8 * STAGES;  // [kWG] Q tile landed
  // [STAGES] warpgroups that have read the stage, counted over its fills
  int* done = reinterpret_cast<int*>(smem + Sh::BARS + 8 * (STAGES + kWG));

  const int qt = gridDim.x - 1 - blockIdx.x;  // late query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kWG * kRows;
  const int tid = threadIdx.x, wg = tid >> 7;

  // Key tiles of the block.
  const int n_kt = (Skv + BK - 1) / BK;
  int kt_lo = 0, kt_hi = n_kt;
  if (causal) {
    kt_hi = min(n_kt, (min(q0 + kWG * kRows, Sq) - 1) / BK + 1);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / BK;
  }

  const int n_tiles = kt_hi - kt_lo;
  auto fill = [&](int i) {  // tile kt_lo + i into its stage
    const int st = i % STAGES;
    load_tile<HD, BK>(s_k + st * KTILE, &tk, bar_full + 8 * st,
                      (kt_lo + i) * BK, kvh, b);
    load_tile<HD, BK>(s_v + st * KTILE, &tv, bar_full + 8 * st,
                      (kt_lo + i) * BK, kvh, b);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 2);  // the K copies' and the V copies'
      done[s] = 0;
    }
    for (int w = 0; w < kWG; ++w) mbar_init(bar_q + 8 * w, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int w = 0; w < kWG; ++w)
      load_tile<HD, kRows>(s_q + w * QTILE, &tq, bar_q + 8 * w,
                           q0 + w * kRows, h, b);
    for (int i = 0; i < STAGES && i < n_tiles; ++i) fill(i);
  }
  __syncthreads();

  // Thread 0 copied the Q tiles and the first STAGES K/V tiles with TMA;
  // after that, whichever warpgroup is second to finish reading a stage's
  // tile refills the stage with the tile STAGES later. So the warpgroups
  // never wait for each other, and the copies stay STAGES tiles ahead.
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  // This warpgroup's rows [qw0, qw1] and key tiles [my_lo, my_hi).
  const int qw0 = q0 + wg * kRows;
  const int qw1 = min(qw0 + kRows, Sq) - 1;
  int my_lo = kt_lo, my_hi = qw0 < Sq ? kt_hi : kt_lo;
  if (causal && qw0 < Sq) {
    my_hi = min(n_kt, qw1 / BK + 1);
    if (window > 0) my_lo = max(0, qw0 - window + 1) / BK;
  }
  // Accumulator layout of wgmma m64nN: thread (warp, lane) holds rows
  // r0 = 16 warp + lane / 4 and r0 + 8, columns 8 j + 2 (lane % 4) +
  // {0, 1}; register 4 j + 2 i + c is row r0 + 8 i, column 8 j + cq + c.
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float o[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) o[x] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q + 8 * wg, 0);

#pragma unroll 1
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int it = kt - kt_lo, st = it % STAGES;
    mbar_wait(bar_full + 8 * st, (it / STAGES) & 1);
    if (kt >= my_lo && kt < my_hi) {  // uniform over the warpgroup
      const int k0 = kt * BK;
      float s[NS];
#pragma unroll
      for (int x = 0; x < NS; ++x) s[x] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        // K-major: step kk is 32 bytes into a swizzled row of column
        // block 16 kk / E; 8-row groups are 8 W bytes apart.
        constexpr int W = Sh::W, E = Sh::E;
        const int blk = 16 * kk / E, off = (16 * kk % E) * 2;
        const uint64_t dq = desc(s_q + wg * QTILE + blk * kRows * W + off,
                                 16, 8 * W, Sh::LAYOUT);
        const uint64_t dk = desc(s_k + st * KTILE + blk * BK * W + off, 16,
                                 8 * W, Sh::LAYOUT);
        if constexpr (BK == 64) wgmma_ss_n64(s, dq, dk, 1);
        if constexpr (BK == 128) wgmma_ss_n128(s, dq, dk, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NS>(s);

      // Mask only a tile that crosses the sequence end, the diagonal or
      // the window's edge for some row of this warpgroup.
      const bool edge =
          k0 + BK > Skv ||
          (causal && (k0 + BK - 1 > qw0 ||
                      (window > 0 && k0 <= qw1 - window)));
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qp = qw0 + r0 + 8 * i;
        float mx = kNeg;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 4 * j + 2 * i + c;
            float sc = s[x] * scale_log2;
            if (edge) {
              const int kp = k0 + 8 * j + cq + c;
              bool vis = kp < Skv;
              if (causal)
                vis = vis && kp <= qp && (window <= 0 || kp > qp - window);
              if (!vis) sc = kNeg;
            }
            s[x] = sc;
            mx = fmaxf(mx, sc);
          }
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // With no visible key yet, exp2(kNeg - 0) gives the masked zeros.
        const float m_use = m_new == kNeg ? 0.f : m_new;
        corr[i] = exp2f(m[i] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 4 * j + 2 * i + c;
            s[x] = exp2f(s[x] - m_use);
            sum += s[x];
          }
        sum += __shfl_xor_sync(~0u, sum, 1);
        sum += __shfl_xor_sync(~0u, sum, 2);
        l[i] = fmaf(l[i], corr[i], sum);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= corr[i];
          o[4 * j + 2 * i + 1] *= corr[i];
        }

      // P = P_hi + P_lo, both bf16, as wgmma's A fragments: step kk
      // (keys 16 kk..16 kk + 15) takes registers 4 kk..4 kk + 3, which
      // hold s[8 kk..8 kk + 7] in pairs (rows r0, r0 + 8; keys cq and
      // cq + 8).
      uint32_t ph[NS / 2], pl[NS / 2];
#pragma unroll
      for (int x = 0; x < NS / 2; ++x) {
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(s[2 * x], s[2 * x + 1]);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(s[2 * x] - hf.x, s[2 * x + 1] - hf.y);
        ph[x] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[x] = *reinterpret_cast<const uint32_t*>(&lo);
      }
      fence_regs<NO>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t vk = s_v + st * KTILE + kk * 16 * Sh::W;
        pv_step<HD, BK>(o, ph + 4 * kk, vk);
        pv_step<HD, BK>(o, pl + 4 * kk, vk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NO>(o);
    }
    warpgroup_sync(wg);  // this warpgroup is done reading the stage
    if ((tid & 127) == 0 && atomicAdd(done + st, 1) % kWG == kWG - 1 &&
        it + STAGES < n_tiles)
      fill(it + STAGES);
  }

  if (qw0 < Sq) {
    __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = qw0 + r0 + 8 * i;
      if (qp >= Sq) continue;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + qp * os.s + 8 * j + cq) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                  o[4 * j + 2 * i + 1] * inv);
    }
  }
}

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
EncodeFn encoder() {
  static const EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeFn>(p) : nullptr;
  }();
  return fn;
}

// A [B, heads, S, HD] bf16 tensor with element strides `st` (the head dim
// contiguous) as a 4-D tensor map of boxes of `e` x `rows` elements,
// swizzled by 2 e bytes (128 or 32).
bool make_map(CUtensorMap* map, const void* base, Strides st, int B,
              int heads, int S, int HD, int rows, int e) {
  const EncodeFn encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(e),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                e == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
           int KV, int Sq, int Skv, int causal, int window,
           cudaStream_t stream) {
  constexpr int smem = Shape<HD>::SMEM;
  CUtensorMap tq, tk, tv;
  constexpr int E = Shape<HD>::E, BK = Shape<HD>::BK;
  if (!make_map(&tq, q, qs, B, H, Sq, HD, kRows, E) ||
      !make_map(&tk, k, ks, B, KV, Skv, HD, BK, E) ||
      !make_map(&tv, v, vs, B, KV, Skv, HD, BK, E))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = kernel<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + kWG * kRows - 1) / (kWG * kRows), H, B);
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(HD));
  kern<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), os, H, KV, Sq, Skv,
      causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

using LaunchFn = int (*)(const void*, const void*, const void*, void*,
                         Strides, Strides, Strides, Strides, int, int, int,
                         int, int, int, int, cudaStream_t);

template <int HD>
LaunchFn pick(int dtype) {
  return dtype == 0 ? f32::launch<HD> : tc::launch<HD>;
}

LaunchFn dispatch(int dtype, int hd) {
  switch (hd) {
    case 16: return pick<16>(dtype);
    case 32: return pick<32>(dtype);
    case 64: return pick<64>(dtype);
    case 80: return pick<80>(dtype);
    case 128: return pick<128>(dtype);
    case 256: return pick<256>(dtype);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/out: [B, H, Sq, hd] and k/v: [B, KV, Skv, hd] as element strides
// (batch, head, sequence) with the head dim contiguous; dtype 0 = f32,
// 1 = bf16 (pointers 16-byte aligned, strides multiples of 8); window
// <= 0 = none. Returns the launch error.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, const long long* strides,
                           int B, int H, int KV, int Sq, int Skv, int hd,
                           int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const LaunchFn fn = dispatch(dtype, hd);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  return fn(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq, Skv, causal, window,
            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
