// The Mamba-2 chunked SSD scan for Hopper (sm_90a), chunk-parallel on the
// tensor cores.
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
// What bounds it: bytes at mamba2-370m's prefill (x, B, C read and y and
// the state written once), with the products close behind; so the chunks,
// not the (sequence, head) pairs, are the unit of parallelism, and the
// products run on the tensor cores. Three launches, as Mamba-2's SSD:
//
// 1. chunk_state, a block per (sequence, chunk, group of 4 heads): each
//    head's within-chunk cumulative sum of dt A (one warp's parallel
//    scan; kept in f64 scratch for kernel 3), and the chunk's state
//    increment (exp(cum_end - cum) dt B)^T x [N, P] into f32 scratch, with
//    cum_end beside it.
// 2. state_pass, a thread per 4 state elements of a (sequence, head): the
//    short sequential pass over the chunks, h = exp(cum_end) h + inc, that
//    leaves in the scratch the state entering each chunk and writes the
//    final state; it loads 8 chunks' increments before it adds the first.
// 3. chunk_scan, a block per (sequence, chunk, tile of query rows, group
//    of heads): C B^T once for every head of the group (B and C are shared
//    by the heads), then per head y = exp(cum) (C . h_prev) + (CB * causal
//    decay * dt) . x, the next head's inputs copied in while this head's
//    products run.
//
// Precision: the products take bf16 operands with f32 accumulation
// (mma.sync m16n8k16). bf16 inputs (x, B, C) enter as they are, so C B^T
// is exact in its products. An operand computed in f32 (CB * decay * dt,
// exp(cum_end - cum) dt B, the state h) enters as three bf16 parts, v1 =
// bf16(v), v2 = bf16(v - v1), v3 = bf16(v - v1 - v2), each multiplying the
// bf16 operand: v keeps f32's 24 bits. One part (8 bits) misses the
// one-bf16-step bar on y by far, and two parts (16 bits, as flash
// attention splits P) miss it where y cancels, since these weights have
// both signs (tests/test_torch_ssd_redesign.py); the state alone in two
// parts missed it on an H100 too (32 heads sharing B and C, a ragged S).
// With f32 inputs every operand enters as three parts and the six
// products whose parts' orders sum below three are taken. The cumulative
// sum of dt A is scanned and kept in f64, and every decay comes from an
// f64 difference rounded once: f32 prefix sums of a chunk sum that
// reaches several hundred carry ulps of it (6e-5 at 600) into every
// exp(cum_t - cum_s), which alone moved y by 1.1e-5 of its largest
// magnitude against the plain version on an H100 (the f32 bar is 1e-5).
// Built with --fmad=false, so every product and sum outside the tensor
// cores rounds as written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxQ = 256, kMaxN = 128, kMaxP = 64;
constexpr int kHeads = 8;       // heads a block of kernel 3 walks
constexpr int kSplit = 4;       // warps of kernel 3 that share 16 rows
// A lane's partial sums in kernel 3: kMaxP / 2 floats, padded so that the
// 16-byte accesses of 8 lanes fall in distinct banks.
constexpr int kPartLd = kMaxP / 2 + 4;
constexpr int kStateHeads = 4;  // heads a block of kernel 1 walks
constexpr int kAhead = 8;       // chunks kernel 2 loads before it adds
constexpr int kPad = 8;         // elements a shared row is padded by
constexpr int kStateThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int up16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline int up8(int v) { return (v + 7) & ~7; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// Two neighbouring outputs (p 4-byte aligned for bf16, 8-byte for f32).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Parts of an operand: bf16 inputs enter whole, f32 values as three
// parts; kRows is the query rows of a block of kernel 3.
template <typename T> struct Parts;
template <> struct Parts<__nv_bfloat16> {
  static constexpr int kIn = 1, kF32 = 3, kRows = 64;
};
template <> struct Parts<float> {
  static constexpr int kIn = 3, kF32 = 3, kRows = 32;
};

// (v0, v1) as PL bf16 parts, each packed as a pair (v0 in the low half).
template <int PL>
__device__ __forceinline__ void split_pair(float v0, float v1,
                                           uint32_t* out) {
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    out[i] = *reinterpret_cast<const uint32_t*>(&h);
    v0 = __fsub_rn(v0, __low2float(h));   // exact
    v1 = __fsub_rn(v1, __high2float(h));
  }
}

// Two neighbouring elements of a shared row as PL parts.
template <int PL>
__device__ __forceinline__ void load_pair(const float* p, uint32_t* out) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  split_pair<PL>(v.x, v.y, out);
}
template <int PL>
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p,
                                          uint32_t* out) {
  static_assert(PL == 1, "bf16 operands enter whole");
  out[0] = *reinterpret_cast<const uint32_t*>(p);
}

// The m16n8k16 A fragment of rows [r0, r0 + 16) and columns [k0, k0 +
// 16) of a row-major shared array, as PL parts.
template <int PL, typename T>
__device__ __forceinline__ void load_a(const T* s, int ld, int r0, int k0,
                                       uint32_t (&a)[PL][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint32_t t[PL];
  const T* p = s + (r0 + g) * ld + k0 + 2 * q;
  load_pair<PL>(p, t);
#pragma unroll
  for (int i = 0; i < PL; ++i) a[i][0] = t[i];
  load_pair<PL>(p + 8 * ld, t);
#pragma unroll
  for (int i = 0; i < PL; ++i) a[i][1] = t[i];
  load_pair<PL>(p + 8, t);
#pragma unroll
  for (int i = 0; i < PL; ++i) a[i][2] = t[i];
  load_pair<PL>(p + 8 * ld + 8, t);
#pragma unroll
  for (int i = 0; i < PL; ++i) a[i][3] = t[i];
}

// The B fragment (k16 x n8) of an operand stored [n][k] in shared memory:
// columns [n0, n0 + 8), depth [k0, k0 + 16).
template <int PL, typename T>
__device__ __forceinline__ void load_b(const T* s, int ld, int n0, int k0,
                                       uint32_t (&b)[PL][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint32_t t[PL];
  const T* p = s + (n0 + g) * ld + k0 + 2 * q;
  load_pair<PL>(p, t);
#pragma unroll
  for (int i = 0; i < PL; ++i) b[i][0] = t[i];
  load_pair<PL>(p + 8, t);
#pragma unroll
  for (int i = 0; i < PL; ++i) b[i][1] = t[i];
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A B over the parts (i, j) whose orders sum below the larger part
// count: all three parts of an f32 operand against a whole bf16 one, six
// of nine for three parts each.
template <int PA, int PB>
__device__ __forceinline__ void mma_parts(float (&c)[4],
                                          const uint32_t (&a)[PA][4],
                                          const uint32_t (&b)[PB][2]) {
  constexpr int PM = PA > PB ? PA : PB;
#pragma unroll
  for (int i = 0; i < PA; ++i)
#pragma unroll
    for (int j = 0; j < PB; ++j)
      if (i + j < PM) mma(c, a[i], b[j]);
}

// Inclusive prefix sums of v[0, n) (n <= 256) into out, in f64, by one
// warp: lane j sums its ceil(n / 32) consecutive elements in order, a
// shuffle scan adds up the lanes' totals, and each element is its lane's
// exclusive offset plus its in-lane prefix. The sums of at most 256 f32
// values are exact to far below an f32 ulp.
__device__ __forceinline__ void warp_scan(const float* v, double* out,
                                          int n) {
  const int lane = threadIdx.x & 31;
  const int E = (n + 31) / 32;
  double loc[kMaxQ / 32];
  double run = 0.0;
#pragma unroll
  for (int j = 0; j < kMaxQ / 32; ++j) {
    const int i = lane * E + j;
    if (j < E) {
      run = __dadd_rn(run, i < n ? static_cast<double>(v[i]) : 0.0);
      loc[j] = run;
    }
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = __dadd_rn(incl, y);
  }
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int j = 0; j < kMaxQ / 32; ++j) {
    const int i = lane * E + j;
    if (j < E && i < n) out[i] = __dadd_rn(excl, loc[j]);
  }
}

// exp(a - b) of two f64 cumulative sums, the difference rounded once.
__device__ __forceinline__ float exp_diff(double a, double b) {
  return expf(__double2float_rn(__dsub_rn(a, b)));
}

// Load 16 bytes (16 / sizeof(T) elements) at p, or zeros where `ok` is
// false.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}

// Stage rows [0, rows) of a global array with rows `stride` elements apart
// (zero past `valid` rows or `cols` columns) into shared memory [i][c]
// (ld `ld`), 16-byte loads and stores; cols, cols_p and ld are multiples
// of 16 / sizeof(T).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           long long stride, int rows,
                                           int valid, int cols, int cols_p) {
  constexpr int V = 16 / sizeof(T);
  const int per = cols_p / V;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
    const int i = e / per, c0 = (e - i * per) * V;
    *reinterpret_cast<uint4*>(dst + i * ld + c0) =
        load16(src + i * stride + c0, i < valid && c0 < cols);
  }
}

// The B fragment (k16 x n8) of an operand stored [k][n] (rows of k) in
// shared memory: columns [n0, n0 + 8), depth [k0, k0 + 16). bf16 rows by
// ldmatrix's transposing load (rows 16-byte aligned); f32 values as PL
// parts.
template <int PL>
__device__ __forceinline__ void load_b_rows(const __nv_bfloat16* s, int ld,
                                            int n0, int k0,
                                            uint32_t (&b)[PL][2]) {
  static_assert(PL == 1, "bf16 operands enter whole");
  const int lane = threadIdx.x & 31;
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(
      s + (k0 + (lane & 15)) * ld + n0));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(b[0][0]), "=r"(b[0][1]) : "r"(a));
}
template <int PL>
__device__ __forceinline__ void load_b_rows(const float* s, int ld, int n0,
                                            int k0, uint32_t (&b)[PL][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float* p = s + (k0 + 2 * q) * ld + n0 + g;
  uint32_t t[PL];
  split_pair<PL>(p[0], p[ld], t);
#pragma unroll
  for (int i = 0; i < PL; ++i) b[i][0] = t[i];
  split_pair<PL>(p[8 * ld], p[9 * ld], t);
#pragma unroll
  for (int i = 0; i < PL; ++i) b[i][1] = t[i];
}

struct Dims {
  int B, S, H, P, N, Q, nc, Qp, Np, Pp;
};

// Stage dt of chunk c, head h into s_dt (zero past Q) and, by warp 0,
// cum = the f64 scan of dt A into s_cum; ends with the block's barrier.
__device__ __forceinline__ void stage_cum(const Dims& d, const float* dt,
                                          float a, int b, int c, int h,
                                          float* s_dt, float* s_v,
                                          double* s_cum) {
  for (int s = threadIdx.x; s < d.Qp; s += blockDim.x) {
    const float v = s < d.Q
        ? dt[(static_cast<long long>(b) * d.S + c * d.Q + s) * d.H + h]
        : 0.f;
    s_dt[s] = v;
    s_v[s] = __fmul_rn(v, a);
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_scan(s_v, s_cum, d.Qp);
  __syncthreads();
}

// --- 1. chunk_state ---------------------------------------------------------
template <typename T>
__host__ __device__ inline size_t state_smem_bytes(int Qp, int Np, int Pp) {
  return sizeof(T) * Qp * (Np + kPad + Pp + kPad) + sizeof(double) * Qp
         + sizeof(float) * 3 * Qp;
}

template <typename T>
__global__ void __launch_bounds__(256) chunk_state(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    float* __restrict__ states, float* __restrict__ cum_end,
    double* __restrict__ cum, const Dims d) {
  constexpr int PI = Parts<T>::kIn, PF = Parts<T>::kF32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldb = d.Np + kPad, ldx = d.Pp + kPad;
  T* s_b = reinterpret_cast<T*>(smem);              // [Qp][ldb]
  T* s_x = s_b + d.Qp * ldb;                        // [Qp][ldx]
  double* s_cum = reinterpret_cast<double*>(s_x + d.Qp * ldx);
  float* s_dt = reinterpret_cast<float*>(s_cum + d.Qp);
  float* s_v = s_dt + d.Qp;
  float* s_edge = s_v + d.Qp;
  const int b = blockIdx.x / d.nc, c = blockIdx.x % d.nc;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const long long row0 = static_cast<long long>(b) * d.S + c * d.Q;

  stage_rows(s_b, ldb, Bm + row0 * d.N, d.N, d.Qp, d.Q, d.N, d.Np);
  for (int i = 0; i < kStateHeads; ++i) {
    const int h = blockIdx.y * kStateHeads + i;
    if (h >= d.H) break;
    stage_rows(s_x, ldx, x + (row0 * d.H + h) * d.P,
               static_cast<long long>(d.H) * d.P, d.Qp, d.Q, d.P, d.Pp);
    stage_cum(d, dt, A[h], b, c, h, s_dt, s_v, s_cum);
    const double ce = s_cum[d.Q - 1];
    double* cum_out =
        cum + ((static_cast<long long>(b) * d.nc + c) * d.H + h) * d.Qp;
    for (int s = tid; s < d.Qp; s += nt) {
      s_edge[s] = s < d.Q ? __fmul_rn(exp_diff(ce, s_cum[s]), s_dt[s]) : 0.f;
      cum_out[s] = s_cum[s];
    }
    if (tid == 0)
      cum_end[(static_cast<long long>(b) * d.nc + c) * d.H + h] =
          __double2float_rn(ce);
    __syncthreads();

    // inc [N, P] = (B * edge)^T x: warp w takes rows n of [16 w, 16 w + 16).
    const int r0 = 16 * warp;
    if (r0 < d.Np) {
      float acc[kMaxP / 8][4];
#pragma unroll
      for (int j = 0; j < kMaxP / 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int k0 = 0; k0 < d.Qp; k0 += 16) {
        uint32_t af[PF][4], t[PF];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = r0 + g + ((r & 1) ? 8 : 0);
          const int s = k0 + 2 * q + ((r & 2) ? 8 : 0);
          split_pair<PF>(
              __fmul_rn(to_f32(s_b[s * ldb + n]), s_edge[s]),
              __fmul_rn(to_f32(s_b[(s + 1) * ldb + n]), s_edge[s + 1]), t);
#pragma unroll
          for (int i2 = 0; i2 < PF; ++i2) af[i2][r] = t[i2];
        }
#pragma unroll
        for (int j = 0; j < kMaxP / 8; ++j) {
          if (8 * j < d.Pp) {
            uint32_t bf[PI][2];
            load_b_rows<PI>(s_x, ldx, 8 * j, k0, bf);
            mma_parts<PF, PI>(acc[j], af, bf);
          }
        }
      }
      float* out = states + ((static_cast<long long>(b) * d.nc + c) * d.H + h)
                                * d.N * d.P;
#pragma unroll
      for (int j = 0; j < kMaxP / 8; ++j) {
        const int p = 8 * j + 2 * q;
        if (p >= d.P) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = r0 + g + 8 * half;
          if (n < d.N)
            *reinterpret_cast<float2*>(&out[n * d.P + p]) =
                make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
        }
      }
    }
    __syncthreads();  // s_x, s_dt and s_cum are free for the next head
  }
}

// --- 2. state_pass ----------------------------------------------------------
__global__ void __launch_bounds__(kStateThreads) state_pass(
    float* __restrict__ states, const float* __restrict__ cum_end,
    float* __restrict__ h_out, const Dims d) {
  const int bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
  const int NP = d.N * d.P;  // a multiple of 64
  const int e = (blockIdx.y * kStateThreads + threadIdx.x) * 4;
  if (e >= NP) return;
  float4 cur = make_float4(0.f, 0.f, 0.f, 0.f);
  // kAhead chunks' increments are loaded before the first is added, so
  // the loads overlap.
  for (int c0 = 0; c0 < d.nc; c0 += kAhead) {
    float4 inc[kAhead];
    float decay[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const long long bc = (static_cast<long long>(b) * d.nc + c0 + i) * d.H
                           + h;
      if (c0 + i < d.nc) {
        inc[i] = *reinterpret_cast<const float4*>(states + bc * NP + e);
        decay[i] = expf(cum_end[bc]);
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i >= d.nc) break;
      const long long bc = (static_cast<long long>(b) * d.nc + c0 + i) * d.H
                           + h;
      // the state entering chunk c0 + i
      *reinterpret_cast<float4*>(states + bc * NP + e) = cur;
      cur.x = __fadd_rn(__fmul_rn(cur.x, decay[i]), inc[i].x);
      cur.y = __fadd_rn(__fmul_rn(cur.y, decay[i]), inc[i].y);
      cur.z = __fadd_rn(__fmul_rn(cur.z, decay[i]), inc[i].z);
      cur.w = __fadd_rn(__fmul_rn(cur.w, decay[i]), inc[i].w);
    }
  }
  *reinterpret_cast<float4*>(h_out + static_cast<long long>(bh) * NP + e) =
      cur;
}

// --- 3. chunk_scan ----------------------------------------------------------
// A block has TM query rows and kSplit TM / 16 warps: warps w, w + TM /
// 16, ... take the same 16 rows and split the products' depth between
// them; the others hand their partial sums to the first through shared
// memory. With bf16 inputs the next head's x, state, cumulative sums and
// dt are copied (cp.async) into a second buffer while this head's
// products run; with f32 inputs one buffer fits.
__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool ok) {
  // src-size 0 fills the destination with zeros and reads nothing.
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Byte offsets of kernel 3's shared memory: CB [TM][ldq] f32, then a
// region that holds C [TM][ldn] and B [Qp][ldn] while CB is computed and
// kStages buffers of a head afterwards (x [Qp][ldx], the state entering
// the chunk [Np][ldh] f32, cum [Qp] f64, dt [Qp] f32), then y's tile
// [TM][ldy]; the warps' partial sums reuse the buffer just read.
template <typename T>
struct ScanLayout {
  static constexpr int kStages = sizeof(T) == 2 ? 2 : 1;
  size_t ldn, ldx, ldh, ldq, ldy, region, c_b, h, cum, dt, stage, y, total;
  __host__ __device__ ScanLayout(int Qp, int Np, int Pp) {
    constexpr int TM = Parts<T>::kRows;
    ldn = Np + kPad;
    ldx = Pp + kPad;
    ldh = Pp + 4;
    ldq = Qp + kPad;
    ldy = Pp + kPad;
    region = align16(sizeof(float) * TM * ldq);
    c_b = align16(sizeof(T) * TM * ldn);
    h = align16(sizeof(T) * Qp * ldx);
    cum = h + align16(sizeof(float) * Np * ldh);
    dt = cum + sizeof(double) * Qp;
    stage = align16(dt + sizeof(float) * Qp);
    const size_t part =
        sizeof(float) * (kSplit - 1) * (TM / 16) * 32 * kPartLd;
    if (stage < part) stage = part;  // the partial sums reuse a buffer
    const size_t cb_phase = c_b + sizeof(T) * Qp * ldn;
    const size_t heads = kStages * stage;
    y = region + align16(cb_phase > heads ? cb_phase : heads);
    total = y + sizeof(T) * TM * ldy;
  }
};

// Copy head h's x rows [0, ns), state, cum and dt into a buffer (not
// committed).
template <typename T>
__device__ __forceinline__ void fetch_head(
    const ScanLayout<T>& lay, unsigned char* buf, const Dims& d,
    const T* __restrict__ x, const float* __restrict__ states,
    const double* __restrict__ cum, const float* __restrict__ dt, int b,
    int c, int h, int ns, long long row0) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x;
  T* s_x = reinterpret_cast<T*>(buf);
  float* s_h = reinterpret_cast<float*>(buf + lay.h);
  double* s_cum = reinterpret_cast<double*>(buf + lay.cum);
  float* s_dt = reinterpret_cast<float*>(buf + lay.dt);
  const long long bch = (static_cast<long long>(b) * d.nc + c) * d.H + h;
  const T* xs = x + (row0 * d.H + h) * d.P;
  const int xper = d.Pp / V;
  for (int e = tid; e < ns * xper; e += nt) {
    const int i = e / xper, c0 = (e - i * xper) * V;
    const bool ok = i < d.Q && c0 < d.P;
    cp_async(s_x + i * lay.ldx + c0,
             ok ? xs + static_cast<long long>(i) * d.H * d.P + c0 : xs, 16,
             ok);
  }
  const float* hs = states + bch * d.N * d.P;
  const int hper = d.Pp / 4;
  for (int e = tid; e < d.Np * hper; e += nt) {
    const int n = e / hper, c0 = (e - n * hper) * 4;
    const bool ok = n < d.N && c0 < d.P;
    cp_async(s_h + n * lay.ldh + c0, ok ? hs + n * d.P + c0 : hs, 16, ok);
  }
  const double* cs = cum + bch * d.Qp;
  for (int e = tid; e < d.Qp / 2; e += nt)
    cp_async(s_cum + 2 * e, cs + 2 * e, 16, true);
  for (int s = tid; s < d.Qp; s += nt) {
    const bool ok = s < d.Q;
    cp_async(s_dt + s, ok ? dt + (row0 + s) * d.H + h : dt, 4, ok);
  }
}

template <typename T>
__global__ void __launch_bounds__(Parts<T>::kRows * 2 * kSplit) chunk_scan(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ states, const double* __restrict__ cum,
    T* __restrict__ y, const Dims d) {
  constexpr int PI = Parts<T>::kIn, PF = Parts<T>::kF32;
  constexpr int TM = Parts<T>::kRows, RW = TM / 16;  // warps of rows
  constexpr int kStages = ScanLayout<T>::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanLayout<T> lay(d.Qp, d.Np, d.Pp);
  const int ldn = static_cast<int>(lay.ldn);
  const int ldx = static_cast<int>(lay.ldx);
  const int ldh = static_cast<int>(lay.ldh);
  const int ldq = static_cast<int>(lay.ldq);
  float* s_cb = reinterpret_cast<float*>(smem);              // [TM][ldq]
  unsigned char* region = smem + lay.region;
  T* s_c = reinterpret_cast<T*>(region);                     // [TM][ldn]
  T* s_b = reinterpret_cast<T*>(region + lay.c_b);           // [Qp][ldn]

  const int tiles = d.Qp / TM + (d.Qp % TM ? 1 : 0);
  const int tile = blockIdx.x % tiles, bc = blockIdx.x / tiles;
  const int b = bc / d.nc, c = bc % d.nc;
  const int t0 = tile * TM;
  const int ns = min(d.Qp, t0 + TM);  // keys at or before the tile's rows
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int r0 = 16 * (warp % RW);     // the warp's rows in the tile
  const int part = warp / RW;          // its share of the depth
  const bool rows = t0 + r0 < d.Qp;
  const long long row0 = static_cast<long long>(b) * d.S + c * d.Q;

  stage_rows(s_c, ldn, Cm + (row0 + t0) * d.N, d.N, TM, d.Q - t0, d.N, d.Np);
  stage_rows(s_b, ldn, Bm + row0 * d.N, d.N, ns, d.Q, d.N, d.Np);
  __syncthreads();
  // CB = C B^T for the tile's rows against keys [0, ns), once for every
  // head, 64 keys at a time (the warps of a row tile take turns at the
  // blocks of keys); keys past a warp's last row are not needed.
  if (rows) {
    for (int s0 = 64 * part; s0 < ns && s0 <= t0 + r0 + 15;
         s0 += 64 * kSplit) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int k0 = 0; k0 < d.Np; k0 += 16) {
        uint32_t af[PI][4];
        load_a<PI>(s_c, ldn, r0, k0, af);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (s0 + 8 * j < ns) {
            uint32_t bf[PI][2];
            load_b<PI>(s_b, ldn, s0 + 8 * j, k0, bf);
            mma_parts<PI, PI>(acc[j], af, bf);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = s0 + 8 * j + 2 * q;
        if (s < ns) {
          *reinterpret_cast<float2*>(&s_cb[(r0 + g) * ldq + s]) =
              make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(&s_cb[(r0 + g + 8) * ldq + s]) =
              make_float2(acc[j][2], acc[j][3]);
        }
      }
    }
  }

  const int ta = t0 + r0 + g, tb = ta + 8;  // this lane's two rows
  // The warp's depth: its share of C h's, and of the keys at or before
  // its rows for the intra-chunk term (k-steps [lo, hi) of 16; a share of
  // C h's is at most 2, as N <= 128).
  const int kn = d.Np / 16;
  const int kq = min(t0 + r0 + 16, d.Qp) / 16;
  const int kn0 = part * kn / kSplit, kn1 = (part + 1) * kn / kSplit;
  const int kq0 = part * kq / kSplit, kq1 = (part + 1) * kq / kSplit;
  // C's A fragments of the warp's share: after this, C lives in them.
  uint32_t cf[2][PI][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (rows && kn0 + i < kn1) load_a<PI>(s_c, ldn, r0, 16 * (kn0 + i), cf[i]);
  __syncthreads();  // the region's C and B are free

  const int h0 = blockIdx.y * kHeads;
  const int nh = min(kHeads, d.H - h0);
  if (kStages == 2) {
    fetch_head(lay, region, d, x, states, cum, dt, b, c, h0, ns, row0);
    cp_commit();
  }
  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    unsigned char* buf = region + (kStages == 2 ? (i & 1) * lay.stage : 0);
    if (kStages == 2) {
      if (i + 1 < nh)
        fetch_head(lay, region + ((i + 1) & 1) * lay.stage, d, x, states,
                   cum, dt, b, c, h + 1, ns, row0);
      cp_commit();  // empty after the last head
      cp_wait<1>();  // head i's copies have landed
    } else {
      fetch_head(lay, buf, d, x, states, cum, dt, b, c, h, ns, row0);
      cp_commit();
      cp_wait<0>();
    }
    __syncthreads();
    const T* s_x = reinterpret_cast<const T*>(buf);
    const float* s_h = reinterpret_cast<const float*>(buf + lay.h);
    const double* s_cum = reinterpret_cast<const double*>(buf + lay.cum);
    const float* s_dt = reinterpret_cast<const float*>(buf + lay.dt);

    float acc[kMaxP / 8][4];
#pragma unroll
    for (int j = 0; j < kMaxP / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (rows) {
      // exp(cum_t) C_t . h_prev, over this share of the state's depth.
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        if (kn0 + i2 >= kn1) continue;
        const int k0 = 16 * (kn0 + i2);
#pragma unroll
        for (int j = 0; j < kMaxP / 8; ++j) {
          if (8 * j < d.Pp) {
            uint32_t bf[PF][2];
            load_b_rows<PF>(s_h, ldh, 8 * j, k0, bf);
            mma_parts<PI, PF>(acc[j], cf[i2], bf);
          }
        }
      }
      const float ea = expf(__double2float_rn(s_cum[ta]));
      const float eb = expf(__double2float_rn(s_cum[tb]));
#pragma unroll
      for (int j = 0; j < kMaxP / 8; ++j) {
        acc[j][0] = __fmul_rn(acc[j][0], ea);
        acc[j][1] = __fmul_rn(acc[j][1], ea);
        acc[j][2] = __fmul_rn(acc[j][2], eb);
        acc[j][3] = __fmul_rn(acc[j][3], eb);
      }
      // + (CB * decay * dt) . x over this share of the keys at or before
      // the warp's rows.
      for (int kk = kq0; kk < kq1; ++kk) {
        const int k0 = 16 * kk;
        uint32_t af[PF][4], t[PF];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int tr = (r & 1) ? tb : ta;
          const int s = k0 + 2 * q + ((r & 2) ? 8 : 0);
          const float2 cb = *reinterpret_cast<const float2*>(
              &s_cb[(tr - t0) * ldq + s]);
          float w0 = 0.f, w1 = 0.f;
          if (s <= tr)
            w0 = __fmul_rn(__fmul_rn(cb.x, exp_diff(s_cum[tr], s_cum[s])),
                           s_dt[s]);
          if (s + 1 <= tr)
            w1 = __fmul_rn(__fmul_rn(cb.y, exp_diff(s_cum[tr], s_cum[s + 1])),
                           s_dt[s + 1]);
          split_pair<PF>(w0, w1, t);
#pragma unroll
          for (int i2 = 0; i2 < PF; ++i2) af[i2][r] = t[i2];
        }
#pragma unroll
        for (int j = 0; j < kMaxP / 8; ++j) {
          if (8 * j < d.Pp) {
            uint32_t bf[PI][2];
            load_b_rows<PI>(s_x, ldx, 8 * j, k0, bf);
            mma_parts<PF, PI>(acc[j], af, bf);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the buffer's x and state
    // The partial sums of a row tile's other warps go to the buffer just
    // read, [kSplit - 1][RW][32][kPartLd]; the tile's first warp adds
    // them to its own in the warps' order and puts y's rows in s_y, which
    // the block then stores 16 bytes a thread.
    float* s_part = reinterpret_cast<float*>(buf);
    T* s_y = reinterpret_cast<T*>(smem + lay.y);
    const int ldy = static_cast<int>(lay.ldy);
    const int lane_at = (warp % RW) * 32 + lane;
    if (part > 0 && rows) {
      float* dst = s_part + ((part - 1) * RW * 32 + lane_at) * kPartLd;
#pragma unroll
      for (int j = 0; j < kMaxP / 8; ++j)
        if (8 * j < d.Pp)
          *reinterpret_cast<float4*>(&dst[4 * j]) =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
    __syncthreads();
    if (part == 0 && rows) {
#pragma unroll
      for (int j = 0; j < kMaxP / 8; ++j) {
        const int p = 8 * j + 2 * q;
        if (p >= d.P) continue;
        float v[4] = {acc[j][0], acc[j][1], acc[j][2], acc[j][3]};
#pragma unroll
        for (int o = 0; o < kSplit - 1; ++o) {
          const float4 w = *reinterpret_cast<const float4*>(
              &s_part[(o * RW * 32 + lane_at) * kPartLd + 4 * j]);
          v[0] = __fadd_rn(v[0], w.x);
          v[1] = __fadd_rn(v[1], w.y);
          v[2] = __fadd_rn(v[2], w.z);
          v[3] = __fadd_rn(v[3], w.w);
        }
        store2(s_y + (ta - t0) * ldy + p, v[0], v[1]);
        store2(s_y + (tb - t0) * ldy + p, v[2], v[3]);
      }
    }
    __syncthreads();
    {
      constexpr int V = 16 / sizeof(T);
      const int per = d.P / V, nr = min(TM, d.Q - t0);
      for (int e = tid; e < nr * per; e += blockDim.x) {
        const int r = e / per, c0 = (e - r * per) * V;
        *reinterpret_cast<uint4*>(y + ((row0 + t0 + r) * d.H + h) * d.P
                                  + c0) =
            *reinterpret_cast<const uint4*>(s_y + r * ldy + c0);
      }
    }
    __syncthreads();  // the partial sums and y are read: the buffer is free
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* h, float* states, float* cum_end,
           double* cum, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  if (Q <= 0 || Q > kMaxQ || S % Q || N > kMaxN || N % 8 || P > kMaxP
      || P % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {x, Bm, Cm, y};  // 16-byte loads and stores
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  Dims d{B, S, H, P, N, Q, S / Q, up16(Q), up16(N), up8(P)};
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const int groups = (H + kHeads - 1) / kHeads;

  const size_t s1 = state_smem_bytes<T>(d.Qp, d.Np, d.Pp);
  cudaError_t e = allow_smem(chunk_state<T>, s1);
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk_state<T><<<dim3(B * d.nc, (H + kStateHeads - 1) / kStateHeads),
                   256, s1, stream>>>(xt, dt, A, bt, states, cum_end, cum, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int NP = N * P;
  state_pass<<<dim3(B * H, (NP + 4 * kStateThreads - 1) / (4 * kStateThreads)),
               kStateThreads, 0, stream>>>(states, cum_end, h, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr int TM = Parts<T>::kRows;
  const int tiles = (d.Qp + TM - 1) / TM;
  const size_t s3 = ScanLayout<T>(d.Qp, d.Np, d.Pp).total;
  e = allow_smem(chunk_scan<T>, s3);
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk_scan<T><<<dim3(B * d.nc * tiles, groups), TM * 2 * kSplit, s3,
                  stream>>>(
      xt, dt, bt, ct, states, cum, static_cast<T*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x/y: [B, S, H, P] and Bm/Cm: [B, S, N], contiguous, of element type
// `dtype` (0 = f32, 1 = bf16); dt f32 [B, S, H]; A f32 [H]; h f32
// [B, H, N, P] (the state after the last chunk); `states` f32 scratch of
// B (S / Q) H N P elements, `cum_end` f32 of B (S / Q) H and `cum` f64 of
// B (S / Q) H Qp (Qp: Q rounded up to a multiple of 16). S a multiple of
// Q; Q <= 256; N <= 128 and P <= 64, both multiples of 8; x, Bm, Cm and y
// 16-byte aligned. Three launches on `stream`; returns the first launch
// error.
int ssd_scan_launch(const void* x, const float* dt, const float* A,
                    const void* Bm, const void* Cm, void* y, float* h,
                    float* states, float* cum_end, double* cum, int dtype,
                    int B, int S, int H, int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, h, states, cum_end, cum, B, S,
                         H, P, N, Q, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h, states, cum_end,
                                 cum, B, S, H, P, N, Q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
