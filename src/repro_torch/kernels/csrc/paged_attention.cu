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
// mistral-nemo, 16 for recurrentgemma: 2 to 8 flops a byte of bf16), far
// below the card's balance point. A (sequence, kv head) alone is too
// little work for the card (B x KV = 64 blocks for mistral-nemo, 8 for
// recurrentgemma, on 132 SMs), so its tokens are split across blocks: the
// grid is B x KV x n_split, and block s takes the tokens [s span, (s + 1)
// span), a run of whole pages (the wrapper's split_plan chooses n_split
// and span from the shapes alone). A block serves the head's G
// query heads, so each K/V element is read from device memory once. It
// reads its pages' slots once, skips pages whose slot is -1 or past the
// pool and tokens past the length or below the window; a block left with
// none finishes at once. Tiles of at most 64 tokens of one page are
// copied to shared memory with 16-byte cp.async, K and V as two groups:
// the next tile's K lands while this tile's softmax and P V run, its V
// while its own scores are computed. K rows are padded by 16 bytes so
// the scores' 16-byte reads hit distinct banks. Thread (token, GT query
// heads) computes scores as four partial sums, reusing each K vector GT
// times (GT = 4 at G >= 8); a warp a query head updates the softmax; each
// thread folds the tile into GT x 4 outputs (query heads x head dims) of
// acc in registers, over every TG-th token where the outputs are fewer
// than the threads, and the TG partial sums are added in order at the
// end.
//
// The merge, in the same launch: each block writes its partial (acc, m,
// l) to an f32 workspace [B, KV, n_split, G, hd + 2] (acc only if it saw a
// token), fences, and counts itself on an int32 counter of its
// (sequence, kv head); the block that arrives last lists the splits that
// saw a token and merges their partials in split order (acc = sum_s
// exp(m_s - M) acc_s with M = max_s m_s, and l alike), four splits'
// loads in flight at a time, so the result is the same bit for bit from
// run to run; it writes (acc, m, l) and resets the counter to 0 for the
// next launch on the stream. The head dim must be a multiple of 16
// bytes' worth of elements, and the pool 16-byte aligned (the wrapper
// checks).
//
// int8 pools (the serving engine's kv_dtype "int8"; dtype code 2) come
// with an f32 scale pool, one scale a (slot, token, k/v) of the layer,
// [page, 2] contiguous a slot and `scale_stride` floats between slots.
// The tile copies bring the codes into int8 staging rows, each token's k
// scale with its K rows and its v scale with its V rows (4-byte
// cp.async, into two [kTile] arrays). Once a tile's K (then its V) has
// landed, the block dequantizes it once into the bf16 rows the bf16 path
// reads, each code as the reference's bf16(f32(q) * sc)
// (repro/serving/kvpool.py: read_pages); from there the arithmetic is the
// bf16 path's, so the result equals the bf16 kernel's on the dequantized
// pool bit for bit. The pass and its barrier cost a fifth of the bf16
// time, whether the next tile's copy starts before or after it (an H100
// measures the pair of tier launches at 1.22x bf16's); dequantizing inside
// the score loop instead repeats it for every query head of a thread's
// group and took 1.8x. A page skipped for its slot has no scale read. int8 halves the
// bytes a token moves against bf16: hd bytes of K and of V plus 8 bytes
// of scales.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;   // tokens staged at a time
constexpr int kItems = 2;   // acc units a thread, at most
constexpr int kMerge = 8;   // head-dim pairs a thread merges at a time
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__host__ __device__ constexpr int vec_elems() {  // elements in 16 bytes
  return 16 / static_cast<int>(sizeof(T));
}

// Four consecutive elements as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Four int8 codes with their scale as bf16, as the reference dequantizes
// them: bf16(f32(q) * sc), rounded to nearest even. f32(q) is exact
// without the slow integer conversion: q + 128 as the low byte of the
// float 2^23 (one byte permute), minus 2^23 + 128.
__device__ __forceinline__ void deq4(const int8_t* src, float sc,
                                     __nv_bfloat16* dst) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(src) ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = (__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + i)) -
            8388736.f) * sc;
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  d[0] = __floats2bfloat162_rn(f[0], f[1]);
  d[1] = __floats2bfloat162_rn(f[2], f[3]);
}

// The type the block computes from: bf16 for int8 codes (dequantized in
// shared memory), else the pool's own.
template <typename T>
using compute_t = typename std::conditional<std::is_same<T, int8_t>::value,
                                            __nv_bfloat16, T>::type;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// The acc work of a tile: n_items items (GT query heads x 4 head dims),
// each taken by TG threads over every TG-th token. Fewer items than
// threads leave TG > 1, so that every thread has a share.
__host__ __device__ inline int token_groups(int n_items) {
  return n_items >= kThreads ? 1 : min(4, kThreads / n_items);
}

// Byte offsets of the shared-memory arrays (host and kernel agree).
struct Smem {
  int q, p, m, l, c, a, w, slot, live, ksc, vsc, k, v, k8, v8, total;
  __host__ __device__ Smem(int G, int hd, int n_split, int n_bp, int TG,
                           int elem) {
    int o = 0;  // the f32 arrays read as float4 first: 16-byte aligned
    q = o;    o += 4 * G * hd;           // [G, hd] the queries, f32
    a = o;    o += 4 * TG * G * hd;      // [TG, G, hd] acc by token group
    p = o;    o += 4 * G * kTile;        // [G, kTile] scores, then weights
    m = o;    o += 4 * G;                // [G] running max
    l = o;    o += 4 * G;                // [G] running sum
    c = o;    o += 4 * G;                // [G] the tile's rescale
    o = (o + 15) / 16 * 16;
    w = o;    o += 8 * G * n_split;      // [G, n_split] (m, l), then weight
    slot = o; o += 4 * n_bp;             // the block's page slots
    live = o; o += 4 * (n_split + 1);    // splits with a token, and count
    const bool int8 = elem == 1;
    const int n_sc = int8 ? 4 * kTile : 0;  // int8: the tile's scales
    ksc = o;  o += n_sc;                 // [kTile] k scales
    vsc = o;  o += n_sc;                 // [kTile] v scales
    o = (o + 15) / 16 * 16;
    const int ce = int8 ? 2 : elem;      // the compute type's bytes
    const int V = 16 / ce;
    k = o;    o += ce * kTile * (hd + V);  // K rows padded by 16 bytes
    v = o;    o += ce * kTile * hd;
    const int n8 = int8 ? kTile * hd : 0;  // int8: the codes as copied
    k8 = o;   o += n8;
    v8 = o;   o += n8;
    total = o;
  }
};

template <typename T, int GT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q, const T* __restrict__ pool,
                       long long slot_stride,
                       const float* __restrict__ kv_scale,
                       long long sc_stride,
                       int n_slots,
                       const int* __restrict__ page_slot,
                       const int* __restrict__ lengths,
                       float* __restrict__ part, int* __restrict__ counters,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int H, int KV, int hd,
                       int page, int n_pages, int n_split, int span,
                       int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  const int split = blockIdx.x % n_split;
  const int bk = blockIdx.x / n_split;  // b * KV + kv head
  const int b = bk / KV, kvh = bk % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  using C = compute_t<T>;
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  constexpr int V = vec_elems<C>();
  constexpr int VT = vec_elems<T>();  // the pool's elements in 16 bytes
  const int ks = hd + V;   // K row padded by 16 bytes
  const int vpr = hd / V;  // 16-byte vectors a row
  const int dgs = hd / 4;
  const int n_items = G / GT * dgs;
  const int TG = token_groups(n_items);
  const int n_bp = span / page;  // a split's pages (span is whole pages)
  const Smem lay(G, hd, n_split, n_bp, TG, sizeof(T));
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* p_s = reinterpret_cast<float*>(smem + lay.p);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* c_s = reinterpret_cast<float*>(smem + lay.c);
  float* a_s = reinterpret_cast<float*>(smem + lay.a);
  float2* w_s = reinterpret_cast<float2*>(smem + lay.w);
  int* slot_s = reinterpret_cast<int*>(smem + lay.slot);
  int* live_s = reinterpret_cast<int*>(smem + lay.live);
  C* k_s = reinterpret_cast<C*>(smem + lay.k);  // [kTile, ks]
  C* v_s = reinterpret_cast<C*>(smem + lay.v);  // [kTile, hd]
  // Where the copies land: the rows themselves, or for int8 the staging
  // rows [kTile, hd] of codes and the scales.
  T* k_in = reinterpret_cast<T*>(smem + (kQuant ? lay.k8 : lay.k));
  T* v_in = reinterpret_cast<T*>(smem + (kQuant ? lay.v8 : lay.v));
  const int k_pitch = kQuant ? hd : ks;
  float* ksc_s = reinterpret_cast<float*>(smem + lay.ksc);  // int8 only
  float* vsc_s = reinterpret_cast<float*>(smem + lay.vsc);

  const int len = lengths[b];
  const int lo = window > 0 ? max(len - window, 0) : 0;  // first live token
  const int t_end = min(min((split + 1) * span, n_pages * page), len);
  const int p_first = split * span / page;
  const long long tok_stride = 2LL * KV * hd;
  const float* qb = q + (static_cast<long long>(b) * H + kvh * G) * hd;
  for (int e = tid; e < G * hd; e += kThreads) q_s[e] = qb[e];
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }
  for (int i = tid; i < n_bp; i += kThreads)
    slot_s[i] = p_first + i < n_pages
                    ? page_slot[static_cast<long long>(b) * n_pages +
                                p_first + i]
                    : -1;
  // acc unit u = tid + i kThreads (u < n_items TG): item u % n_items,
  // query heads gg GT..gg GT + GT - 1 and head dims 4 dg..4 dg + 3, over
  // the tokens tg, tg + TG, .. of each tile, tg = u / n_items.
  float acc[kItems][GT][4];
#pragma unroll
  for (int i = 0; i < kItems; ++i)
#pragma unroll
    for (int gi = 0; gi < GT; ++gi)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][gi][x] = 0.f;
  __syncthreads();

  // The block's tiles: at most kTile live tokens of one page whose slot
  // is in the pool, in order. next(t0) is the first at or after token t0.
  struct Tile {
    int t0, n;
    const T* base;       // its first token's K row; V is KV hd further
    const float* sbase;  // int8: its first token's (k, v) scales
  };
  auto next = [&](int t0) {
    while (t0 < t_end) {
      const int p = t0 / page;
      const int p_end = min((p + 1) * page, t_end);
      const int slot = slot_s[p - p_first];
      if (slot >= 0 && slot < n_slots) {
        const long long in_page = t0 - p * page;
        return Tile{t0, min(kTile, p_end - t0),
                    pool + slot * slot_stride + in_page * tok_stride +
                        static_cast<long long>(kvh) * hd,
                    kQuant ? kv_scale + slot * sc_stride + 2 * in_page
                           : nullptr};
      }
      t0 = p_end;
    }
    return Tile{t_end, 0, nullptr, nullptr};
  };
  // 16-byte copies of a tile's K rows or V rows (off = 0 or KV hd), and
  // for int8 their scales (which = 0 or 1), as one group (empty for no
  // tile).
  auto copy = [&](const Tile& tl, T* dst, int pitch, long long off,
                  float* sc_dst, int which) {
    const int n_vec = hd / VT;
    for (int e = tid; e < tl.n * n_vec; e += kThreads) {
      const int t = e / n_vec, c = e - t * n_vec;
      cp_async16(dst + t * pitch + c * VT, tl.base + t * tok_stride + off +
                                               c * VT);
    }
    if constexpr (kQuant)
      for (int t = tid; t < tl.n; t += kThreads)
        cp_async4(sc_dst + t, tl.sbase + 2 * t + which);
    cp_async_commit();
  };
  // int8: a landed tile's codes (n rows) into bf16 rows of `pitch`, each
  // code dequantized once (then a barrier before the rows are read).
  auto dequant = [&](const T* src, const float* sc, C* dst, int pitch,
                     int n) {
    const int q4 = hd / 4;
    for (int e = tid; e < n * q4; e += kThreads) {
      const int t = e / q4, c = e - t * q4;
      deq4(reinterpret_cast<const int8_t*>(src) + t * hd + 4 * c, sc[t],
           reinterpret_cast<__nv_bfloat16*>(dst + t * pitch + 4 * c));
    }
    __syncthreads();
  };
  // The next tile's K lands while this tile's softmax and P V run, its V
  // while its own scores are computed: groups K0 V0 K1 V1 .., each wait
  // leaves the newest group in flight.
  const long long v_off = static_cast<long long>(KV) * hd;
  Tile cur = next(max(split * span, lo));
  copy(cur, k_in, k_pitch, 0, ksc_s, 0);
  copy(cur, v_in, hd, v_off, vsc_s, 1);
  while (cur.n > 0) {
    const int n = cur.n;  // tokens of this tile
    const Tile nxt = next(cur.t0 + n);
    cp_async_wait<1>();  // this tile's K
    __syncthreads();
    if constexpr (kQuant) dequant(k_in, ksc_s, k_s, ks, n);

    // Scores: thread (token t, query heads gq GT..gq GT + GT - 1); a warp
    // reads 32 K rows, the queries are broadcast.
    for (int gq = tid / kTile; gq < G / GT; gq += kThreads / kTile) {
      const int t = tid % kTile;
      // Four partial sums a query head (over the four lanes of each
      // float4), so that the multiply-adds do not wait on one another.
      float s[GT][4];
#pragma unroll
      for (int gi = 0; gi < GT; ++gi)
#pragma unroll
        for (int x = 0; x < 4; ++x) s[gi][x] = 0.f;
      if (t < n) {
        const C* kr = k_s + t * ks;
        const float* qg = q_s + gq * GT * hd;
        for (int c = 0; c < vpr; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * V);
          const C* x = reinterpret_cast<const C*>(&raw);
#pragma unroll
          for (int j = 0; j < V; j += 4) {
#pragma unroll
            for (int gi = 0; gi < GT; ++gi) {
              const float4 qv = load4(qg + gi * hd + c * V + j);
              s[gi][0] = fmaf(qv.x, to_f32(x[j]), s[gi][0]);
              s[gi][1] = fmaf(qv.y, to_f32(x[j + 1]), s[gi][1]);
              s[gi][2] = fmaf(qv.z, to_f32(x[j + 2]), s[gi][2]);
              s[gi][3] = fmaf(qv.w, to_f32(x[j + 3]), s[gi][3]);
            }
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < GT; ++gi)
        p_s[(gq * GT + gi) * kTile + t] =
            t < n ? ((s[gi][0] + s[gi][1]) + (s[gi][2] + s[gi][3])) * scale
                  : kNeg;
    }
    __syncthreads();
    copy(nxt, k_in, k_pitch, 0, ksc_s, 0);

    // The softmax update: a warp a query head, two tokens a lane.
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * kTile;
      const float s0 = pg[lane], s1 = pg[lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float e0 = lane < n ? expf(s0 - m_new) : 0.f;
      const float e1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
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
    cp_async_wait<1>();  // this tile's V
    __syncthreads();
    if constexpr (kQuant) dequant(v_in, vsc_s, v_s, hd, n);

#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int u = tid + i * kThreads;
      if (u < n_items * TG) {
        const int item = u % n_items, tg = u / n_items;
        const int gg = item / dgs, dg = item - gg * dgs;
        const float* pg = p_s + gg * GT * kTile;
#pragma unroll
        for (int gi = 0; gi < GT; ++gi) {
          const float corr = c_s[gg * GT + gi];
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[i][gi][x] *= corr;
        }
        for (int t = tg; t < n; t += TG) {
          const float4 vv = load4(v_s + t * hd + 4 * dg);
#pragma unroll
          for (int gi = 0; gi < GT; ++gi) {
            const float pt = pg[gi * kTile + t];
            acc[i][gi][0] = fmaf(pt, vv.x, acc[i][gi][0]);
            acc[i][gi][1] = fmaf(pt, vv.y, acc[i][gi][1]);
            acc[i][gi][2] = fmaf(pt, vv.z, acc[i][gi][2]);
            acc[i][gi][3] = fmaf(pt, vv.w, acc[i][gi][3]);
          }
        }
      }
    }
    __syncthreads();  // V and the weights are read
    copy(nxt, v_in, hd, v_off, vsc_s, 1);
    cur = nxt;
  }
  cp_async_wait<0>();

  // acc by token group into shared memory, then summed in group order.
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int u = tid + i * kThreads;
    if (u < n_items * TG) {
      const int item = u % n_items, tg = u / n_items;
      const int gg = item / dgs, dg = item - gg * dgs;
#pragma unroll
      for (int gi = 0; gi < GT; ++gi)
        *reinterpret_cast<float4*>(a_s + (tg * G + gg * GT + gi) * hd +
                                   4 * dg) =
            make_float4(acc[i][gi][0], acc[i][gi][1], acc[i][gi][2],
                        acc[i][gi][3]);
    }
  }
  __syncthreads();

  const long long hb = static_cast<long long>(b) * H + kvh * G;
  const int row = hd + 2;  // a query head's partial: acc, m, l
  float* mine =
      part + (static_cast<long long>(bk) * n_split + split) * G * row;
  const bool saw = l_s[0] > 0.f;  // all query heads see the same tokens
  if (n_split == 1 || saw) {
    for (int e = tid; e < G * hd / 2; e += kThreads) {  // head-dim pairs
      const int g = 2 * e / hd, d = 2 * e - g * hd;
      float2 x = *reinterpret_cast<const float2*>(a_s + g * hd + d);
      for (int tg = 1; tg < TG; ++tg) {
        const float2 y =
            *reinterpret_cast<const float2*>(a_s + (tg * G + g) * hd + d);
        x.x += y.x;
        x.y += y.y;
      }
      if (n_split == 1)
        *reinterpret_cast<float2*>(acc_out + (hb + g) * hd + d) = x;
      else
        *reinterpret_cast<float2*>(mine + g * row + d) = x;
    }
  }
  if (n_split == 1) {
    for (int g = tid; g < G; g += kThreads) {
      m_out[hb + g] = m_s[g];
      l_out[hb + g] = l_s[g];
    }
    return;
  }
  for (int g = tid; g < G; g += kThreads)
    *reinterpret_cast<float2*>(mine + g * row + hd) =
        make_float2(m_s[g], l_s[g]);
  __threadfence();
  __syncthreads();
  if (tid == 0) live_s[n_split] = atomicAdd(counters + bk, 1) == n_split - 1;
  __syncthreads();
  const bool last = live_s[n_split] != 0;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The last block merges the partials in split order: M = max_s m_s,
  // acc = sum_s exp(m_s - M) acc_s and l alike, over the splits that saw
  // a token (their list first, so that the partials' loads are batched).
  const float* first = part + static_cast<long long>(bk) * n_split * G * row;
  const long long split_stride = static_cast<long long>(G) * row;
  if (warp == 0) {
    int n_live = 0;
    for (int s0 = 0; s0 < n_split; s0 += 32) {
      const int s = s0 + lane;
      const bool on =
          s < n_split && __ldcg(first + s * split_stride + hd + 1) > 0.f;
      const unsigned mask = __ballot_sync(~0u, on);
      if (on) live_s[n_live + __popc(mask & ((1u << lane) - 1))] = s;
      n_live += __popc(mask);
    }
    __syncwarp();
    if (lane == 0) live_s[n_split] = n_live;
  }
  __syncthreads();
  const int n_live = live_s[n_split];
  for (int e = tid; e < G * n_live; e += kThreads) {  // every (m, l) at once
    const int g = e / n_live, i = e - g * n_live;
    w_s[g * n_split + i] = __ldcg(reinterpret_cast<const float2*>(
        first + live_s[i] * split_stride + g * row + hd));
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float2* ml = w_s + g * n_split;
    float mx = kNeg;
    for (int i = 0; i < n_live; ++i) mx = fmaxf(mx, ml[i].x);
    float l = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const float w = expf(ml[i].x - mx);
      ml[i].x = w;
      l = fmaf(w, ml[i].y, l);
    }
    m_out[hb + g] = mx;
    l_out[hb + g] = l;
  }
  __syncthreads();
  const int n_pairs = G * hd / 2;
  for (int e0 = 0; e0 < n_pairs; e0 += kThreads * kMerge) {
    float2 a[kMerge];
#pragma unroll
    for (int u = 0; u < kMerge; ++u) a[u] = make_float2(0.f, 0.f);
    for (int i0 = 0; i0 < n_live; i0 += 4) {  // four splits' loads at once
      float2 x[4][kMerge];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < kMerge; ++u) {
          const int e = e0 + u * kThreads + tid;
          const int g = 2 * e / hd, d = 2 * e - g * hd;
          x[j][u] = i0 + j < n_live && e < n_pairs
                        ? __ldcg(reinterpret_cast<const float2*>(
                              first + live_s[i0 + j] * split_stride +
                              g * row + d))
                        : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < kMerge; ++u) {
          const int e = e0 + u * kThreads + tid;
          if (i0 + j < n_live && e < n_pairs) {
            const float w = w_s[(2 * e / hd) * n_split + i0 + j].x;
            a[u].x = fmaf(w, x[j][u].x, a[u].x);
            a[u].y = fmaf(w, x[j][u].y, a[u].y);
          }
        }
    }
#pragma unroll
    for (int u = 0; u < kMerge; ++u) {
      const int e = e0 + u * kThreads + tid;
      if (e < n_pairs) {
        const int g = 2 * e / hd, d = 2 * e - g * hd;
        *reinterpret_cast<float2*>(acc_out + (hb + g) * hd + d) = a[u];
      }
    }
  }
  if (tid == 0) counters[bk] = 0;
}

template <typename T, int GT>
int launch_t(const float* q, const void* pool, long long slot_stride,
             const float* kv_scale, long long sc_stride, int n_slots,
             const int* page_slot, const int* lengths, float* part,
             int* counters, float* acc, float* m, float* l,
             int B, int H, int KV, int hd, int page, int n_pages, int n_split,
             int span, int window, cudaStream_t stream) {
  const int G = H / KV;
  const Smem lay(G, hd, n_split, span / page,
                 token_groups(G / GT * (hd / 4)), sizeof(T));
  auto kern = paged_attention_kernel<T, GT>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  kern<<<B * KV * n_split, kThreads, lay.total, stream>>>(
      q, static_cast<const T*>(pool), slot_stride, kv_scale, sc_stride,
      n_slots, page_slot, lengths, part, counters, acc, m, l, H, KV, hd,
      page, n_pages, n_split, span, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int G, const float* q, const void* pool, long long slot_stride,
           const float* kv_scale, long long sc_stride, int n_slots,
           const int* page_slot, const int* lengths, float* part,
           int* counters, float* acc, float* m, float* l, int B, int H,
           int KV, int hd, int page, int n_pages, int n_split, int span,
           int window, cudaStream_t st) {
  if (G >= 8 && G % 4 == 0)
    return launch_t<T, 4>(q, pool, slot_stride, kv_scale, sc_stride, n_slots,
                          page_slot, lengths, part, counters, acc, m, l, B,
                          H, KV, hd, page, n_pages, n_split, span, window,
                          st);
  return launch_t<T, 1>(q, pool, slot_stride, kv_scale, sc_stride, n_slots,
                        page_slot, lengths, part, counters, acc, m, l, B, H,
                        KV, hd, page, n_pages, n_split, span, window, st);
}

}  // namespace

extern "C" {

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The query heads a kv head that one thread's registers hold at most:
// G / GT x hd / 4 acc items over kThreads x kItems.
int paged_attention_max_items() { return kThreads * kItems; }

// q f32 [B, H, hd]; pool: element type `dtype` (0 = f32, 1 = bf16, 2 =
// int8), slot 0 of the layer at `pool`, slots `slot_stride` elements
// apart, each [page, 2, KV, hd] contiguous; kv_scale (int8 only, else
// unread): f32 [slots, page, 2] of the layer, slots `scale_stride` floats
// apart, 8-byte aligned; page_slot int32 [B, n_pages]; lengths
// int32 [B]; window: tokens below lengths - window are masked (<= 0:
// none); n_split blocks a (sequence, kv head), block s over the tokens
// [s span, (s + 1) span); part: f32 workspace [B, KV, n_split, H / KV,
// hd + 2]; counters: int32 [>= B KV], zero, left zero; acc f32 [B, H,
// hd], m/l f32 [B, H]. Returns the launch error.
int paged_attention_launch(const float* q, const void* pool, int dtype,
                           long long slot_stride, const float* kv_scale,
                           long long scale_stride, int n_slots,
                           const int* page_slot, const int* lengths,
                           float* part, int* counters, float* acc, float* m,
                           float* l, int B, int H, int KV, int hd, int page,
                           int n_pages, int n_split, int span, int window,
                           void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  if (dtype == 0)
    return launch<float>(G, q, pool, slot_stride, kv_scale, scale_stride,
                         n_slots, page_slot, lengths, part, counters, acc, m,
                         l, B, H, KV, hd, page, n_pages, n_split, span,
                         window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(G, q, pool, slot_stride, kv_scale,
                                 scale_stride, n_slots, page_slot, lengths,
                                 part, counters, acc, m, l, B, H, KV, hd,
                                 page, n_pages, n_split, span, window, st);
  if (dtype == 2) {
    if (kv_scale == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<int8_t>(G, q, pool, slot_stride, kv_scale, scale_stride,
                          n_slots, page_slot, lengths, part, counters, acc,
                          m, l, B, H, KV, hd, page, n_pages, n_split, span,
                          window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
