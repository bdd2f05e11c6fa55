// Tier-1 cache scan for Hopper (sm_90a): the whole request loop of one
// shard row per thread block (or per cluster of blocks), from the cold
// init_store state.
//
// Replaces the Pallas TPU kernel repro/kernels/cache_scan.py:
// cache_scan_kernel (body _cache_scan_body) and computes exactly what the
// plain PyTorch version repro_torch/kernels/ref.py:cache_scan_ref computes:
// every counter equal, the f32 expert weights equal bit for bit.
//
// What bounds it: the request loop is serial. Each step depends on the
// previous step's cache state, so a row is one long chain of steps. Most
// steps are hits, so what a step costs on that chain is what matters; an
// eviction adds block-wide work (LRU / LFU argmins and one threefry draw a
// line for the Random expert).
//
// The design:
// - The per-line state (tags, ts, freq as int32 and dirty as bits; 12.1 B a
//   line) lives in shared memory when it fits the block (16,384 lines take
//   194 KiB), else in device scratch that stays in L2 (the kSmemState =
//   false instantiation; the wrapper chooses from the sizes, never after a
//   failure). The state arrays are contiguous, so a later carried-state
//   mode can load them from a buffer and store them back.
// - Look-ahead: the block looks up the pages of the next K requests in one
//   pass (the K pages go into a hash table in shared memory, then every
//   filled line probes it with its tag). One warp, the walker, then runs
//   the K steps in order and corrects each looked-up line with what the
//   walk itself changed: a miss that fills a slot points the later
//   requests of the same page in the window at that slot, and a looked-up
//   line is a hit only if it still holds the page. Tags are unique among
//   filled lines, so this is exact.
// - The walker runs the learner, the prediction rings, the prefetcher, the
//   fills and the dirty / freq / ts updates with no block barrier; it calls
//   the block (a named barrier over all warps but the key warp) only for
//   the look-ahead pass, an eviction's victim proposals and an active
//   prefetch probe. Its registers are replicated across its 32 lanes (every
//   lane computes the same scalar step); lane 0 alone writes shared state,
//   and the lanes split the ring, prefetch-buffer and look-ahead scans.
// - A run of hits is one walker iteration: lane i checks step k + i, and
//   the run ends at the first miss or change of window id (at most 32
//   steps). No line changes hands before the next miss, so the run's
//   updates commute (freq adds, ts takes the latest step, dirty ors) and
//   the lanes make them at once; epoch boundaries inside the run update
//   the learner in order (a boundary with no miss in its epoch changes
//   nothing once the weights are a fixed point).
// - The request stream is staged ahead of the walker: the pass of window j
//   issues cp.async copies of window j + 1's pages, write flags and window
//   ids into the other half of a double-buffered shared ring.
// - The PRNG key chain (one split a step) runs on its own warp, ahead of
//   the walker, into a ring of draw keys two windows deep.
// - Where rows are fewer than SMs, a row is a thread-block cluster: the
//   other blocks of the cluster draw the Random expert's uniforms for their
//   share of the lines (the draws depend only on the step's key and the
//   line, not on the cache state) and hand their packed (~u, line) minimum
//   back through distributed shared memory. The first-index argmax over all
//   lines is the minimum of the shares' minima, so every cluster size gives
//   the same victims.
//
// Float arithmetic: the weight update is spelled with explicit roundings
// (__fadd_rn / __fmul_rn / __fdiv_rn, and __fmaf_rn exactly where the
// reference's compiler contracts a product into a fused multiply-add) in
// the order of the plain version, and beta**loss comes from the same pow
// table, so the weights -- whose argmax picks evictions -- agree bit for
// bit. The source is built with --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kExperts = 3;
constexpr unsigned long long kNoKey = ~0ull;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 8;
constexpr int kMaxWarps = 16;      // a block has at most 512 threads
constexpr int kPassBarriers = 4;   // group barriers inside Group::pass
constexpr int kGroupBar = 1;  // named barrier: every warp but the key warp
// Commands from the walker to the group (and to the cluster's helpers).
constexpr int kCmdPass = 1, kCmdEvict = 2, kCmdProbe = 3, kCmdEnd = 4;
// Slots of s_misc.
constexpr int kCmd = 0, kT0 = 1, kNv = 2, kVk0 = 3, kVk1 = 4, kKeyDone = 5,
              kWalkT0 = 6, kMisc = 8;

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t here = at;
  at = (at + bytes + 15) & ~static_cast<size_t>(15);
  return here;
}

__host__ __device__ inline int hash_size(int K) {
  int ts = 1;
  while (ts < 2 * K) ts <<= 1;
  return ts;
}

// Byte offsets into the block's dynamic shared memory. Host and device
// compute it alike, so the launch sizes what the kernel lays out.
struct Layout {
  size_t wred, part, done, cmd, misc, cand, incache, pred, ptags, pvalid,
      winc, weu, ww, pw, req, hit, hkey, hval, dk, tags, ts, freq, dirty,
      total;
  __host__ __device__ Layout(int N, int K, int ring, int pwidth, int pbuf,
                             int W, int ew, bool smem_state) {
    size_t o = 0;
    const int hs = hash_size(K);
    wred = take(o, 8 * kExperts * kMaxWarps);
    part = take(o, 8 * kMaxCluster);
    done = take(o, 4 * kMaxCluster);
    cmd = take(o, 4 * 4);
    misc = take(o, 4 * kMisc);
    cand = take(o, 4 * pwidth);
    incache = take(o, 4 * pwidth);
    pred = take(o, 4 * kExperts * ring);
    ptags = take(o, 4 * pbuf);
    pvalid = take(o, 4 * pbuf);
    winc = take(o, 4 * 7 * W);
    weu = take(o, 4 * kExperts * W);
    ww = take(o, 4 * kExperts * W);
    pw = take(o, 4 * (ew + 1));
    req = take(o, 4 * 2 * 3 * static_cast<size_t>(K));
    hit = take(o, 4 * static_cast<size_t>(K));
    hkey = take(o, 4 * static_cast<size_t>(hs));
    hval = take(o, 4 * static_cast<size_t>(hs));
    dk = take(o, 8 * 2 * static_cast<size_t>(K));
    const size_t n = smem_state ? static_cast<size_t>(N) : 0;
    tags = take(o, 4 * n);
    ts = take(o, 4 * n);
    freq = take(o, 4 * n);
    dirty = take(o, smem_state ? 4 * ((n + 31) / 32) : 0);
    total = o;
  }
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r) { x0 += x1; x1 = rotl32(x1, r) ^ x0; }
#define TF_ROUNDS0 TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS1 TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)

// Threefry-2x32, 20 rounds: hashes (x0, x1) under (k0, k1) in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  TF_ROUNDS0 x0 += k1; x1 += k2 + 1u;
  TF_ROUNDS1 x0 += k2; x1 += k0 + 2u;
  TF_ROUNDS0 x0 += k0; x1 += k1 + 3u;
  TF_ROUNDS1 x0 += k1; x1 += k2 + 4u;
  TF_ROUNDS0 x0 += k2; x1 += k0 + 5u;
}

// The Random expert's draw for `line` under the step's draw key, packed so
// that an unsigned min is a first-index argmax of the uniforms: the
// uniform's order is the order of its 23 mantissa bits, and the complement
// makes the largest draw the smallest key.
__device__ __forceinline__ unsigned long long draw_key(uint32_t vk0,
                                                       uint32_t vk1,
                                                       int line) {
  uint32_t x0 = 0u, x1 = static_cast<uint32_t>(line);
  threefry2x32(vk0, vk1, x0, x1);
  const uint32_t u = (x0 ^ x1) >> 9;
  return (static_cast<unsigned long long>(~u) << 32)
         | static_cast<uint32_t>(line);
}

// (value, line) packed so that an unsigned min is a first-index argmin.
__device__ __forceinline__ unsigned long long min_key(int v, int line) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(v)
                                          ^ 0x80000000u) << 32)
         | static_cast<uint32_t>(line);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ void group_bar(int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(kGroupBar), "r"(threads)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// --- the cluster: ranks, remote shared memory, fences ----------------------
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;"
               ::: "memory");
}

__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;" ::: "memory");
}

// The address of `p` (this block's shared memory) in block `rank`'s.
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_remote(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" :: "r"(addr), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_remote64(uint32_t addr,
                                            unsigned long long v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;" :: "r"(addr), "l"(v)
               : "memory");
}

// A flag: a relaxed store at cluster scope, after fence_cluster().
__device__ __forceinline__ void st_flag(uint32_t addr, int v) {
  asm volatile("st.relaxed.cluster.shared::cluster.u32 [%0], %1;"
               :: "r"(addr), "r"(v) : "memory");
}

// Read a flag in this block's shared memory (fence_cluster() after it).
__device__ __forceinline__ int ld_flag(const int* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  int v;
  asm volatile("ld.relaxed.cluster.shared::cta.u32 %0, [%1];" : "=r"(v)
               : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void st_volatile(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

struct Args {
  const int* pages;
  const int* writes;
  const int* win;
  const float* alpha;
  const float* thr;
  const int* pol;
  const float* pw;
  const int* keys;
  int* g_tags;     // [B, N] (device-scratch layout only)
  int* g_ts;
  int* g_freq;
  uint32_t* g_dirty;  // [B, ceil(N / 32)]
  int* scal_out;   // [B, 6]
  int* eu_out;     // [B, E]
  int* winc_out;   // [B, 7, W]
  int* weu_out;    // [B, W, E]
  float* ww_out;   // [B, W, E]
  float* fw_out;   // [B, E]
  int L, N, ew, ring, prefetch, pwidth, pbuf, W, K;
};

// Expert probabilities' first-index argmax, as choose_expert computes it.
__device__ __forceinline__ int choose(const float w[kExperts]) {
  const float s = __fadd_rn(__fadd_rn(w[0], w[1]), w[2]);
  float p[kExperts];
  for (int e = 0; e < kExperts; ++e)
    p[e] = s > 0.f ? __fdiv_rn(w[e], s) : 1.0f / 3.0f;
  int c = 0;
  if (p[1] > p[c]) c = 1;
  if (p[2] > p[c]) c = 2;
  return c;
}

// The block-wide work the walker calls for, run by the worker warps (every
// warp but the walker, warp 0, and the key warp, the last) between group
// barriers; the walker only releases them and waits.
struct Group {
  int* s_req;      // [2][3][K]: pages, write flags, window ids
  int* s_hit;      // [K]
  int* s_hkey;     // [hs]
  int* s_hval;     // [hs]
  int* s_misc;
  int* s_cand;
  int* s_incache;
  unsigned long long* s_wred;  // [kMaxWarps][3]: a warp's proposals
  const int* tags;
  const int* ts;
  const int* freq;
  const int* pages;
  const int* writes;
  const int* win;
  int wid, nw, warp, lane, gt, L, K, N, C, hs, hshift, pwidth;
  bool need_lru, need_lfu, need_rnd;

  // Copy requests [t, t + K) into buffer `buf` (cp.async, committed).
  __device__ __forceinline__ void stage(int t, int buf) const {
    int* dst = s_req + buf * 3 * K;
    for (int i = wid; i < 3 * K; i += nw) {
      const int which = i / K, k = i - which * K;
      const int* src = which == 0 ? pages : (which == 1 ? writes : win);
      if (t + k < L) cp_async4(&dst[which * K + k], src + t + k);
    }
    cp_async_commit();
  }

  __device__ __forceinline__ uint32_t hash(int p) const {
    return (static_cast<uint32_t>(p) * 0x9E3779B1u) >> hshift;
  }

  __device__ __forceinline__ int find(int p) const {
    for (uint32_t h = hash(p);; h = (h + 1) & static_cast<uint32_t>(hs - 1)) {
      const int k = s_hkey[h];
      if (k == p) return static_cast<int>(h);
      if (k == -1) return -1;
    }
  }

  // Look up the window [t0, t0 + kw) against the tags of the nv filled
  // lines: s_hit[k] = the line holding page k, or -1. kPassBarriers
  // group barriers.
  __device__ __forceinline__ void pass(int t0, int nv) const {
    const int kw = min(K, L - t0);
    const int buf = (t0 / K) & 1;
    cp_async_wait_all();
    group_bar(gt);  // this window's requests have landed
    if (t0 + K < L) stage(t0 + K, buf ^ 1);  // the next window's
    const int* rp = s_req + buf * 3 * K;
    for (int k = wid; k < kw; k += nw) {
      const int p = rp[k];
      for (uint32_t h = hash(p);; h = (h + 1) & static_cast<uint32_t>(hs - 1)) {
        const int prev = atomicCAS(&s_hkey[h], -1, p);
        if (prev == -1 || prev == p) break;
      }
    }
    group_bar(gt);
    for (int l = wid; l < nv; l += nw) {
      const int slot = find(tags[l]);
      if (slot >= 0) s_hval[slot] = l;  // tags are unique: one writer
    }
    group_bar(gt);
    for (int k = wid; k < kw; k += nw) s_hit[k] = s_hval[find(rp[k])];
    group_bar(gt);
    for (int i = wid; i < hs; i += nw) { s_hkey[i] = -1; s_hval[i] = -1; }
  }

  // Victim proposals into the warp's slots: first-index argmins over every
  // line (LRU, LFU) and, where the row is one block, the Random draws.
  __device__ __forceinline__ void evict() const {
    const uint32_t vk0 = static_cast<uint32_t>(s_misc[kVk0]);
    const uint32_t vk1 = static_cast<uint32_t>(s_misc[kVk1]);
    unsigned long long b_lru = kNoKey, b_lfu = kNoKey, b_rnd = kNoKey;
    if (need_lru)
      for (int l = wid; l < N; l += nw) b_lru = min(b_lru, min_key(ts[l], l));
    if (need_lfu)
      for (int l = wid; l < N; l += nw) b_lfu = min(b_lfu, min_key(freq[l], l));
    if (need_rnd && C == 1)
      for (int l = wid; l < N; l += nw)
        b_rnd = min(b_rnd, draw_key(vk0, vk1, l));
    if (need_lru) b_lru = warp_min(b_lru);
    if (need_lfu) b_lfu = warp_min(b_lfu);
    if (need_rnd && C == 1) b_rnd = warp_min(b_rnd);
    if (lane == 0) {
      s_wred[warp * kExperts + 0] = b_lru;
      s_wred[warp * kExperts + 1] = b_lfu;
      s_wred[warp * kExperts + 2] = b_rnd;
    }
    group_bar(gt);
  }

  // Which prefetch candidates a filled line holds.
  __device__ __forceinline__ void probe(int nv) const {
    for (int l = wid; l < nv; l += nw) {
      const int tg = tags[l];
      for (int k = 0; k < pwidth; ++k)
        if (tg == s_cand[k]) s_incache[k] = 1;
    }
    group_bar(gt);
  }
};

// Add a run of window counters to shared memory (lane 0), with the
// weights after the run's last step.
__device__ __forceinline__ void flush_run(int wi, const int (&run)[7],
                                          const int (&run_eu)[kExperts],
                                          const float (&w)[kExperts],
                                          int* s_winc, int* s_weu,
                                          float* s_ww, int W, bool l0) {
  if (wi >= 0 && l0) {
    for (int i = 0; i < 7; ++i) s_winc[i * W + wi] += run[i];
    for (int e = 0; e < kExperts; ++e) {
      s_weu[wi * kExperts + e] += run_eu[e];
      s_ww[wi * kExperts + e] = w[e];
    }
  }
}

// The learner's state on the walker (its registers, the same in every
// lane) and its epoch-boundary update, WeightAdjust.
struct Learner {
  float w[kExperts];
  int predn[kExperts];
  int mispred[kExperts];
  int em;
  int chosen;   // the ws policy's expert: argmax of the probabilities
  bool fixed;   // w is a fixed point of a boundary without misses

  __device__ __forceinline__ void init() {
    for (int e = 0; e < kExperts; ++e) {
      w[e] = 1.0f / 3.0f;
      predn[e] = 0;
      mispred[e] = 0;
    }
    em = 0;
    chosen = choose(w);
    fixed = false;
  }

  // WeightAdjust, spelled as the plain version rounds it. At a boundary
  // with no miss in its epoch, every loss is 0, beta^0 = 1, and the
  // update is w / ((w0 + w1) + w2): nothing changes once that sum is 1.
  __device__ __forceinline__ void boundary(const float* s_pw, int* s_pred,
                                           int ring, int ew, float alpha,
                                           float th, int lane) {
    if (em == 0 && fixed) return;
    const float thr_em = __fmul_rn(th, static_cast<float>(em));
    float wn[kExperts], d[kExperts], pe[kExperts];
    for (int e = 0; e < kExperts; ++e) {
      int loss = static_cast<float>(mispred[e]) >= thr_em ? mispred[e] : 0;
      loss = min(max(loss, 0), ew);
      pe[e] = s_pw[loss];
      d[e] = __fmaf_rn(-w[e], pe[e], w[e]);
    }
    // alpha * mean(lost) as the reference's compiler orders it:
    // (alpha * 1/3) * (d0 + d1 + d2).
    const float lost = __fadd_rn(__fadd_rn(d[0], d[1]), d[2]);
    const float gain = __fmul_rn(__fmul_rn(alpha, 1.0f / 3.0f), lost);
    for (int e = 0; e < kExperts; ++e)
      wn[e] = fmaxf(__fmaf_rn(w[e], pe[e], gain), 1e-8f);
    const float s = __fadd_rn(__fadd_rn(wn[0], wn[1]), wn[2]);
    for (int e = 0; e < kExperts; ++e) {
      w[e] = __fdiv_rn(wn[e], s);
      predn[e] = 0;
      mispred[e] = 0;
    }
    for (int i = lane; i < kExperts * ring; i += 32) s_pred[i] = -1;
    em = 0;
    chosen = choose(w);
    fixed = __fadd_rn(__fadd_rn(w[0], w[1]), w[2]) == 1.0f
            && fminf(fminf(w[0], w[1]), w[2]) >= 1e-8f;
    __syncwarp();
  }
};

template <bool kSmemState>
__global__ void __launch_bounds__(512, 1) cache_scan_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(a.N, a.K, a.ring, a.pwidth, a.pbuf, a.W, a.ew,
                   kSmemState);
  unsigned long long* s_part =
      reinterpret_cast<unsigned long long*>(smem + lay.part);
  unsigned long long* s_wred =
      reinterpret_cast<unsigned long long*>(smem + lay.wred);
  int* s_done = reinterpret_cast<int*>(smem + lay.done);
  int* s_cmd = reinterpret_cast<int*>(smem + lay.cmd);
  int* s_misc = reinterpret_cast<int*>(smem + lay.misc);
  int* s_cand = reinterpret_cast<int*>(smem + lay.cand);
  int* s_incache = reinterpret_cast<int*>(smem + lay.incache);
  int* s_pred = reinterpret_cast<int*>(smem + lay.pred);
  int* s_ptags = reinterpret_cast<int*>(smem + lay.ptags);
  int* s_pvalid = reinterpret_cast<int*>(smem + lay.pvalid);
  int* s_winc = reinterpret_cast<int*>(smem + lay.winc);
  int* s_weu = reinterpret_cast<int*>(smem + lay.weu);
  float* s_ww = reinterpret_cast<float*>(smem + lay.ww);
  float* s_pw = reinterpret_cast<float*>(smem + lay.pw);
  int* s_req = reinterpret_cast<int*>(smem + lay.req);   // [2][3][K]
  int* s_hit = reinterpret_cast<int*>(smem + lay.hit);   // [K]
  int* s_hkey = reinterpret_cast<int*>(smem + lay.hkey);
  int* s_hval = reinterpret_cast<int*>(smem + lay.hval);
  uint32_t* s_dk = reinterpret_cast<uint32_t*>(smem + lay.dk);  // [2K][2]

  const int C = cluster_size();
  const int rank = cluster_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int L = a.L, N = a.N, K = a.K, W = a.W;
  const int policy = a.pol[row];
  const bool ws = policy < 0;
  const int fixed = ws ? -1 : min(policy, kExperts - 1);
  const bool need_lru = ws || fixed == 0;
  const bool need_lfu = ws || fixed == 1;
  const bool need_rnd = ws || fixed == 2;
  const int hs = hash_size(K);
  int hshift = 32;
  for (int v = hs; v > 1; v >>= 1) --hshift;

  // Flags a remote block may write: set before the cluster's first barrier.
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) s_cmd[i] = 0;
    for (int r = 0; r < kMaxCluster; ++r) {
      s_done[r] = 0;
      s_part[r] = kNoKey;
    }
  }
  __syncthreads();
  if (C > 1) cluster_sync();

  if (rank > 0) {
    // --- a helper block: the Random draws of its share of the lines -------
    const int lo = static_cast<int>(static_cast<long long>(rank - 1) * N
                                    / (C - 1));
    const int hi = static_cast<int>(static_cast<long long>(rank) * N
                                    / (C - 1));
    int last = 0;
    for (;;) {
      if (tid == 0) {
        while (ld_flag(&s_cmd[0]) == last) {}
        fence_cluster();
      }
      __syncthreads();
      last = s_cmd[0];
      const uint32_t vk0 = static_cast<uint32_t>(s_cmd[1]);
      const uint32_t vk1 = static_cast<uint32_t>(s_cmd[2]);
      if (s_cmd[3] == kCmdEnd) break;
      unsigned long long b = kNoKey;
      for (int l = lo + tid; l < hi; l += nt) b = min(b, draw_key(vk0, vk1, l));
      b = warp_min(b);
      if (lane == 0) s_wred[warp] = b;
      __syncthreads();
      if (warp == 0) {
        b = warp_min(lane < nt / 32 ? s_wred[lane] : kNoKey);
        if (lane == 0) {
          st_remote64(remote(&s_part[rank], 0), b);
          fence_cluster();
          st_flag(remote(&s_done[rank], 0), last);
        }
      }
    }
    cluster_sync();
    return;
  }

  // --- the row's block -----------------------------------------------------
  const size_t rl = static_cast<size_t>(row) * L;
  const int nw = (N + 31) / 32;
  int* tags;
  int* ts;
  int* freq;
  uint32_t* dirty;
  if (kSmemState) {
    tags = reinterpret_cast<int*>(smem + lay.tags);
    ts = reinterpret_cast<int*>(smem + lay.ts);
    freq = reinterpret_cast<int*>(smem + lay.freq);
    dirty = reinterpret_cast<uint32_t*>(smem + lay.dirty);
  } else {
    const size_t rn = static_cast<size_t>(row) * N;
    tags = a.g_tags + rn;
    ts = a.g_ts + rn;
    freq = a.g_freq + rn;
    dirty = a.g_dirty + static_cast<size_t>(row) * nw;
  }
  const int key_warp = nt / 32 - 1;
  const int gt = nt - 32;  // the group: every warp but the key warp
  const Group g{s_req, s_hit, s_hkey, s_hval, s_misc, s_cand, s_incache,
                s_wred, tags, ts, freq, a.pages + rl, a.writes + rl,
                a.win + rl, tid - 32, gt - 32, warp, lane, gt, L, K, N, C,
                hs, hshift, a.pwidth, need_lru, need_lfu, need_rnd};

  // Cold start.
  for (int l = tid; l < N; l += nt) { tags[l] = -1; ts[l] = 0; freq[l] = 0; }
  for (int i = tid; i < nw; i += nt) dirty[i] = 0u;
  for (int i = tid; i < kExperts * a.ring; i += nt) s_pred[i] = -1;
  for (int i = tid; i < a.pbuf; i += nt) { s_ptags[i] = -1; s_pvalid[i] = 0; }
  for (int i = tid; i < 7 * W; i += nt) s_winc[i] = 0;
  for (int i = tid; i < kExperts * W; i += nt) { s_weu[i] = 0; s_ww[i] = 0.f; }
  for (int i = tid; i <= a.ew; i += nt) s_pw[i] = a.pw[row * (a.ew + 1) + i];
  for (int i = tid; i < hs; i += nt) { s_hkey[i] = -1; s_hval[i] = -1; }
  if (tid == 0) {
    for (int i = 0; i < kMisc; ++i) s_misc[i] = 0;
  }
  if (warp != 0 && warp != key_warp) g.stage(0, 0);  // the first window
  __syncthreads();

  if (warp == key_warp) {
    // --- the key chain: the draw key of every step, ahead of the walker ---
    if (need_rnd) {
      uint32_t k0 = static_cast<uint32_t>(a.keys[2 * row]);
      uint32_t k1 = static_cast<uint32_t>(a.keys[2 * row + 1]);
      const int kr = 2 * K;
      for (int t = 0; t < L; ++t) {
        while (t >= ld_volatile(&s_misc[kWalkT0]) + kr) __nanosleep(64);
        uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
        threefry2x32(k0, k1, a0, a1);
        threefry2x32(k0, k1, b0, b1);
        k0 = a0;
        k1 = a1;
        if (lane == 0) {
          s_dk[2 * (t % kr)] = b0;
          s_dk[2 * (t % kr) + 1] = b1;
          __threadfence_block();
          st_volatile(&s_misc[kKeyDone], t + 1);
        }
      }
    }
  } else if (warp != 0) {
    // --- a worker warp: the block-wide work the walker calls for ---------
    for (;;) {
      group_bar(gt);
      const int cmd = s_misc[kCmd];
      if (cmd == kCmdEnd) break;
      if (cmd == kCmdPass) g.pass(s_misc[kT0], s_misc[kNv]);
      else if (cmd == kCmdEvict) g.evict();
      else g.probe(s_misc[kNv]);
    }
  } else {
    // --- the walker ------------------------------------------------------
    const float alpha = a.alpha[row];
    const float th = a.thr[row];
    const int ring = a.ring, pbuf = a.pbuf, pwidth = a.pwidth;
    const int workers = nt / 32 - 2;
    const bool l0 = lane == 0;
    Learner ol;
    ol.init();
    int nvalid = 0, seq = 0;
    int epoch_left = a.ew;  // steps to the next epoch boundary, inclusive
    int last_miss = -1, stride = 0, conf = 0, issued = 0;
    int tot[6] = {0, 0, 0, 0, 0, 0};
    int eu[kExperts] = {0, 0, 0};
    // Window counters accumulate over a run of steps in one window and are
    // added to shared memory when the window id changes.
    int run_wi = -1;
    int run[7] = {0, 0, 0, 0, 0, 0, 0};
    int run_eu[kExperts] = {0, 0, 0};
    for (int t0 = 0; t0 < L; t0 += K) {
      const int kw = min(K, L - t0);
      const int* rp = s_req + ((t0 / K) & 1) * 3 * K;
      if (l0) {
        st_volatile(&s_misc[kWalkT0], t0);
        s_misc[kCmd] = kCmdPass;
        s_misc[kT0] = t0;
        s_misc[kNv] = nvalid;
      }
      group_bar(gt);
      for (int i = 0; i < kPassBarriers; ++i) group_bar(gt);

      for (int k = 0; k < kw;) {
        // --- the hits from step k on, up to 32 at once -----------------
        // Lane i looks at step k + i. Until the next miss no line changes
        // hands, so each hit's line is the looked-up one, and the hits'
        // updates commute: freq adds, ts takes the latest step, dirty ors.
        {
          const int j = k + lane;
          int pj = 0, hj = -1, wrj = 0, wij = 0;
          if (j < kw) {
            pj = rp[j];
            wrj = rp[K + j];
            wij = rp[2 * K + j];
            hj = s_hit[j];
          }
          const bool hitj = j < kw && hj >= 0 && tags[hj] == pj;
          const int wi0 = __shfl_sync(kFull, wij, 0);
          const unsigned stop = __ballot_sync(kFull, !(hitj && wij == wi0));
          const int n = stop ? __ffs(stop) - 1 : 32;
          if (n > 0) {
            if (lane < n) {
              atomicAdd(&freq[hj], 1);
              atomicMax(&ts[hj], t0 + j);
              if (wrj) atomicOr(&dirty[hj >> 5], 1u << (hj & 31));
            }
            tot[0] += n;
            if (wi0 != run_wi) {
              flush_run(run_wi, run, run_eu, ol.w, s_winc, s_weu, s_ww, W,
                        l0);
              run_wi = -1;
              for (int i = 0; i < 7; ++i) run[i] = 0;
              for (int e = 0; e < kExperts; ++e) run_eu[e] = 0;
            }
            if (wi0 >= 0 && wi0 < W) {
              run_wi = wi0;
              run[0] += n;
              run[1] += n;
            }
            int m = n;
            while (m >= epoch_left) {
              m -= epoch_left;
              epoch_left = a.ew;
              if (ws) ol.boundary(s_pw, s_pred, ring, a.ew, alpha, th, lane);
            }
            epoch_left -= m;
            k += n;
            __syncwarp();
            continue;
          }
        }

        // --- step k misses: the serial step ----------------------------
        const int t = t0 + k;
        const int page = rp[k];
        const bool is_w = rp[K + k] != 0;
        const int wi = rp[2 * K + k];
        const bool evict = nvalid == N;
        bool promoted = false, wb = false;
        int pf_fetches = 0;
        const int chosen = ws ? ol.chosen : fixed;

        if (wi != run_wi) {
          flush_run(run_wi, run, run_eu, ol.w, s_winc, s_weu, s_ww, W, l0);
          run_wi = -1;
          for (int i = 0; i < 7; ++i) run[i] = 0;
          for (int e = 0; e < kExperts; ++e) run_eu[e] = 0;
        }
        // Mispredictions: the page in an expert's ring of victims.
        if (kExperts * ring <= 32) {
          const unsigned bits = __ballot_sync(
              kFull, lane < kExperts * ring && s_pred[lane] == page);
          for (int e = 0; e < kExperts; ++e)
            ol.mispred[e] += (bits >> (e * ring)) & ((1u << ring) - 1u) ? 1 : 0;
        } else {
          for (int e = 0; e < kExperts; ++e) {
            bool hp = false;
#pragma unroll 1
            for (int c = lane; c < ring; c += 32) hp |= s_pred[e * ring + c] == page;
            ol.mispred[e] += __any_sync(kFull, hp) ? 1 : 0;
          }
        }
        ol.em += 1;
        if (a.prefetch) {
          bool any = false;
#pragma unroll 1
          for (int b = lane; b < pbuf; b += 32)
            if (s_pvalid[b] && s_ptags[b] == page) {
              any = true;
              s_pvalid[b] = 0;
            }
          promoted = __any_sync(kFull, any);
        }
        int slot;
        if (!evict) {
          slot = nvalid;
          nvalid += 1;
        } else {
          if (need_rnd) {
            while (ld_volatile(&s_misc[kKeyDone]) <= t) {}
            __threadfence_block();
          }
          const int di = 2 * (t % (2 * K));
          const uint32_t vk0 = s_dk[di], vk1 = s_dk[di + 1];
          if (C > 1 && need_rnd) {
            seq += 1;
            if (lane >= 1 && lane < C) {
              const uint32_t rc = remote(s_cmd, lane);
              st_remote(rc + 4, vk0);
              st_remote(rc + 8, vk1);
              st_remote(rc + 12, kCmdEvict);
              fence_cluster();
              st_flag(rc, seq);
            }
          }
          if (l0) {
            s_misc[kCmd] = kCmdEvict;
            s_misc[kVk0] = static_cast<int>(vk0);
            s_misc[kVk1] = static_cast<int>(vk1);
          }
          group_bar(gt);
          group_bar(gt);  // the workers' proposals are in s_wred
          unsigned long long kk[kExperts];
          for (int e = 0; e < kExperts; ++e)
            kk[e] = warp_min(lane >= 1 && lane <= workers
                                 ? s_wred[lane * kExperts + e] : kNoKey);
          if (C > 1 && need_rnd) {
            unsigned long long part = kNoKey;
            if (lane >= 1 && lane < C) {
              while (ld_flag(&s_done[lane]) != seq) {}
              fence_cluster();
              part = s_part[lane];
            }
            kk[2] = min(kk[2], warp_min(part));
          }
          int prop[kExperts];
          for (int e = 0; e < kExperts; ++e)
            prop[e] = static_cast<int>(kk[e] & 0xffffffffull);
          slot = chosen == 0 ? prop[0] : (chosen == 1 ? prop[1] : prop[2]);
          wb = (dirty[slot >> 5] >> (slot & 31)) & 1u;
          // Every computed proposal enters its ring; a fixed policy
          // computes only its own (the rings are not observable there).
          int vp[kExperts];
          for (int e = 0; e < kExperts; ++e)
            vp[e] = kk[e] != kNoKey ? tags[prop[e]] : -1;
          __syncwarp();
          if (l0)
            for (int e = 0; e < kExperts; ++e)
              s_pred[e * ring + ol.predn[e] % ring] = vp[e];
          for (int e = 0; e < kExperts; ++e) ol.predn[e] += 1;
        }
        __syncwarp();
        if (l0) {
          tags[slot] = page;
          const uint32_t bit = 1u << (slot & 31);
          dirty[slot >> 5] = is_w ? (dirty[slot >> 5] | bit)
                                  : (dirty[slot >> 5] & ~bit);
          freq[slot] = 1;
          ts[slot] = t;
        }
        // Later requests of this page in the window are at this slot.
#pragma unroll 1
        for (int j = k + 1 + lane; j < kw; j += 32)
          if (rp[j] == page) s_hit[j] = slot;
        __syncwarp();

        if (a.prefetch) {
          const int delta = static_cast<int>(static_cast<uint32_t>(page)
                                             - static_cast<uint32_t>(last_miss));
          const bool same = delta == stride && last_miss >= 0 && delta != 0;
          const int conf_o = same ? conf + 1 : (delta != 0 ? 1 : conf);
          const int stride_o = same ? stride : (delta != 0 ? delta : stride);
          last_miss = page;
          stride = stride_o;
          conf = conf_o;
          if (conf >= 2) {
            for (int c = lane; c < pwidth; c += 32) {
              s_cand[c] = static_cast<int>(static_cast<uint32_t>(page)
                  + static_cast<uint32_t>(c + 1) * static_cast<uint32_t>(stride));
              s_incache[c] = 0;
            }
            if (l0) {
              s_misc[kCmd] = kCmdProbe;
              s_misc[kNv] = nvalid;
            }
            group_bar(gt);
            group_bar(gt);  // the workers' scan of the filled lines
            const int n_before = issued;
            if (l0) {
              for (int c = 0; c < pwidth; ++c) {
                const int cand = s_cand[c];
                bool in_buf = false;
                int free_b = -1;
                for (int b = 0; b < pbuf; ++b) {
                  if (s_pvalid[b] && s_ptags[b] == cand) in_buf = true;
                  if (!s_pvalid[b] && free_b < 0) free_b = b;
                }
                if (free_b >= 0 && !s_incache[c] && !in_buf && cand >= 0) {
                  s_ptags[free_b] = cand;
                  s_pvalid[free_b] = 1;
                  issued += 1;
                }
              }
            }
            issued = __shfl_sync(kFull, issued, 0);
            pf_fetches = issued - n_before;
            __syncwarp();
          }
        }

        epoch_left -= 1;
        if (epoch_left == 0) {
          epoch_left = a.ew;
          if (ws) ol.boundary(s_pw, s_pred, ring, a.ew, alpha, th, lane);
        }

        const int t2r = (promoted ? 0 : 1) + pf_fetches;
        const int t2w = wb ? 1 : 0;
        const int ev = evict ? 1 : 0;
        tot[1] += 1; tot[2] += promoted ? 1 : 0;
        tot[3] += t2r; tot[4] += t2w; tot[5] += ev;
        for (int e = 0; e < kExperts; ++e) eu[e] += evict && chosen == e;
        if (wi >= 0 && wi < W) {
          run_wi = wi;
          run[0] += 1; run[2] += 1; run[3] += promoted ? 1 : 0;
          run[4] += t2r; run[5] += t2w; run[6] += ev;
          for (int e = 0; e < kExperts; ++e) run_eu[e] += evict && chosen == e;
        }
        k += 1;
      }
    }
    flush_run(run_wi, run, run_eu, ol.w, s_winc, s_weu, s_ww, W, l0);
    if (l0) s_misc[kCmd] = kCmdEnd;
    group_bar(gt);
    if (C > 1 && lane >= 1 && lane < C) {
      const uint32_t rc = remote(s_cmd, lane);
      st_remote(rc + 12, kCmdEnd);
      fence_cluster();
      st_flag(rc, seq + 1);
    }
    if (l0) {
      for (int i = 0; i < 6; ++i) a.scal_out[row * 6 + i] = tot[i];
      for (int e = 0; e < kExperts; ++e) {
        a.eu_out[row * kExperts + e] = eu[e];
        a.fw_out[row * kExperts + e] = ol.w[e];
      }
    }
  }

  // --- outputs -------------------------------------------------------------
  __syncthreads();
  for (int i = tid; i < 7 * W; i += nt) a.winc_out[row * 7 * W + i] = s_winc[i];
  for (int i = tid; i < kExperts * W; i += nt) {
    a.weu_out[row * kExperts * W + i] = s_weu[i];
    a.ww_out[row * kExperts * W + i] = s_ww[i];
  }
  if (C > 1) cluster_sync();
}

template <bool kSmemState>
cudaError_t prepare(size_t smem) {
  auto kern = cache_scan_kernel<kSmemState>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <bool kSmemState>
cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int B, int threads,
                          size_t smem, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A failed query returns its error code, negated.
template <bool kSmemState>
int pick_cluster(int B, int N, int threads, size_t smem) {
  if (N < 4096) return 1;  // the draws of a small cache outrun a handshake
  cudaError_t e = prepare<kSmemState>(smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int c = kMaxCluster; c > 1 && e == cudaSuccess; c >>= 1) {
    if (B * c > sms) continue;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config<kSmemState>(attr, B, threads, smem, c,
                                                nullptr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, cache_scan_kernel<kSmemState>,
                                       &cfg);
    if (e == cudaSuccess && n >= B) return c;
  }
  return e == cudaSuccess ? 1 : -static_cast<int>(e);
}

template <bool kSmemState>
int launch(const Args& a, int B, int threads, int cluster,
           cudaStream_t stream) {
  const Layout lay(a.N, a.K, a.ring, a.pwidth, a.pbuf, a.W, a.ew, kSmemState);
  cudaError_t e = prepare<kSmemState>(lay.total);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<kSmemState>(attr, B, threads, lay.total,
                                              cluster, stream);
  e = cudaLaunchKernelEx(&cfg, cache_scan_kernel<kSmemState>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, bytes; `smem_state` selects the
// layout with the per-line state in shared memory.
size_t cache_scan_smem_bytes(int N, int K, int ring, int pwidth, int pbuf,
                             int W, int ew, int smem_state) {
  return Layout(N, K, ring, pwidth, pbuf, W, ew, smem_state != 0).total;
}

// The cluster size a launch of B rows takes: 8, 4 or 2 blocks a row where
// every row's cluster fits on the card at once and the cache is large
// enough for the Random draws to outweigh the handshake, else 1; minus the
// error code where a query of the card fails.
int cache_scan_pick_cluster(int B, int N, int K, int ring, int pwidth,
                            int pbuf, int W, int ew, int smem_state,
                            int threads) {
  const size_t smem = Layout(N, K, ring, pwidth, pbuf, W, ew,
                             smem_state != 0).total;
  return smem_state ? pick_cluster<true>(B, N, threads, smem)
                    : pick_cluster<false>(B, N, threads, smem);
}

const char* cache_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches B rows (clusters of `cluster` blocks each) on `stream`;
// `scratch` holds the device-scratch layout's state (3 B N + B ceil(N /
// 32) ints; unused with `smem_state`). Returns the launch's error code.
int cache_scan_launch(
    const int* pages, const int* writes, const int* win, const float* alpha,
    const float* thr, const int* pol, const float* pw, const int* keys,
    int* scratch, int* scal, int* eu, int* winc, int* weu, float* ww,
    float* fw, int B, int L, int N, int ew, int ring, int prefetch,
    int pwidth, int pbuf, int W, int K, int smem_state, int cluster,
    int threads, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || threads < 96 || threads > 512
      || threads % 32 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bn = static_cast<size_t>(B) * N;
  Args a{pages, writes, win, alpha, thr, pol, pw, keys,
         scratch, scratch + bn, scratch + 2 * bn,
         reinterpret_cast<uint32_t*>(scratch + 3 * bn),
         scal, eu, winc, weu, ww, fw,
         L, N, ew, ring, prefetch, pwidth, pbuf, W, K};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return smem_state ? launch<true>(a, B, threads, cluster, st)
                    : launch<false>(a, B, threads, cluster, st);
}

}  // extern "C"
