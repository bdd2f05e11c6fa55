// Tier-1 cache scan for Hopper (sm_90a): the whole request loop of one
// shard row per thread block, from the cold init_store state.
//
// Replaces the Pallas TPU kernel repro/kernels/cache_scan.py:
// cache_scan_kernel (body _cache_scan_body) and computes exactly what the
// plain PyTorch version repro_torch/kernels/ref.py:cache_scan_ref computes:
// every counter equal, the f32 expert weights equal bit for bit.
//
// What bounds it: the request loop is serial. Each step depends on the
// previous step's cache state, so one row is one long chain of steps and
// the card's parallelism is only across rows (blocks) and across the
// n_lines of one step (threads). Per step the block scans the filled tags
// (lookup); on an eviction it scans ts and freq (LRU / LFU argmin) and
// draws one threefry uniform per line (Random-expert argmax); the scalar
// learner, prefetcher and counter folds run on thread 0. The per-line state
// (tags / dirty / freq / ts, 16 B a line) lives in device scratch, which at
// 16 rows x 16,384 lines is 4 MiB and stays in L2. The learner state, the
// prediction rings, the prefetch buffer and the window accumulators live in
// shared memory; the per-row key chain runs on a second warp so it stays
// off thread 0's critical path. A step costs a few block barriers plus, on
// an eviction, ~75 integer instructions a line for the draws: that integer
// work on the row's one SM is what bounds an eviction-heavy row.
//
// Float arithmetic: the weight update is spelled with explicit roundings
// (__fadd_rn / __fmul_rn / __fdiv_rn, and __fmaf_rn exactly where the
// reference's compiler contracts a product into a fused multiply-add) in
// the order of the plain version, and beta**loss comes from the same pow
// table, so the weights -- whose argmax picks evictions -- agree bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kExperts = 3;
constexpr int kBig = 0x7fffffff;
constexpr unsigned long long kNoKey = ~0ull;
// Block-shared scalars. Slots read by every thread after one barrier and
// reset by thread 0 before the next are double-buffered by step parity, so
// a reset never races a late reader.
constexpr int kHit = 0;     // [2] hit line (kBig = miss)
constexpr int kFill = 2;    // fill count: lines [0, fill) are valid
constexpr int kPfGo = 3;    // this step issues prefetches
constexpr int kDraw = 4;    // [2][2] Random-expert draw key
constexpr int kMisc = 8;

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

// split(key) -> (next key, draw key), as jax.random.split.
__device__ __forceinline__ void split(uint32_t& k0, uint32_t& k1,
                                      uint32_t& v0, uint32_t& v1) {
  uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
  threefry2x32(k0, k1, a0, a1);
  threefry2x32(k0, k1, b0, b1);
  k0 = a0; k1 = a1; v0 = b0; v1 = b1;
}

// (value, line) packed so that an unsigned min is a first-index argmin.
__device__ __forceinline__ unsigned long long min_key(int v, int line) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(v)
                                          ^ 0x80000000u) << 32)
         | static_cast<uint32_t>(line);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(1024) cache_scan_kernel(
    const int* __restrict__ pages, const int* __restrict__ writes,
    const int* __restrict__ win, const float* __restrict__ alpha,
    const float* __restrict__ thr, const int* __restrict__ pol,
    const float* __restrict__ pw, const int* __restrict__ keys,
    int* tags_all, int* dirty_all, int* freq_all, int* ts_all,
    int* __restrict__ scal_out, int* __restrict__ eu_out,
    int* __restrict__ winc_out, int* __restrict__ weu_out,
    float* __restrict__ ww_out, float* __restrict__ fw_out,
    int L, int N, int ew, int ring, int prefetch, int pwidth, int pbuf,
    int W) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_keys = smem;                 // lru, lfu, rnd
  int* s_misc = reinterpret_cast<int*>(smem + kExperts);
  int* s_cand = s_misc + kMisc;                      // [pwidth]
  int* s_incache = s_cand + pwidth;                  // [pwidth]
  int* s_pred = s_incache + pwidth;                  // [E, ring]
  int* s_ptags = s_pred + kExperts * ring;           // [pbuf]
  int* s_pvalid = s_ptags + pbuf;                    // [pbuf]
  int* s_winc = s_pvalid + pbuf;                     // [7, W]
  int* s_weu = s_winc + 7 * W;                       // [W, E]
  float* s_pw = reinterpret_cast<float*>(s_weu + kExperts * W);  // [ew+1]
  float* s_ww = s_pw + ew + 1;                       // [W, E]

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t rl = static_cast<size_t>(row) * L;
  const size_t rn = static_cast<size_t>(row) * N;
  const int* pg = pages + rl;
  int* tags = tags_all + rn;
  int* dirty = dirty_all + rn;
  int* freq = freq_all + rn;
  int* ts = ts_all + rn;
  const float a = alpha[row];
  const float th = thr[row];
  const int policy = pol[row];
  const bool ws = policy < 0;
  const int fixed = ws ? -1 : min(policy, kExperts - 1);
  const bool need_lru = ws || fixed == 0;
  const bool need_lfu = ws || fixed == 1;
  const bool need_rnd = ws || fixed == 2;
  const int key_thread = nt > 32 ? 32 : 0;

  // --- cold start ----------------------------------------------------------
  for (int l = tid; l < N; l += nt) {
    tags[l] = -1; dirty[l] = 0; freq[l] = 0; ts[l] = 0;
  }
  for (int i = tid; i < kExperts * ring; i += nt) s_pred[i] = -1;
  for (int i = tid; i < pbuf; i += nt) { s_ptags[i] = -1; s_pvalid[i] = 0; }
  for (int i = tid; i < 7 * W; i += nt) s_winc[i] = 0;
  for (int i = tid; i < kExperts * W; i += nt) { s_weu[i] = 0; s_ww[i] = 0.f; }
  for (int i = tid; i <= ew; i += nt) s_pw[i] = pw[row * (ew + 1) + i];
  uint32_t kk0 = 0u, kk1 = 0u;
  if (tid == key_thread) {
    kk0 = static_cast<uint32_t>(keys[2 * row]);
    kk1 = static_cast<uint32_t>(keys[2 * row + 1]);
    uint32_t v0, v1;
    split(kk0, kk1, v0, v1);
    s_misc[kDraw] = static_cast<int>(v0);
    s_misc[kDraw + 1] = static_cast<int>(v1);
  }
  if (tid == 0) {
    s_misc[kHit] = kBig;
    s_misc[kHit + 1] = kBig;
    s_misc[kFill] = 0;
    s_misc[kPfGo] = 0;
    for (int e = 0; e < kExperts; ++e) s_keys[e] = kNoKey;
  }
  __syncthreads();

  // Learner, prefetcher and totals: thread 0's registers.
  float w[kExperts] = {1.0f / 3.0f, 1.0f / 3.0f, 1.0f / 3.0f};
  int predn[kExperts] = {0, 0, 0};
  int mispred[kExperts] = {0, 0, 0};
  int em = 0, nvalid = 0;
  int last_miss = -1, stride = 0, conf = 0, issued = 0;
  int tot[6] = {0, 0, 0, 0, 0, 0};
  int eu[kExperts] = {0, 0, 0};

  for (int t = 0; t < L; ++t) {
    const int page = pg[t];
    const int par = t & 1;
    const int nv = s_misc[kFill];

    // --- lookup: only the filled prefix can hold a page --------------------
    for (int l = tid; l < nv; l += nt)
      if (tags[l] == page) atomicMin(&s_misc[kHit + par], l);
    if (tid == key_thread && t + 1 < L) {
      uint32_t v0, v1;
      split(kk0, kk1, v0, v1);
      const int nb = kDraw + 2 * (par ^ 1);
      s_misc[nb] = static_cast<int>(v0);
      s_misc[nb + 1] = static_cast<int>(v1);
    }
    __syncthreads();
    const int hit_idx = s_misc[kHit + par];
    const bool miss = hit_idx == kBig;
    const bool evict = miss && nv == N;

    // --- victim proposals: first-index argmin / argmax over the lines ------
    if (evict) {
      const int cb = kDraw + 2 * par;
      const uint32_t vk0 = static_cast<uint32_t>(s_misc[cb]);
      const uint32_t vk1 = static_cast<uint32_t>(s_misc[cb + 1]);
      unsigned long long b_lru = kNoKey, b_lfu = kNoKey, b_rnd = kNoKey;
      for (int l = tid; l < N; l += nt) {
        if (need_lru) b_lru = min(b_lru, min_key(ts[l], l));
        if (need_lfu) b_lfu = min(b_lfu, min_key(freq[l], l));
        if (need_rnd) {
          uint32_t x0 = 0u, x1 = static_cast<uint32_t>(l);
          threefry2x32(vk0, vk1, x0, x1);
          // The uniform's order is the order of its 23 mantissa bits; the
          // complement makes the largest draw the smallest key.
          const uint32_t u = (x0 ^ x1) >> 9;
          b_rnd = min(b_rnd, (static_cast<unsigned long long>(~u) << 32)
                             | static_cast<uint32_t>(l));
        }
      }
      b_lru = warp_min(b_lru);
      b_lfu = warp_min(b_lfu);
      b_rnd = warp_min(b_rnd);
      if ((tid & 31) == 0) {
        atomicMin(&s_keys[0], b_lru);
        atomicMin(&s_keys[1], b_lfu);
        atomicMin(&s_keys[2], b_rnd);
      }
      __syncthreads();
    }

    // --- scalar step on thread 0 ------------------------------------------
    bool promoted = false, wb = false;
    int chosen = 0, pf_fetches = 0;
    if (tid == 0) {
      const bool is_w = writes[rl + t] != 0;
      if (miss) {
        for (int e = 0; e < kExperts; ++e) {
          int hp = 0;
          for (int c = 0; c < ring; ++c) hp |= s_pred[e * ring + c] == page;
          mispred[e] += hp;
        }
        em += 1;
        if (prefetch) {
          for (int b = 0; b < pbuf; ++b)
            if (s_pvalid[b] && s_ptags[b] == page) {
              promoted = true;
              s_pvalid[b] = 0;
            }
        }
      }
      if (ws) {
        const float s = __fadd_rn(__fadd_rn(w[0], w[1]), w[2]);
        float p[kExperts];
        for (int e = 0; e < kExperts; ++e)
          p[e] = s > 0.f ? __fdiv_rn(w[e], s) : 1.0f / 3.0f;
        if (p[1] > p[chosen]) chosen = 1;
        if (p[2] > p[chosen]) chosen = 2;
      } else {
        chosen = fixed;
      }
      if (miss) {
        int slot;
        if (nvalid < N) {
          slot = nvalid;
          nvalid += 1;
          s_misc[kFill] = nvalid;
        } else {
          int prop[kExperts];
          for (int e = 0; e < kExperts; ++e)
            prop[e] = static_cast<int>(s_keys[e] & 0xffffffffull);
          slot = prop[chosen];
          wb = dirty[slot] != 0;
          // Every computed proposal enters its ring; a fixed policy
          // computes only its own (the rings are not observable there).
          for (int e = 0; e < kExperts; ++e) {
            const bool known = s_keys[e] != kNoKey;
            s_pred[e * ring + predn[e] % ring] = known ? tags[prop[e]] : -1;
            predn[e] += 1;
          }
        }
        tags[slot] = page;
        dirty[slot] = is_w;
        freq[slot] = 1;
        ts[slot] = t;
      } else {
        dirty[hit_idx] |= is_w;
        freq[hit_idx] += 1;
        ts[hit_idx] = t;
      }
      bool active = false;
      if (prefetch && miss) {
        const int delta = page - last_miss;
        const bool same = delta == stride && last_miss >= 0 && delta != 0;
        const int conf_o = same ? conf + 1 : (delta != 0 ? 1 : conf);
        const int stride_o = same ? stride : (delta != 0 ? delta : stride);
        last_miss = page;
        stride = stride_o;
        conf = conf_o;
        active = conf >= 2;
        for (int k = 0; k < pwidth; ++k) {
          s_cand[k] = static_cast<int>(static_cast<uint32_t>(page)
              + static_cast<uint32_t>(k + 1) * static_cast<uint32_t>(stride));
          s_incache[k] = 0;
        }
      }
      s_misc[kPfGo] = active;
    }

    // --- prefetch issue: one more block scan for the candidates ------------
    if (prefetch) {
      __syncthreads();
      if (s_misc[kPfGo]) {
        const int nv2 = s_misc[kFill];
        for (int l = tid; l < nv2; l += nt) {
          const int tg = tags[l];
          for (int k = 0; k < pwidth; ++k)
            if (tg == s_cand[k]) s_incache[k] = 1;
        }
        __syncthreads();
        if (tid == 0) {
          const int n_before = issued;
          for (int k = 0; k < pwidth; ++k) {
            const int cand = s_cand[k];
            bool in_buf = false;
            int free_b = -1;
            for (int b = 0; b < pbuf; ++b) {
              if (s_pvalid[b] && s_ptags[b] == cand) in_buf = true;
              if (!s_pvalid[b] && free_b < 0) free_b = b;
            }
            if (free_b >= 0 && !s_incache[k] && !in_buf && cand >= 0) {
              s_ptags[free_b] = cand;
              s_pvalid[free_b] = 1;
              issued += 1;
            }
          }
          pf_fetches = issued - n_before;
        }
      }
    }

    // --- epoch boundary (WeightAdjust, ws only) and counter folds ----------
    if (tid == 0) {
      if (ws && (t + 1) % ew == 0) {
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
        const float gain = __fmul_rn(__fmul_rn(a, 1.0f / 3.0f), lost);
        for (int e = 0; e < kExperts; ++e)
          wn[e] = fmaxf(__fmaf_rn(w[e], pe[e], gain), 1e-8f);
        const float s = __fadd_rn(__fadd_rn(wn[0], wn[1]), wn[2]);
        for (int e = 0; e < kExperts; ++e) {
          w[e] = __fdiv_rn(wn[e], s);
          predn[e] = 0;
          mispred[e] = 0;
        }
        for (int i = 0; i < kExperts * ring; ++i) s_pred[i] = -1;
        em = 0;
      }
      const int hit_c = miss ? 0 : 1;
      const int miss_c = miss ? 1 : 0;
      const int pfh = promoted ? 1 : 0;
      const int t2r = (miss && !promoted ? 1 : 0) + pf_fetches;
      const int t2w = wb ? 1 : 0;
      const int ev = evict ? 1 : 0;
      tot[0] += hit_c; tot[1] += miss_c; tot[2] += pfh;
      tot[3] += t2r; tot[4] += t2w; tot[5] += ev;
      if (evict) eu[chosen] += 1;
      const int wi = win[rl + t];
      if (wi >= 0 && wi < W) {
        s_winc[0 * W + wi] += 1;
        s_winc[1 * W + wi] += hit_c;
        s_winc[2 * W + wi] += miss_c;
        s_winc[3 * W + wi] += pfh;
        s_winc[4 * W + wi] += t2r;
        s_winc[5 * W + wi] += t2w;
        s_winc[6 * W + wi] += ev;
        if (evict) s_weu[wi * kExperts + chosen] += 1;
        for (int e = 0; e < kExperts; ++e) s_ww[wi * kExperts + e] = w[e];
      }
      s_misc[kHit + (par ^ 1)] = kBig;
      for (int e = 0; e < kExperts; ++e) s_keys[e] = kNoKey;
    }
    __syncthreads();
  }

  // --- outputs -------------------------------------------------------------
  for (int i = tid; i < 7 * W; i += nt) winc_out[row * 7 * W + i] = s_winc[i];
  for (int i = tid; i < kExperts * W; i += nt) {
    weu_out[row * kExperts * W + i] = s_weu[i];
    ww_out[row * kExperts * W + i] = s_ww[i];
  }
  if (tid == 0) {
    for (int i = 0; i < 6; ++i) scal_out[row * 8 + i] = tot[i];
    scal_out[row * 8 + 6] = 0;
    scal_out[row * 8 + 7] = 0;
    for (int e = 0; e < kExperts; ++e) {
      eu_out[row * kExperts + e] = eu[e];
      fw_out[row * kExperts + e] = w[e];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, bytes.
size_t cache_scan_smem_bytes(int ring, int pwidth, int pbuf, int W, int ew) {
  size_t n = kExperts * sizeof(unsigned long long);
  n += sizeof(int) * (kMisc + 2 * pwidth + kExperts * ring + 2 * pbuf
                      + 7 * W + kExperts * W);
  n += sizeof(float) * ((ew + 1) + kExperts * W);
  return n;
}

const char* cache_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches one block per row on `stream`; returns cudaGetLastError().
int cache_scan_launch(
    const int* pages, const int* writes, const int* win, const float* alpha,
    const float* thr, const int* pol, const float* pw, const int* keys,
    int* scratch, int* scal, int* eu, int* winc, int* weu, float* ww,
    float* fw, int B, int L, int N, int ew, int ring, int prefetch,
    int pwidth, int pbuf, int W, int threads, void* stream) {
  const size_t smem = cache_scan_smem_bytes(ring, pwidth, pbuf, W, ew);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cache_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t bn = static_cast<size_t>(B) * N;
  cache_scan_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      pages, writes, win, alpha, thr, pol, pw, keys,
      scratch, scratch + bn, scratch + 2 * bn, scratch + 3 * bn,
      scal, eu, winc, weu, ww, fw, L, N, ew, ring, prefetch, pwidth, pbuf, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
