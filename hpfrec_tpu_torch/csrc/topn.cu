// K6 — top-n ranking of a batch of users over the whole catalog, with the
// seen items excluded.
//
// Replaces hpfrec_tpu/ops/topk.py:_kernels (topk.py:29-46), the jitted
// `plain` and `masked` functions behind topn_batch (HPF.topN_batch and
// utils/evaluation.py:ranking_metrics):
//   scores = dot(Theta_rows, Beta.T, preferred_element_type=float32)
//   scores[row, seen item] = -inf            (masked only)
//   (values, indices) = lax.top_k(scores, n)
// Two paths, chosen by n (ops/topk.py:topn_rows); both give the same bits.
//
// The fused path, n <= kFuseMaxN (128), three launches on one chunk:
//   topn_bitmask  the chunk's seen pairs as a (b, ceil(nI / 32)) bitmask
//                 (integer atomicOr: the bits do not depend on the order; a
//                 pair outside the (b, nI) scores is dropped, as the JAX
//                 scatter's mode='drop' drops the padding);
//   topn_fused    scores in registers, one bit a score for the mask, and
//                 each item range's n best (key, ~index) words per user
//                 kept in shared memory: (b, R * n) candidates, not (b, nI)
//                 scores;
//   topn_merge    per row, the R * n candidates sorted, the first n out.
// Exact: the words are distinct and totally ordered (score, then index
// ascending, as lax.top_k orders them), so the n best of a row lie in the
// union of its ranges' n best, ties and -inf included.  The scores are
// summed as topn_score_kernel sums them, so the words are the same.
//
// The three-kernel path, any n up to nI:
//   topn_score   (b, nI) float32 scores, summed in the state dtype and
//                rounded to float32 once (XLA computes a float64 dot and
//                converts it; a float32 dot stays float32);
//   topn_mask    -inf at the chunk's (row, seen item) pairs, one thread a
//                pair (the JAX scatter; a pair outside the (b, nI) scores
//                is dropped, as its mode='drop' drops the padding);
//   topn_select  per row, the n largest scores, ordered by score
//                descending and, among equal scores, by index ascending
//                (lax.top_k's order).
//
// What bounds it on the card: the product, 2 b nI k flops (at b = 1024,
// nI = 376,768, k = 50: 3.86e10, 0.58 ms at 67 TFLOP/s of non-tensor
// float32); the bytes it must move (Beta once, 75 MB) take less time.  The
// three-kernel path also writes the (b, nI) scores and reads them back
// five times in the select (four radix passes and the gather): 1.54 GB
// written and ~7.7 GB read per 1,024-user chunk.  The fused path writes
// (b, R * n) words instead (~2.6 MB at R = 33, n = 10) and reads a 48 MB
// bitmask.
//
// Design of the three-kernel path.  Score: a 64-user x 128-item tile per
// block of 256 threads, each thread 4 x 8 outputs, Theta and Beta slabs of
// 16 factors staged in shared memory (padded rows against bank conflicts),
// k in a loop.  Select: one block per row.  Scores map to order-preserving
// uint32 keys (-inf lowest); four 8-bit radix passes with a shared
// histogram (integer atomics: counts are exact) find the n-th largest key
// T and how many keys equal to T to keep.  An ordered pass over the row
// (ballots and warp prefix counts) writes every key above T and the
// lowest-index keys equal to T as 64-bit (key, ~index) words; a bitonic
// sort of those words descending gives the order of lax.top_k.  Up to
// 4,096 candidates sort in shared memory; a larger n sorts in a global
// scratch row by the same block.  The fused kernel's design is at
// topn_fused_kernel.  Every result is bit-identical from run to run.
#include "common.cuh"

namespace hpf {

constexpr int kScoreBM = 64;   // users per tile
constexpr int kScoreBN = 128;  // items per tile
constexpr int kScoreKC = 16;   // factors per shared-memory slab
constexpr int kScoreTM = 4;    // outputs per thread along users
constexpr int kScoreTN = 8;    // outputs per thread along items
constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / kWarp;
constexpr int kSmemCand = 4096;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    topn_score_kernel(const T* __restrict__ theta, const T* __restrict__ beta,
                      float* __restrict__ scores, int b, int64_t nI, int k) {
  __shared__ T sa[kScoreKC][kScoreBM + 1];
  __shared__ T sb[kScoreKC][kScoreBN + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kScoreBM;
  const int64_t n0 = (int64_t)blockIdx.x * kScoreBN;
  T acc[kScoreTM][kScoreTN];
#pragma unroll
  for (int i = 0; i < kScoreTM; ++i)
#pragma unroll
    for (int j = 0; j < kScoreTN; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < k; k0 += kScoreKC) {
    for (int e = threadIdx.x; e < kScoreBM * kScoreKC; e += kThreads) {
      const int kk = e % kScoreKC, m = e / kScoreKC;
      const int row = m0 + m, col = k0 + kk;
      sa[kk][m] = (row < b && col < k) ? theta[(int64_t)row * k + col] : T(0);
    }
    for (int e = threadIdx.x; e < kScoreBN * kScoreKC; e += kThreads) {
      const int kk = e % kScoreKC, m = e / kScoreKC;
      const int64_t item = n0 + m;
      const int col = k0 + kk;
      sb[kk][m] = (item < nI && col < k) ? beta[item * k + col] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kScoreKC; ++kk) {
      T av[kScoreTM], bv[kScoreTN];
#pragma unroll
      for (int i = 0; i < kScoreTM; ++i) av[i] = sa[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kScoreTN; ++j) bv[j] = sb[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kScoreTM; ++i)
#pragma unroll
        for (int j = 0; j < kScoreTN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kScoreTM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= b) continue;
#pragma unroll
    for (int j = 0; j < kScoreTN; ++j) {
      const int64_t item = n0 + tx + 16 * j;
      if (item < nI) scores[(int64_t)row * nI + item] = (float)acc[i][j];
    }
  }
}

__global__ void topn_mask_kernel(float* __restrict__ scores, const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ items, int64_t npairs, int b,
                                 int64_t nI) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < npairs; p += stride) {
    const int32_t r = rows[p], i = items[p];
    if (r >= 0 && r < b && i >= 0 && i < nI) scores[(int64_t)r * nI + i] = -INFINITY;
  }
}

// Order-preserving map of a float to uint32: larger float, larger key;
// -inf maps below every finite value.
__device__ __forceinline__ uint32_t float_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Bitonic sort of P (a power of two) words, descending, by the whole
// block of kSelThreads threads.
__device__ __forceinline__ void bitonic_desc(unsigned long long* cand, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += kSelThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = cand[i], c = cand[j];
          const bool desc = (i & size) == 0;
          if (desc ? (a < c) : (a > c)) {
            cand[i] = c;
            cand[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kSelThreads)
    topn_select_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                       int32_t* __restrict__ idx, unsigned long long* __restrict__ cand_g,
                       int64_t nI, int n, int P) {
  __shared__ uint32_t hist[256];
  __shared__ unsigned long long cand_s[kSmemCand];
  __shared__ uint32_t s_prefix, s_remaining;
  __shared__ int wg[kSelWarps], wq[kSelWarps];
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const float* row = scores + (int64_t)blockIdx.x * nI;
  unsigned long long* cand = P <= kSmemCand ? cand_s : cand_g + (int64_t)blockIdx.x * P;

  // radix select of the n-th largest key, 8 bits a pass from the top
  uint32_t prefix = 0, mask = 0, remaining = (uint32_t)n;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kSelThreads) hist[i] = 0;
    __syncthreads();
    for (int64_t e = tid; e < nI; e += kSelThreads) {
      const uint32_t key = float_key(row[e]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xffu], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      uint32_t above = 0;
      int bin = 255;
      for (; bin > 0; --bin) {
        if (above + hist[bin] >= remaining) break;
        above += hist[bin];
      }
      s_prefix = prefix | ((uint32_t)bin << shift);
      s_remaining = remaining - above;
    }
    __syncthreads();
    prefix = s_prefix;
    remaining = s_remaining;
    mask |= 0xffu << shift;
  }
  const uint32_t thr = prefix;
  const int n_above = n - (int)remaining;

  // ordered pass: every key above thr, and the first `remaining` keys equal
  // to it in index order, as (key, ~index) words
  int base_g = 0, base_q = 0;
  const uint32_t lt = (1u << lane) - 1u;
  for (int64_t c0 = 0; c0 < nI; c0 += kSelThreads) {
    const int64_t e = c0 + tid;
    const uint32_t key = e < nI ? float_key(row[e]) : 0u;
    const bool g = e < nI && key > thr;
    const bool q = e < nI && key == thr;
    const unsigned bg = __ballot_sync(0xffffffffu, g);
    const unsigned bq = __ballot_sync(0xffffffffu, q);
    if (lane == 0) {
      wg[warp] = __popc(bg);
      wq[warp] = __popc(bq);
    }
    __syncthreads();
    int og = 0, oq = 0, tg = 0, tq = 0;
    for (int w = 0; w < kSelWarps; ++w) {
      if (w < warp) {
        og += wg[w];
        oq += wq[w];
      }
      tg += wg[w];
      tq += wq[w];
    }
    const unsigned long long word = ((unsigned long long)key << 32) | (uint32_t)(~(uint32_t)e);
    if (g) cand[base_g + og + __popc(bg & lt)] = word;
    if (q) {
      const int r = base_q + oq + __popc(bq & lt);
      if (r < (int)remaining) cand[n_above + r] = word;
    }
    base_g += tg;
    base_q += tq;
    __syncthreads();
  }
  for (int i = n + tid; i < P; i += kSelThreads) cand[i] = 0ull;
  __syncthreads();

  bitonic_desc(cand, P);
  for (int i = tid; i < n; i += kSelThreads) {
    const unsigned long long word = cand[i];
    vals[(int64_t)blockIdx.x * n + i] = key_float((uint32_t)(word >> 32));
    idx[(int64_t)blockIdx.x * n + i] = (int32_t)(~(uint32_t)(word & 0xffffffffull));
  }
}

// ---- the fused path (n <= kFuseMaxN) ---------------------------------------

constexpr int kFuseBM = 64;     // users per block
constexpr int kFuseBN = 128;    // items per tile
constexpr int kFuseKC = 16;     // factors per shared-memory slab
constexpr int kFuseMaxN = 128;  // ops/topk.py _FUSED_MAX_N
constexpr int kFuseSlack = 64;  // buffer words a user has beyond its n kept
constexpr int kFuseUsersPerWarp = kFuseBM / kWarpsPerBlock;
// elements of the double-buffered Theta and Beta slabs (rows padded by 4)
constexpr int kFuseSlabA = 2 * kFuseKC * (kFuseBM + 4);
constexpr int kFuseSlabB = 2 * kFuseKC * (kFuseBN + 4);

template <typename T>
constexpr int fused_smem_bytes(int n) {
  return (kFuseSlabA + kFuseSlabB) * (int)sizeof(T) +
         kFuseBM * (n + kFuseSlack) * (int)sizeof(unsigned long long);
}

// Four consecutive values of a 16-byte aligned shared-memory row.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 c = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = c.x;
  v[3] = c.y;
}

// The seen-item bitmask of a chunk: bit (i & 31) of word r * W + (i >> 5)
// is set for each pair (r, i) inside the (b, nI) scores.  Integer atomics:
// the result does not depend on their order.
__global__ void topn_bitmask_kernel(uint32_t* __restrict__ mask, const int32_t* __restrict__ rows,
                                    const int32_t* __restrict__ items, int64_t npairs, int b,
                                    int64_t nI, int64_t W) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < npairs; p += stride) {
    const int32_t r = rows[p], i = items[p];
    if (r >= 0 && r < b && i >= 0 && i < nI)
      atomicOr(&mask[(int64_t)r * W + (i >> 5)], 1u << (i & 31));
  }
}

// The n largest words of one user's buffer a[0, c), whose first l words
// are sorted descending, written sorted to a[0, min(c, n)) by one warp.
// A word's rank is the number of larger words: a sorted word's position
// plus the unsorted words above it; an unsorted word's count in the sorted
// part by binary search plus the unsorted words above it.  The words are
// distinct, so the ranks are too.  c <= kFuseMaxN + kFuseSlack.
__device__ __forceinline__ int merge_top(unsigned long long* a, int l, int c, int n, int lane) {
  constexpr int kPer = (kFuseMaxN + kFuseSlack) / kWarp;
  unsigned long long v[kPer];
  int r[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = lane + kWarp * q;
    r[q] = n;
    if (e < c) {
      const unsigned long long x = a[e];
      int rank;
      if (e < l) {
        rank = e;
      } else {
        int lo = 0, hi = l;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (a[mid] > x) lo = mid + 1; else hi = mid;
        }
        rank = lo;
      }
      for (int f = l; f < c; ++f) rank += a[f] > x;
      v[q] = x;
      r[q] = rank;
    }
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    if (r[q] < n) a[r[q]] = v[q];
  __syncwarp();
  return c < n ? c : n;
}

// Asynchronous copies of one 4- or 8-byte element from device to shared
// memory (cp.async); a copy that is not valid writes zeros and reads
// nothing.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem, bool valid) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
               "n"((int)sizeof(T)), "r"(valid ? (int)sizeof(T) : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One block: kFuseBM users x one item range [lo, hi), walked as a sequence
// of (tile, slab) steps: 128-item tiles, kFuseKC factors a slab.  The next
// step's Theta and Beta slabs (and, at a tile's first slab, its seen-bit
// words) are copied into the other half of a double buffer while this one
// is summed.  Each thread sums 4 users x 8 items in registers (ascending k,
// one accumulator an output, as topn_score_kernel: the same bits).
//
// After a tile's last slab each thread compares its 32 scores with its
// users' thresholds, a float compare first and the exact word compare only
// for the few that reach it, and appends the words above them to the
// users' buffers in shared memory at positions from an integer atomicAdd
// on the user's count.  A buffer holds n + kFuseSlack words; a word that
// finds it full stays in the thread's registers.  Then, while some thread
// of the warp holds such a word, the warp merges each overflowing user's
// buffer down to its n best (merge_top), which raises the threshold to the
// n-th word, and the held words above the new threshold are appended again.
// The threshold only lags the true n-th best, so no word that belongs to
// the range's n best is ever discarded, and merges come only when a
// buffer fills (a warp-serial merge is the expensive step).  The order of
// the appends varies from run to run; the kept words do not, as they are
// the n largest of a fixed set.  At the end each user's n best words of
// the range (0 words past the range's items) go to cand[row][range * n ...].
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    topn_fused_kernel(const T* __restrict__ theta, const T* __restrict__ beta,
                      const uint32_t* __restrict__ mask, int64_t W,
                      unsigned long long* __restrict__ cand, int b, int64_t nI, int k, int n,
                      int64_t range_w, int R) {
  // dynamic shared memory: the double-buffered slabs, then the users'
  // buffers (kFuseBM rows of n + kFuseSlack words); fused_smem_bytes
  extern __shared__ __align__(16) unsigned char fused_smem[];
  auto sa = reinterpret_cast<T(*)[kFuseKC][kFuseBM + 4]>(fused_smem);
  auto sb = reinterpret_cast<T(*)[kFuseKC][kFuseBN + 4]>(fused_smem + kFuseSlabA * sizeof(T));
  auto buf = reinterpret_cast<unsigned long long*>(
      fused_smem + (kFuseSlabA + kFuseSlabB) * sizeof(T));
  __shared__ uint32_t smask[2][kFuseBM][kFuseBN / 32];
  __shared__ int cnt[kFuseBM], lcnt[kFuseBM];
  __shared__ unsigned long long thr[kFuseBM];
  const int cap = n + kFuseSlack;
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kFuseBM;
  const int64_t lo = (int64_t)blockIdx.x * range_w;
  const int64_t hi = lo + range_w < nI ? lo + range_w : nI;
  const int nslab = (k + kFuseKC - 1) / kFuseKC;
  const int64_t nsteps = (hi - lo + kFuseBN - 1) / kFuseBN * nslab;
  if (tid < kFuseBM) {
    cnt[tid] = lcnt[tid] = 0;
    thr[tid] = 0ull;  // every word is above 0: an unfilled list takes all
  }

  auto prefetch = [&](int64_t g) {
    const int h = (int)(g & 1);
    const int64_t n0 = lo + g / nslab * kFuseBN;
    const int s = (int)(g % nslab), k0 = s * kFuseKC;
    const int kc = k - k0 < kFuseKC ? k - k0 : kFuseKC;
    for (int e = tid; e < kFuseBM * kFuseKC; e += kThreads) {
      const int kk = e % kFuseKC, m = e / kFuseKC;
      const bool ok = m0 + m < b && kk < kc;
      cp_async(&sa[h][kk][m], theta + (ok ? (int64_t)(m0 + m) * k + k0 + kk : 0), ok);
    }
    for (int e = tid; e < kFuseBN * kFuseKC; e += kThreads) {
      const int kk = e % kFuseKC, m = e / kFuseKC;
      const bool ok = n0 + m < hi && kk < kc;
      cp_async(&sb[h][kk][m], beta + (ok ? (n0 + m) * k + k0 + kk : 0), ok);
    }
    if (s == 0 && mask != nullptr) {
      const int m = tid >> 2, w = tid & 3;
      const int64_t word = (n0 >> 5) + w;
      const bool ok = m0 + m < b && word < W;
      cp_async(&smask[h][m][w], mask + (ok ? (int64_t)(m0 + m) * W + word : 0), ok);
    }
    cp_async_commit();
  };
  T acc[4][8];
  uint32_t mbits[4];
  prefetch(0);
  for (int64_t g = 0; g < nsteps; ++g) {
    const int h = (int)(g & 1);
    const int s = (int)(g % nslab);
    const int64_t n0 = lo + g / nslab * kFuseBN;
    if (g + 1 < nsteps) {
      prefetch(g + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (s == 0) {
      const int sh = (tx * 4) & 31;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
        mbits[i] = mask == nullptr ? 0u
                   : ((smask[h][ty * 4 + i][tx >> 3] >> sh) & 0xfu) |
                         (((smask[h][ty * 4 + i][2 + (tx >> 3)] >> sh) & 0xfu) << 4);
      }
    }
    auto step = [&](int kk) {
      T av[4], bv[8];
      load4(&sa[h][kk][ty * 4], av);
      load4(&sb[h][kk][tx * 4], bv);
      load4(&sb[h][kk][64 + tx * 4], bv + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    };
    const int kc = k - s * kFuseKC < kFuseKC ? k - s * kFuseKC : kFuseKC;
    if (kc == kFuseKC) {
#pragma unroll
      for (int kk = 0; kk < kFuseKC; ++kk) step(kk);
    } else {
      for (int kk = 0; kk < kc; ++kk) step(kk);
    }

    if (s == nslab - 1) {
      // topn_score_kernel adds the zero-padded tail of the last slab: x + 0
      // is x but for -0, which it turns into +0.  Once does the same.
      if (k % kFuseKC != 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += T(0);
      }
      unsigned long long tt[4];
      float tf[4];
      unsigned held[4];  // words of this tile that found a full buffer
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tt[i] = thr[ty * 4 + i];
        tf[i] = m0 + ty * 4 + i >= b ? INFINITY
                : tt[i] ? key_float((uint32_t)(tt[i] >> 32)) : -INFINITY;
        held[i] = 0u;
      }
      bool holds = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float sc = ((mbits[i] >> j) & 1u) ? -INFINITY : (float)acc[i][j];
          if (sc >= tf[i]) {
            const int64_t item = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
            const unsigned long long w =
                ((unsigned long long)float_key(sc) << 32) | (uint32_t)(~(uint32_t)item);
            if (item < hi && w > tt[i]) {
              const int u = ty * 4 + i;
              const int pos = atomicAdd(&cnt[u], 1);
              if (pos < cap) {
                buf[(int64_t)u * cap + pos] = w;
              } else {
                held[i] |= 1u << j;
                holds = true;
              }
            }
          }
        }
      }
      while (__ballot_sync(0xffffffffu, holds) != 0u) {  // uniform in the warp
        __syncwarp();
        for (int uu = 0; uu < kFuseUsersPerWarp; ++uu) {
          const int u = warp * kFuseUsersPerWarp + uu;
          if (cnt[u] <= cap) continue;
          unsigned long long* a = buf + (int64_t)u * cap;
          const int kept = merge_top(a, lcnt[u], cap, n, lane);
          if (lane == 0) {
            cnt[u] = lcnt[u] = kept;
            thr[u] = a[n - 1];
          }
          __syncwarp();
        }
        holds = false;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (held[i] == 0u) continue;
          const int u = ty * 4 + i;
          const unsigned long long t = thr[u];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (!((held[i] >> j) & 1u)) continue;
            held[i] &= ~(1u << j);
            const int64_t item = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
            const float sc = ((mbits[i] >> j) & 1u) ? -INFINITY : (float)acc[i][j];
            const unsigned long long w =
                ((unsigned long long)float_key(sc) << 32) | (uint32_t)(~(uint32_t)item);
            if (w > t) {
              const int pos = atomicAdd(&cnt[u], 1);
              if (pos < cap) {
                buf[(int64_t)u * cap + pos] = w;
              } else {
                held[i] |= 1u << j;
                holds = true;
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  for (int uu = 0; uu < kFuseUsersPerWarp; ++uu) {
    const int u = warp * kFuseUsersPerWarp + uu;
    const int row = m0 + u;
    if (row >= b) break;
    unsigned long long* a = buf + (int64_t)u * cap;
    const int kept = merge_top(a, lcnt[u], cnt[u], n, lane);
    unsigned long long* out = cand + ((int64_t)row * R + blockIdx.x) * n;
    for (int p = lane; p < n; p += kWarp) out[p] = p < kept ? a[p] : 0ull;
  }
}

// One block a row: the R * n candidate words (m of them) sorted
// descending, the first n written as (value, index).
__global__ void __launch_bounds__(kSelThreads)
    topn_merge_kernel(const unsigned long long* __restrict__ cand, float* __restrict__ vals,
                      int32_t* __restrict__ idx, int m, int n, int P) {
  __shared__ unsigned long long s[kSmemCand];
  const unsigned long long* row = cand + (int64_t)blockIdx.x * m;
  for (int i = threadIdx.x; i < P; i += kSelThreads) s[i] = i < m ? row[i] : 0ull;
  __syncthreads();
  bitonic_desc(s, P);
  for (int i = threadIdx.x; i < n; i += kSelThreads) {
    const unsigned long long word = s[i];
    vals[(int64_t)blockIdx.x * n + i] = key_float((uint32_t)(word >> 32));
    idx[(int64_t)blockIdx.x * n + i] = (int32_t)(~(uint32_t)(word & 0xffffffffull));
  }
}

template <typename T>
cudaError_t launch_topn_fused(const T* theta, const T* beta, const uint32_t* mask, int64_t W,
                              unsigned long long* cand, int32_t b, int64_t nI, int32_t k,
                              int32_t n, int64_t range_w, int32_t R, cudaStream_t stream) {
  if (b <= 0 || nI <= 0 || nI > 0x7fffffffLL || k <= 0 || n <= 0 || n > kFuseMaxN || n > nI ||
      range_w <= 0 || range_w % kFuseBN != 0 || R <= 0 || (int64_t)(R - 1) * range_w >= nI ||
      (int64_t)R * range_w < nI || (int64_t)R * n > kSmemCand ||
      (b + kFuseBM - 1) / kFuseBM > 65535 || (mask != nullptr && W < (nI + 31) / 32))
    return cudaErrorInvalidValue;
  const int smem = fused_smem_bytes<T>(n);
  cudaError_t err = cudaFuncSetAttribute(topn_fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)R, (unsigned)((b + kFuseBM - 1) / kFuseBM));
  topn_fused_kernel<T><<<grid, kThreads, smem, stream>>>(theta, beta, mask, W, cand, b, nI, k, n,
                                                        range_w, R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_topn_score(const T* theta, const T* beta, float* scores, int32_t b,
                              int64_t nI, int32_t k, cudaStream_t stream) {
  if (b <= 0 || nI <= 0 || k <= 0 || (b + kScoreBM - 1) / kScoreBM > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nI + kScoreBN - 1) / kScoreBN),
                  (unsigned)((b + kScoreBM - 1) / kScoreBM));
  topn_score_kernel<T><<<grid, kThreads, 0, stream>>>(theta, beta, scores, b, nI, k);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_topn_score_f32(const float* theta, const float* beta, float* scores, int32_t b,
                       int64_t nI, int32_t k, void* stream) {
  return hpf::launch_topn_score(theta, beta, scores, b, nI, k, (cudaStream_t)stream);
}

int hpf_topn_score_f64(const double* theta, const double* beta, float* scores, int32_t b,
                       int64_t nI, int32_t k, void* stream) {
  return hpf::launch_topn_score(theta, beta, scores, b, nI, k, (cudaStream_t)stream);
}

int hpf_topn_mask(float* scores, const int32_t* rows, const int32_t* items, int64_t npairs,
                  int32_t b, int64_t nI, void* stream) {
  if (npairs <= 0) return cudaSuccess;
  int64_t blocks = (npairs + hpf::kThreads - 1) / hpf::kThreads;
  if (blocks > 4096) blocks = 4096;
  hpf::topn_mask_kernel<<<(unsigned)blocks, hpf::kThreads, 0, (cudaStream_t)stream>>>(
      scores, rows, items, npairs, b, nI);
  return cudaGetLastError();
}

int hpf_topn_select(const float* scores, float* vals, int32_t* idx, unsigned long long* cand,
                    int32_t b, int64_t nI, int32_t n, int32_t P, void* stream) {
  if (b <= 0 || n <= 0 || n > nI || nI > 0x7fffffffLL || P < n || (P & (P - 1)) != 0 ||
      (P > hpf::kSmemCand && cand == nullptr))
    return cudaErrorInvalidValue;
  hpf::topn_select_kernel<<<(unsigned)b, hpf::kSelThreads, 0, (cudaStream_t)stream>>>(
      scores, vals, idx, cand, nI, n, P);
  return cudaGetLastError();
}


int hpf_topn_fused_f32(const float* theta, const float* beta, const uint32_t* mask, int64_t W,
                       unsigned long long* cand, int32_t b, int64_t nI, int32_t k, int32_t n,
                       int64_t range_w, int32_t R, void* stream) {
  return hpf::launch_topn_fused(theta, beta, mask, W, cand, b, nI, k, n, range_w, R,
                                (cudaStream_t)stream);
}

int hpf_topn_fused_f64(const double* theta, const double* beta, const uint32_t* mask, int64_t W,
                       unsigned long long* cand, int32_t b, int64_t nI, int32_t k, int32_t n,
                       int64_t range_w, int32_t R, void* stream) {
  return hpf::launch_topn_fused(theta, beta, mask, W, cand, b, nI, k, n, range_w, R,
                                (cudaStream_t)stream);
}

int hpf_topn_bitmask(uint32_t* mask, const int32_t* rows, const int32_t* items, int64_t npairs,
                     int32_t b, int64_t nI, int64_t W, void* stream) {
  if (npairs <= 0) return cudaSuccess;
  if (W < (nI + 31) / 32) return cudaErrorInvalidValue;
  int64_t blocks = (npairs + hpf::kThreads - 1) / hpf::kThreads;
  if (blocks > 4096) blocks = 4096;
  hpf::topn_bitmask_kernel<<<(unsigned)blocks, hpf::kThreads, 0, (cudaStream_t)stream>>>(
      mask, rows, items, npairs, b, nI, W);
  return cudaGetLastError();
}

int hpf_topn_merge(const unsigned long long* cand, float* vals, int32_t* idx, int32_t b,
                   int32_t m, int32_t n, void* stream) {
  int P = 1;
  while (P < m) P <<= 1;
  if (b <= 0 || n <= 0 || m < n || P > hpf::kSmemCand) return cudaErrorInvalidValue;
  hpf::topn_merge_kernel<<<(unsigned)b, hpf::kSelThreads, 0, (cudaStream_t)stream>>>(
      cand, vals, idx, m, n, P);
  return cudaGetLastError();
}

}  // extern "C"
