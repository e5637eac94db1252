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
// union of its ranges' n best, ties and -inf included.  Both paths sum the
// scores by one walk (walk_range), so the words are the same.
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
// three-kernel path also writes the (b, nI) scores (1.54 GB a 1,024-user
// chunk, 0.46 ms at 3.35 TB/s) and its select reads them back twice on
// most rows.  The fused path writes (b, R * n) words instead (~2.6 MB at
// R = 33, n = 10) and reads a 48 MB bitmask.
//
// Design of the three-kernel path.  Score: the fused kernel's walk (an item
// range a block, 128-item tiles, sums from 16-byte shared loads in the fused
// kernel's order, so each score has its bits) with 8 x 8 sums a thread in
// float (128 users a block) and wider slabs (32 factors), copied with
// cp.async into a double buffer; the sums are stored 16 bytes a store.
// Select: one block per row; scores map to order-preserving uint32 keys (-inf
// lowest).  A histogram pass counts the keys by their top 12 bits (integer
// atomics in shared memory: exact in any order) and finds the bin that holds
// the n-th largest key.  On a long row the same pass also collects, as (key,
// ~index) words in shared memory, every key in a guessed bin or above: the
// bin of a rank well past the n-th's expected place among 4,096 keys sampled
// across the row.  If the guess is at or below the n-th key's bin and the
// words fit, the words of that bin and above are kept (a fitted MillionSong
// model at n = 2,000: 2,000-2,260 a row, scripts/split_k6_k10.py) and a
// bitonic sort of them descending gives the order of lax.top_k: the row is
// read once.  Otherwise a second pass collects the keys of the n-th key's bin
// and above: twice.  Where that bin holds more keys than the candidate buffer
// takes, another histogram pass resolves the next 12 bits among its keys,
// then the last 8; once all 32 bits are resolved, an ordered pass (a block
// scan of each thread's counts) writes every key above the n-th and the
// lowest-index keys equal to it, exactly as many as n needs.  Up to n = 4,096
// the candidates sort in shared memory (up to 8,192 of them); a larger n
// sorts in a global scratch row by the same block.  The fused kernel's design
// is at topn_fused_kernel.  Every result is bit-identical from run to run.
#include "common.cuh"

namespace hpf {

constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / kWarp;
constexpr int kSmemCand = 4096;  // largest n whose words sort in shared memory
constexpr int kSelCap = 8192;    // candidate words a row collects there
constexpr int kSelBins = 4096;   // the histogram passes' 12-bit digits
constexpr int kSample = 4096;    // keys a row's first guess is taken from

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

// One step of bitonic_desc_regs inside each thread: the pairs (r, r + S)
// of its E words, base the index of its first.
template <int S, int E>
__device__ __forceinline__ void exchange_in_thread(unsigned long long (&v)[E], int base,
                                                   int size) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if ((r & S) == 0) {
      const bool desc = ((base + r) & size) == 0;
      const unsigned long long a = v[r], c = v[r + S];
      const bool swap = desc ? a < c : a > c;
      v[r] = swap ? c : a;
      v[r + S] = swap ? a : c;
    }
  }
}

// bitonic_desc's network on kSelThreads * E words in shared memory, held E
// a thread in registers (thread t the words t E .. t E + E - 1): strides
// below E inside a thread, below 32 E by warp shuffles, larger ones through
// shared memory, so most steps need no barrier.  The words are distinct,
// so the result is bitonic_desc's.  Every thread of the block calls it; it
// ends with a barrier.
template <int E>
__device__ void bitonic_desc_regs(unsigned long long* cand) {
  constexpr int Q = kSelThreads * E;
  const int base = threadIdx.x * E;
  unsigned long long v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) v[r] = cand[base + r];
  for (int size = 2; size <= Q; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= kWarp * E) {
        __syncthreads();
#pragma unroll
        for (int r = 0; r < E; ++r) cand[base + r] = v[r];
        __syncthreads();
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int i = base + r, j = i ^ stride;
          const unsigned long long c = cand[j];
          const bool big = (i < j) == ((i & size) == 0);  // keep the larger word
          v[r] = big == (v[r] > c) ? v[r] : c;
        }
      } else if (stride >= E) {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int i = base + r, j = i ^ stride;
          const unsigned long long c = __shfl_xor_sync(0xffffffffu, v[r], stride / E);
          const bool big = (i < j) == ((i & size) == 0);
          v[r] = big == (v[r] > c) ? v[r] : c;
        }
      } else if (stride == 8) {
        if constexpr (E > 8) exchange_in_thread<8>(v, base, size);
      } else if (stride == 4) {
        if constexpr (E > 4) exchange_in_thread<4>(v, base, size);
      } else if (stride == 2) {
        if constexpr (E > 2) exchange_in_thread<2>(v, base, size);
      } else {
        if constexpr (E > 1) exchange_in_thread<1>(v, base, size);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < E; ++r) cand[base + r] = v[r];
  __syncthreads();
}

// Calls f(key, index, valid) for every key of a row, eight a thread a round
// in index order: a thread's two 16-byte loads (scalar loads where the row
// is not 16-byte aligned, and at its end) are issued before their keys are
// used.  The trip count is the same in every thread, so f may use warp
// collectives.
template <typename F>
__device__ __forceinline__ void walk_row(const float* __restrict__ row, int64_t nI, bool vec,
                                         F&& f) {
  for (int64_t c0 = 0; c0 < nI; c0 += 8 * kSelThreads) {
    float v[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t e0 = c0 + (int64_t)(h * kSelThreads + threadIdx.x) * 4;
      if (vec && e0 + 3 < nI) {
        const float4 q = *reinterpret_cast<const float4*>(row + e0);
        v[4 * h] = q.x;
        v[4 * h + 1] = q.y;
        v[4 * h + 2] = q.z;
        v[4 * h + 3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[4 * h + j] = e0 + j < nI ? row[e0 + j] : 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t e = c0 + (int64_t)(h * kSelThreads + threadIdx.x) * 4 + j;
        f(float_key(v[4 * h + j]), e, e < nI);
      }
    }
  }
}

// The bin of hist[0, nb) that holds the remaining-th largest key, counting
// from the top bin: found = {bin, keys in the bins above it, keys in it}.
// Thread t sums the bins nb - 1 - t * per down; an exclusive scan of those
// sums in thread order finds the one thread whose bins hold the crossing.
// Every thread of the block calls it; it ends with a barrier.
__device__ __forceinline__ void find_bin(const uint32_t* hist, int nb, uint32_t remaining,
                                         uint32_t* warp_tot, uint32_t* found) {
  const int per = nb > kSelThreads ? nb / kSelThreads : 1;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int top = nb - 1 - (int)threadIdx.x * per;  // < 0 past the histogram
  uint32_t local = 0;
  for (int i = 0; i < per && top - i >= 0; ++i) local += hist[top - i];
  uint32_t incl = local;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == kWarp - 1) warp_tot[warp] = incl;
  __syncthreads();
  uint32_t excl = incl - local;
  for (int w = 0; w < warp; ++w) excl += warp_tot[w];
  if (excl < remaining && excl + local >= remaining) {
    uint32_t cum = excl;
    for (int i = 0; i < per; ++i) {
      const uint32_t h = hist[top - i];
      if (cum + h >= remaining) {
        found[0] = (uint32_t)(top - i);
        found[1] = cum;
        found[2] = h;
        break;
      }
      cum += h;
    }
  }
  __syncthreads();
}

// Appends the keys of the lanes that take theirs to cand as (key, ~index)
// words, at positions from a warp's integer atomicAdd on *count (their
// order varies from run to run; the caller sorts the words); a word whose
// position is cap or more is counted but not written.  Every lane of the
// warp calls it.
__device__ __forceinline__ void append(unsigned long long* cand, uint32_t cap, uint32_t* count,
                                       uint32_t key, int64_t e, bool take) {
  const int lane = threadIdx.x & (kWarp - 1);
  const unsigned bal = __ballot_sync(0xffffffffu, take);
  if (bal == 0u) return;
  uint32_t base = 0;
  if (lane == 0) base = atomicAdd(count, (uint32_t)__popc(bal));
  const uint32_t pos = __shfl_sync(0xffffffffu, base, 0) + __popc(bal & ((1u << lane) - 1u));
  if (take && pos < cap) cand[pos] = ((unsigned long long)key << 32) | (uint32_t)(~(uint32_t)e);
}

// Keeps, in place, the words of cand[0, m0) whose key is at or above edge:
// chunk by chunk, every word of a chunk read before any is written, and a
// kept word lands below the chunk's end.  Every thread of the block calls
// it; it starts and ends with a barrier.
__device__ __forceinline__ void keep_from(unsigned long long* cand, uint32_t m0, uint32_t edge,
                                          uint32_t* count) {
  __syncthreads();
  if (threadIdx.x == 0) *count = 0;
  for (uint32_t c0 = 0; c0 < m0; c0 += kSelThreads) {
    const uint32_t i = c0 + threadIdx.x;
    const unsigned long long w = i < m0 ? cand[i] : 0ull;
    __syncthreads();
    append(cand, m0, count, (uint32_t)(w >> 32), ~(uint32_t)(w & 0xffffffffull),
           i < m0 && (uint32_t)(w >> 32) >= edge);
  }
  __syncthreads();
}

// One block a row.  Dynamic shared memory: the histogram (kSelBins
// counts), then, when P <= kSmemCand, kSelCap candidate words; else the
// row's words go to cand_g[row * P ...].  vec: every row starts 16-byte
// aligned.
__global__ void __launch_bounds__(kSelThreads, 2)
    topn_select_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                       int32_t* __restrict__ idx, unsigned long long* __restrict__ cand_g,
                       int64_t nI, int n, int P, bool vec) {
  extern __shared__ __align__(16) unsigned char sel_smem[];
  __shared__ uint32_t warp_tot[kSelWarps], found[3], s_count, s_kept;
  uint32_t* hist = reinterpret_cast<uint32_t*>(sel_smem);
  const bool in_smem = P <= kSmemCand;
  unsigned long long* cand =
      in_smem ? reinterpret_cast<unsigned long long*>(sel_smem + kSelBins * sizeof(uint32_t))
              : cand_g + (int64_t)blockIdx.x * P;
  const uint32_t cap = in_smem ? (uint32_t)kSelCap : (uint32_t)P;
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const float* row = scores + (int64_t)blockIdx.x * nI;

  // the first pass's guess, on a long enough aligned row: the 12-bit bin of
  // the rank-th largest of kSample keys spread over the row, rank past the
  // n-th's expected place among them by three standard deviations and 8;
  // the first histogram pass also collects every key in that bin or above
  const float expect = (float)n * kSample / (float)nI;
  const int rank = (int)ceilf(expect + 3.f * sqrtf(expect) + 8.f);
  const bool guess = vec && nI >= 64 * (int64_t)kSample && rank <= kSample &&
                     (double)rank * nI / kSample <= 0.5 * cap;
  uint32_t guess_edge = 0;
  if (guess) {
    for (int i = tid; i < kSelBins; i += kSelThreads) hist[i] = 0;
    __syncthreads();
    const int64_t step = nI / kSample * 4;  // floats between the 4-key groups
    for (int i = tid; i < kSample / 4; i += kSelThreads) {
      const float4 q = *reinterpret_cast<const float4*>(row + i * step);
      atomicAdd(&hist[float_key(q.x) >> 20], 1u);
      atomicAdd(&hist[float_key(q.y) >> 20], 1u);
      atomicAdd(&hist[float_key(q.z) >> 20], 1u);
      atomicAdd(&hist[float_key(q.w) >> 20], 1u);
    }
    __syncthreads();
    find_bin(hist, kSelBins, (uint32_t)rank, warp_tot, found);
    guess_edge = found[0] << 20;
  }
  if (tid == 0) s_count = 0;

  // histogram passes: the top 12 bits, then the next 12 and the last 8 of
  // the keys that share the bits resolved so far, until the keys at or
  // above the n-th key's bin fit the candidate buffer or all 32 bits are
  // resolved
  int m = 0;
  bool have = false;
  uint32_t prefix = 0, mask = 0, remaining = (uint32_t)n, above = 0, in_bin = 0;
  bool exact = false;
  for (int level = 0; level < 3; ++level) {
    const int shift = level == 0 ? 20 : level == 1 ? 8 : 0;
    const int nb = level == 2 ? 256 : kSelBins;
    const bool collect = guess && level == 0;
    for (int i = tid; i < nb; i += kSelThreads) hist[i] = 0;
    __syncthreads();
    walk_row(row, nI, vec, [&](uint32_t key, int64_t e, bool ok) {
      if (ok && (key & mask) == prefix) atomicAdd(&hist[(key >> shift) & (uint32_t)(nb - 1)], 1u);
      if (collect) append(cand, cap, &s_count, key, e, ok && key >= guess_edge);
    });
    __syncthreads();
    find_bin(hist, nb, remaining, warp_tot, found);
    prefix |= found[0] << shift;
    mask |= (uint32_t)(nb - 1) << shift;
    above += found[1];
    remaining -= found[1];
    in_bin = found[2];
    if (collect && guess_edge <= prefix && s_count <= cap && above + in_bin <= cap) {
      // the guess held: every key at or above the n-th key's bin is among
      // the collected ones; keep just those
      keep_from(cand, s_count, prefix, &s_kept);
      m = (int)(above + in_bin);
      have = true;
      break;
    }
    if (shift == 0) {
      exact = true;
      break;
    }
    if (above + in_bin <= cap) break;
  }

  if (!have && !exact) {
    // every key at or above the bin's lower edge, prefix: above + in_bin
    // words (the barrier: every thread has read s_count in the test above
    // before it is reset)
    __syncthreads();
    if (tid == 0) s_count = 0;
    __syncthreads();
    walk_row(row, nI, vec, [&](uint32_t key, int64_t e, bool ok) {
      append(cand, cap, &s_count, key, e, ok && key >= prefix);
    });
    m = (int)(above + in_bin);
  } else if (!have) {
    // ordered pass: every key above thr, and the first `remaining` keys
    // equal to it in index order, as (key, ~index) words; a thread takes 8
    // consecutive keys a round, its place among the block's from a scan of
    // the threads' counts
    const uint32_t thr = prefix;
    uint32_t base_g = 0, base_q = (uint32_t)above;
    for (int64_t c0 = 0; c0 < nI; c0 += 8 * kSelThreads) {
      const int64_t e0 = c0 + 8 * (int64_t)tid;
      uint32_t key[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) key[j] = e0 + j < nI ? float_key(row[e0 + j]) : 0u;
      uint32_t ng = 0, nq = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ng += key[j] > thr;
        nq += key[j] == thr && e0 + j < nI;
      }
      // block exclusive scan of (ng, nq), packed 16 bits each (a thread's
      // counts are at most 8, a round's 4,096)
      const uint32_t both = ng | nq << 16;
      uint32_t incl = both;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const uint32_t u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      if (lane == kWarp - 1) warp_tot[warp] = incl;
      __syncthreads();
      uint32_t before = incl - both, total = 0;
      for (int w = 0; w < kSelWarps; ++w) {
        if (w < warp) before += warp_tot[w];
        total += warp_tot[w];
      }
      uint32_t og = base_g + (before & 0xffffu), oq = base_q + (before >> 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned long long word =
            ((unsigned long long)key[j] << 32) | (uint32_t)(~(uint32_t)(e0 + j));
        if (key[j] > thr) cand[og++] = word;
        if (key[j] == thr && e0 + j < nI) {
          if (oq < (uint32_t)n) cand[oq] = word;
          ++oq;
        }
      }
      base_g += total & 0xffffu;
      base_q += total >> 16;
      __syncthreads();
    }
    m = n;
  }
  int Q = 1;
  while (Q < m) Q <<= 1;
  for (int i = m + tid; i < Q; i += kSelThreads) cand[i] = 0ull;
  __syncthreads();

  switch (in_smem ? Q : 0) {
    case 512: bitonic_desc_regs<1>(cand); break;
    case 1024: bitonic_desc_regs<2>(cand); break;
    case 2048: bitonic_desc_regs<4>(cand); break;
    case 4096: bitonic_desc_regs<8>(cand); break;
    default: bitonic_desc(cand, Q);
  }
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

// Elements of walk_range's double-buffered Theta and Beta slabs for BM users
// and KC factors a slab (rows padded by 4).
template <int BM, int KC>
__host__ __device__ constexpr int walk_elems() {
  return 2 * KC * (BM + 4) + 2 * KC * (kFuseBN + 4);
}

template <typename T>
constexpr int fused_smem_bytes(int n) {
  return walk_elems<kFuseBM, kFuseKC>() * (int)sizeof(T) +
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

// The walk that topn_fused_kernel and topn_score_kernel share.  One block:
// BM users from m0 x one item range [lo, hi), walked as a sequence of (tile,
// slab) steps: kFuseBN-item tiles, KC factors a slab.  The next step's Theta
// and Beta slabs (and whatever more(h, tile start, slab) copies into half h)
// are copied with cp.async into the other half of a double buffer at smem
// (walk_elems<BM, KC> elements) while this one is summed.  Each thread sums
// TM users x 8 items in registers from 16-byte shared loads: acc[i][j] is
// user m0 + i / 4 * 64 + ty * 4 + i % 4 and item (j < 4 ? tx * 4 + j : 64 +
// tx * 4 + j - 4) of the tile, summed in ascending k with one accumulator an
// output, plus 0 once after the last factor where k is not a multiple of
// kFuseKC (the sums of a zero-padded last slab: x + 0 turns -0 into +0).
// So every kernel that walks this way gives each score the same bits,
// whatever its tile shape.  start(h) runs at a tile's first step, after the
// step's barrier; end(acc, tile start) after the tile's last slab, before
// the step's closing barrier.  UNROLL unrolls the sum over a whole slab.
// Every thread of the block calls it.
template <typename T, int BM, int TM, int KC, int UNROLL, typename More, typename Start,
          typename End>
__device__ __forceinline__ void walk_range(const T* __restrict__ theta,
                                           const T* __restrict__ beta, int b, int k, int m0,
                                           int64_t lo, int64_t hi, unsigned char* smem,
                                           More&& more, Start&& start, End&& end) {
  static_assert(BM == 16 * TM && TM % 4 == 0, "16 rows of TM users a block");
  auto sa = reinterpret_cast<T(*)[KC][BM + 4]>(smem);
  auto sb = reinterpret_cast<T(*)[KC][kFuseBN + 4]>(smem + 2 * KC * (BM + 4) * sizeof(T));
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nslab = (k + KC - 1) / KC;
  const int64_t nsteps = (hi - lo + kFuseBN - 1) / kFuseBN * nslab;

  // (tile start, slab) of the step being summed and of the next copy
  int s = 0, ps = 0;
  int64_t n0 = lo, pn0 = lo;
  auto prefetch = [&](int h) {
    const int k0 = ps * KC;
    const int kc = k - k0 < KC ? k - k0 : KC;
    for (int e = tid; e < BM * KC; e += kThreads) {
      const int kk = e % KC, m = e / KC;
      const bool ok = m0 + m < b && kk < kc;
      cp_async(&sa[h][kk][m], theta + (ok ? (int64_t)(m0 + m) * k + k0 + kk : 0), ok);
    }
    for (int e = tid; e < kFuseBN * KC; e += kThreads) {
      const int kk = e % KC, m = e / KC;
      const bool ok = pn0 + m < hi && kk < kc;
      cp_async(&sb[h][kk][m], beta + (ok ? (pn0 + m) * k + k0 + kk : 0), ok);
    }
    more(h, pn0, ps);
    cp_async_commit();
    if (++ps == nslab) {
      ps = 0;
      pn0 += kFuseBN;
    }
  };
  T acc[TM][8];
  prefetch(0);
  for (int64_t g = 0; g < nsteps; ++g) {
    const int h = (int)(g & 1);
    if (g + 1 < nsteps) {
      prefetch(h ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
      start(h);
    }
    auto step = [&](int kk) {
      T av[TM], bv[8];
#pragma unroll
      for (int i = 0; i < TM; i += 4) load4(&sa[h][kk][i * 16 + ty * 4], av + i);
      load4(&sb[h][kk][tx * 4], bv);
      load4(&sb[h][kk][64 + tx * 4], bv + 4);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    };
    const int kc = k - s * KC < KC ? k - s * KC : KC;
    if (kc == KC) {
#pragma unroll (UNROLL)
      for (int kk = 0; kk < KC; ++kk) step(kk);
    } else {
#pragma unroll 2
      for (int kk = 0; kk < kc; ++kk) step(kk);
    }
    if (s == nslab - 1) {
      if (k % kFuseKC != 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += T(0);
      }
      end(acc, n0);
    }
    __syncthreads();
    if (++s == nslab) {
      s = 0;
      n0 += kFuseBN;
    }
  }
}

// One block: kFuseBM users x one item range [lo, hi), walked by walk_range
// (4 users x 8 items a thread, kFuseKC factors a slab); a tile's first slab
// brings its seen-bit words with it.
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
  // dynamic shared memory: walk_range's slabs, then the users' buffers
  // (kFuseBM rows of n + kFuseSlack words); fused_smem_bytes
  extern __shared__ __align__(16) unsigned char fused_smem[];
  auto buf = reinterpret_cast<unsigned long long*>(
      fused_smem + walk_elems<kFuseBM, kFuseKC>() * sizeof(T));
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
  if (tid < kFuseBM) {
    cnt[tid] = lcnt[tid] = 0;
    thr[tid] = 0ull;  // every word is above 0: an unfilled list takes all
  }

  uint32_t mbits[4];
  auto copy_mask = [&](int h, int64_t n0, int s) {
    if (s == 0 && mask != nullptr) {
      const int m = tid >> 2, w = tid & 3;
      const int64_t word = (n0 >> 5) + w;
      const bool ok = m0 + m < b && word < W;
      cp_async(&smask[h][m][w], mask + (ok ? (int64_t)(m0 + m) * W + word : 0), ok);
    }
  };
  auto read_mask = [&](int h) {
    const int sh = (tx * 4) & 31;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mbits[i] = mask == nullptr ? 0u
                 : ((smask[h][ty * 4 + i][tx >> 3] >> sh) & 0xfu) |
                       (((smask[h][ty * 4 + i][2 + (tx >> 3)] >> sh) & 0xfu) << 4);
  };
  auto offer = [&](T (&acc)[4][8], int64_t n0) {
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
  };
  walk_range<T, kFuseBM, 4, kFuseKC, kFuseKC>(theta, beta, b, k, m0, lo, hi, fused_smem,
                                              copy_mask, read_mask, offer);

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

// K6's scores for the three-kernel path.  One block: kBM users x one item
// range [lo, hi), walked by walk_range as the fused kernel walks its ranges,
// so each score has the fused kernel's bits: float 8 x 8 sums a thread from
// four 16-byte loads a factor (the fused kernel's 4 x 8 take three for half
// the sums) and 32-factor slabs; double 4 x 8 and 16, as the fused kernel.
// After a tile's last slab the sums are rounded to float32 and stored, 16
// bytes a store where the row allows it.
template <typename T>
struct ScoreTile {
  static constexpr int kTM = sizeof(T) == 4 ? 8 : 4;  // users a thread
  static constexpr int kBM = 16 * kTM;  // users a block (hpf_topn_score_rows_*)
  static constexpr int kKC = sizeof(T) == 4 ? 32 : 16;  // factors a slab
  static constexpr int kBytes = walk_elems<kBM, kKC>() * (int)sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    topn_score_kernel(const T* __restrict__ theta, const T* __restrict__ beta,
                      float* __restrict__ scores, int b, int64_t nI, int k, int64_t range_w,
                      bool vec) {
  using S = ScoreTile<T>;
  extern __shared__ __align__(16) unsigned char score_smem[];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * S::kBM;
  const int64_t lo = (int64_t)blockIdx.x * range_w;
  const int64_t hi = lo + range_w < nI ? lo + range_w : nI;
  auto store = [&](T (&acc)[S::kTM][8], int64_t n0) {
#pragma unroll
    for (int i = 0; i < S::kTM; ++i) {
      const int row = m0 + i / 4 * 64 + ty * 4 + i % 4;
      if (row >= b) continue;
      float* out = scores + (int64_t)row * nI;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t item = n0 + half * 64 + tx * 4;
        const float v0 = (float)acc[i][4 * half], v1 = (float)acc[i][4 * half + 1];
        const float v2 = (float)acc[i][4 * half + 2], v3 = (float)acc[i][4 * half + 3];
        if (vec && item + 3 < hi) {
          *reinterpret_cast<float4*>(out + item) = make_float4(v0, v1, v2, v3);
        } else {
          if (item < hi) out[item] = v0;
          if (item + 1 < hi) out[item + 1] = v1;
          if (item + 2 < hi) out[item + 2] = v2;
          if (item + 3 < hi) out[item + 3] = v3;
        }
      }
    }
  };
  walk_range<T, S::kBM, S::kTM, S::kKC, 2>(
      theta, beta, b, k, m0, lo, hi, score_smem, [](int, int64_t, int) {}, [](int) {}, store);
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
                              int64_t nI, int32_t k, int64_t range_w, int32_t R,
                              cudaStream_t stream) {
  if (b <= 0 || nI <= 0 || k <= 0 || range_w <= 0 || range_w % kFuseBN != 0 || R <= 0 ||
      (int64_t)(R - 1) * range_w >= nI || (int64_t)R * range_w < nI ||
      (b + ScoreTile<T>::kBM - 1) / ScoreTile<T>::kBM > 65535)
    return cudaErrorInvalidValue;
  const int smem = ScoreTile<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(topn_score_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool vec = nI % 4 == 0 && reinterpret_cast<uintptr_t>(scores) % 16 == 0;
  const dim3 grid((unsigned)R, (unsigned)((b + ScoreTile<T>::kBM - 1) / ScoreTile<T>::kBM));
  topn_score_kernel<T><<<grid, kThreads, smem, stream>>>(theta, beta, scores, b, nI, k, range_w,
                                                        vec);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_topn_score_f32(const float* theta, const float* beta, float* scores, int32_t b,
                       int64_t nI, int32_t k, int64_t range_w, int32_t R, void* stream) {
  return hpf::launch_topn_score(theta, beta, scores, b, nI, k, range_w, R,
                                (cudaStream_t)stream);
}

int hpf_topn_score_f64(const double* theta, const double* beta, float* scores, int32_t b,
                       int64_t nI, int32_t k, int64_t range_w, int32_t R, void* stream) {
  return hpf::launch_topn_score(theta, beta, scores, b, nI, k, range_w, R,
                                (cudaStream_t)stream);
}

// Users a block of topn_score_kernel: ops/topk.py sizes its item ranges by it.
int hpf_topn_score_rows_f32() { return hpf::ScoreTile<float>::kBM; }
int hpf_topn_score_rows_f64() { return hpf::ScoreTile<double>::kBM; }

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
  const int smem = hpf::kSelBins * (int)sizeof(uint32_t) +
                   (P <= hpf::kSmemCand ? hpf::kSelCap * (int)sizeof(unsigned long long) : 0);
  cudaError_t err = cudaFuncSetAttribute(hpf::topn_select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool vec = nI % 4 == 0 && reinterpret_cast<uintptr_t>(scores) % 16 == 0;
  hpf::topn_select_kernel<<<(unsigned)b, hpf::kSelThreads, smem, (cudaStream_t)stream>>>(
      scores, vals, idx, cand, nI, n, P, vec);
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
