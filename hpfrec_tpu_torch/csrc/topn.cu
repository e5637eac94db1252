// K6 — top-n ranking of a batch of users over the whole catalog, with the
// seen items excluded.
//
// Replaces hpfrec_tpu/ops/topk.py:_kernels (topk.py:29-46), the jitted
// `plain` and `masked` functions behind topn_batch (HPF.topN_batch and
// utils/evaluation.py:ranking_metrics):
//   scores = dot(Theta_rows, Beta.T, preferred_element_type=float32)
//   scores[row, seen item] = -inf            (masked only)
//   (values, indices) = lax.top_k(scores, n)
// Three entry points, launched in this order on one chunk of users:
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
// simple design here also writes the (b, nI) scores and reads them back
// five times in the select (four radix passes and the gather): 1.54 GB
// written and ~7.7 GB read per 1,024-user chunk, its gap to the bound.
//
// Design.  Score: a 64-user x 128-item tile per block of 256 threads, each
// thread 4 x 8 outputs, Theta and Beta slabs of 16 factors staged in shared
// memory (padded rows against bank conflicts), k in a loop.  Select: one
// block per row.  Scores map to order-preserving uint32 keys (-inf lowest);
// four 8-bit radix passes with a shared histogram (integer atomics: counts
// are exact) find the n-th largest key T and how many keys equal to T to
// keep.  An ordered pass over the row (ballots and warp prefix counts)
// writes every key above T and the lowest-index keys equal to T as 64-bit
// (key, ~index) words; a bitonic sort of those words descending gives the
// order of lax.top_k.  Up to 4,096 candidates sort in shared memory; a
// larger n sorts in a global scratch row by the same block.  Every n up
// to nI runs; all results are bit-identical from run to run.
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

  // bitonic sort of the P words, descending
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P; i += kSelThreads) {
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
  for (int i = tid; i < n; i += kSelThreads) {
    const unsigned long long word = cand[i];
    vals[(int64_t)blockIdx.x * n + i] = key_float((uint32_t)(word >> 32));
    idx[(int64_t)blockIdx.x * n + i] = (int32_t)(~(uint32_t)(word & 0xffffffffull));
  }
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

}  // extern "C"
