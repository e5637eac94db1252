// K14 — the seeded MT19937 start of a fit's state, drawn on the card.
//
// Replaces no function of hpfrec_tpu: the JAX package draws the start on
// the host (hpfrec_tpu/models/state.py:initialize_state), and so does
// this package on the CPU.  The kernel exists because that host draw was
// the largest phase of a full-batch fit on the card: 2 (nU + nI) k values
// drawn one 32-bit word each by numpy's Generator(MT19937(seed)), then
// prior + 0.01 u in two passes over fresh pages, then a pageable upload.
// Here the host seeds numpy as before and copies only the generator's
// 624-word key and its position up; the kernels write the same bits:
//   G_rte (n_u values, prior_u), L_rte (n_i, prior_i), G_shp (n_u,
//   prior_u), L_shp (n_i, prior_i), in that order from one stream, each
//   value prior + 0.01 u in the state's dtype (constants rounded to it,
//   a multiply, then an add: __fmul_rn / __fadd_rn, no FMA), with
//   float32 u = (w >> 8) 2^-24 from one word, float64 u = ((w0 >> 5) 2^26
//   + (w1 >> 6)) 2^-53 from two (numpy's next_float / next_double).
// Numpy leaves pos = 623 after seeding, so the stream's first word is
// key[623] and the first twist follows it; the kernels start anywhere in
// [0, 624]: word t of the stream is x[pos + t] tempered, where x[0..623]
// is the key and x[n] = x[n - 227] ^ twist(x[n - 624], x[n - 623]).
//
// What bounds it on the card: not bytes (558 MB written at 3.35 TB/s is
// 0.17 ms at the TasteProfile shape) but the recurrence.  Word n depends
// on words n - 624, n - 623 and n - 227 only, so the 227 words of one
// step are independent and the steps run in order: 139,608,600 words at
// that shape in float32 are 615,016 dependent steps of 227 words, and a
// step's time is its latency (a barrier, shared loads, a twist, a shared
// store) on one SM.
//
// Design: two passes.  (1) One CTA of 256 threads runs the recurrence
// into a scratch stream of raw words, 454 words a step with one barrier a
// step: thread j < 227 makes x[m] and then x[m + 227] (m = step start + j),
// the second from the first, held in a register, and x[m - 397],
// x[m - 396] of an earlier step; its x[m - 227] is its own second word of
// the step before.  The words live in a 2,048-slot ring in shared memory
// (x[n] in slot n mod 2048): a step's writes overwrite words at least
// 2,048 - 453 back, older than any word a step reads (624 back at most),
// so a step's reads and writes never meet, and the barrier orders a
// step's writes before the next step's reads.  A step is then four
// shared loads, two twists in a chain, two shared and two coalesced
// global stores, and the barrier; nothing else (no tempering, no
// conversion, no table) is on the chain, and 615,016 steps of 227 words
// become 307,508.  A first loop takes the key's own words (n < 624); the
// steady loop has none.  (2) A grid-wide pass per table reads its words,
// tempers them, converts and stores the values, coalesced.  The scratch
// is 4 bytes a word, as large as the float32 tables, for the call only.
// Jump-ahead over several CTAs (GF(2) polynomial jumps) would split the
// chain; it is not done.
#include "common.cuh"

namespace hpf {

constexpr int kMtN = 624;
constexpr int kMtM = 397;
constexpr int kMtLag = kMtN - kMtM;  // 227: word n reads n - 624, n - 623, n - 227
constexpr int kStep = 2 * kMtLag;    // words a step: two a thread
constexpr int kRingMask = 2047;
constexpr uint32_t kMatrixA = 0x9908b0dfu;

__device__ __forceinline__ uint32_t twist(uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t y = (a & 0x80000000u) | (b & 0x7fffffffu);
  return c ^ (y >> 1) ^ ((0u - (y & 1u)) & kMatrixA);
}

__device__ __forceinline__ uint32_t temper(uint32_t y) {
  y ^= y >> 11;
  y ^= (y << 7) & 0x9d2c5680u;
  y ^= (y << 15) & 0xefc60000u;
  return y ^ (y >> 18);
}

// Pass 1: words 0 .. n_words - 1 of the stream, untempered, into words[].
__global__ void __launch_bounds__(kThreads)
    mt19937_words_kernel(const uint32_t* __restrict__ key, int pos, uint32_t* __restrict__ words,
                         int64_t n_words) {
  __shared__ uint32_t ring[kRingMask + 1];
  for (int i = threadIdx.x; i < kMtN; i += kThreads) ring[i] = key[i];
  __syncthreads();

  const int j = threadIdx.x;
  const bool lane = j < kMtLag;
  // this thread's words of a step: x[m] and x[m + 227]
  int64_t m = pos + j;
  int s = (int)(m & kRingMask);
  uint32_t c = ring[(s - kMtLag) & kRingMask];  // x[m - 227]
  int64_t t0 = 0;
  // steps that hold words of the key itself (< 624): the first one or two
  for (; t0 < n_words && pos + t0 < kMtN; t0 += kStep, m += kStep) {
    const uint32_t a = ring[(s - kMtN) & kRingMask], b = ring[(s - kMtN + 1) & kRingMask];
    const uint32_t a2 = ring[(s - kMtM) & kRingMask], b2 = ring[(s - kMtM + 1) & kRingMask];
    const int s2 = (s + kMtLag) & kRingMask;
    const uint32_t w1 = m < kMtN ? ring[s] : twist(a, b, c);
    const uint32_t w2 = m + kMtLag < kMtN ? ring[s2] : twist(a2, b2, w1);
    if (lane) {
      if (m >= kMtN) ring[s] = w1;
      if (m + kMtLag >= kMtN) ring[s2] = w2;
      if (t0 + j < n_words) words[t0 + j] = w1;
      if (t0 + j + kMtLag < n_words) words[t0 + j + kMtLag] = w2;
    }
    c = w2;
    s = (s + kStep) & kRingMask;
    __syncthreads();
  }
  // the steady steps: every word a twist
  uint32_t* __restrict__ out = words + t0 + j;
  const int64_t full = (n_words - t0) / kStep;
  for (int64_t q = 0; q < full; ++q) {
    const uint32_t a = ring[(s - kMtN) & kRingMask], b = ring[(s - kMtN + 1) & kRingMask];
    const uint32_t a2 = ring[(s - kMtM) & kRingMask], b2 = ring[(s - kMtM + 1) & kRingMask];
    const uint32_t w1 = twist(a, b, c);
    const uint32_t w2 = twist(a2, b2, w1);
    if (lane) {
      ring[s] = w1;
      ring[(s + kMtLag) & kRingMask] = w2;
      out[0] = w1;
      out[kMtLag] = w2;
    }
    c = w2;
    out += kStep;
    s = (s + kStep) & kRingMask;
    __syncthreads();
  }
  t0 += full * kStep;
  if (lane && t0 + j < n_words) {
    const uint32_t w1 = twist(ring[(s - kMtN) & kRingMask], ring[(s - kMtN + 1) & kRingMask], c);
    out[0] = w1;
    if (t0 + j + kMtLag < n_words)
      out[kMtLag] = twist(ring[(s - kMtM) & kRingMask], ring[(s - kMtM + 1) & kRingMask], w1);
  }
}

__device__ __forceinline__ float prior_plus(float prior, float scale, float u) {
  return __fadd_rn(prior, __fmul_rn(scale, u));
}
__device__ __forceinline__ double prior_plus(double prior, double scale, double u) {
  return __dadd_rn(prior, __dmul_rn(scale, u));
}

// Pass 2: n values of one table from its words (one a value in float32,
// two in float64), grid-stride.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mt19937_values_kernel(const uint32_t* __restrict__ words, T* __restrict__ out, int64_t n,
                          double prior) {
  const T p = (T)prior, scale = (T)0.01;
  for (int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x; v < n;
       v += (int64_t)gridDim.x * kThreads) {
    T u;
    if constexpr (sizeof(T) == 4) {
      u = __fmul_rn((float)(temper(words[v]) >> 8), 1.0f / 16777216.0f);
    } else {
      const uint32_t w0 = temper(words[2 * v]), w1 = temper(words[2 * v + 1]);
      const uint64_t bits = ((uint64_t)(w0 >> 5) << 26) | (uint64_t)(w1 >> 6);
      u = __dmul_rn((double)bits, 1.0 / 9007199254740992.0);
    }
    out[v] = prior_plus(p, scale, u);
  }
}

template <typename T>
int launch_mt19937_init(const uint32_t* key, int32_t pos, uint32_t* words, T* g_rte, T* l_rte,
                        T* g_shp, T* l_shp, int64_t n_u, int64_t n_i, double prior_u,
                        double prior_i, cudaStream_t stream) {
  if (pos < 0 || pos > kMtN || n_u < 0 || n_i < 0) return cudaErrorInvalidValue;
  constexpr int W = sizeof(T) == 4 ? 1 : 2;  // words a value
  const int64_t n_words = 2 * (n_u + n_i) * W;
  if (n_words == 0) return cudaSuccess;
  mt19937_words_kernel<<<1, kThreads, 0, stream>>>(key, pos, words, n_words);
  T* const tables[4] = {g_rte, l_rte, g_shp, l_shp};
  const int64_t counts[4] = {n_u, n_i, n_u, n_i};
  const double priors[4] = {prior_u, prior_i, prior_u, prior_i};
  int64_t first = 0;  // the table's first word
  for (int q = 0; q < 4; ++q) {
    const int64_t n = counts[q];
    if (n > 0) {
      const int64_t blocks = (n + kThreads - 1) / kThreads;
      const int grid = blocks < 2048 ? (int)blocks : 2048;
      mt19937_values_kernel<T><<<grid, kThreads, 0, stream>>>(words + first, tables[q], n,
                                                             priors[q]);
    }
    first += n * W;
  }
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_mt19937_init_f32(const uint32_t* key, int32_t pos, uint32_t* words, float* g_rte,
                         float* l_rte, float* g_shp, float* l_shp, int64_t n_u, int64_t n_i,
                         double prior_u, double prior_i, void* stream) {
  return hpf::launch_mt19937_init(key, pos, words, g_rte, l_rte, g_shp, l_shp, n_u, n_i,
                                  prior_u, prior_i, (cudaStream_t)stream);
}

int hpf_mt19937_init_f64(const uint32_t* key, int32_t pos, uint32_t* words, double* g_rte,
                         double* l_rte, double* g_shp, double* l_shp, int64_t n_u, int64_t n_i,
                         double prior_u, double prior_i, void* stream) {
  return hpf::launch_mt19937_init(key, pos, words, g_rte, l_rte, g_shp, l_shp, n_u, n_i,
                                  prior_u, prior_i, (cudaStream_t)stream);
}

}  // extern "C"
