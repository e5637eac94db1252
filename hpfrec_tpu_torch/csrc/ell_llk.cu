// K4 — train log-likelihood / RMSE partial sums over a user-side ELL layout.
//
// Replaces hpfrec_tpu/ops/metrics.py:ell_llk_parts (via
// ell_llk_rmse_sums, metrics.py:79-140).  Over the slots of the layout's
// buckets with y = vals > 0:  yhat = <Theta[rows[r]], Beta[col_off +
// cols[r,j]]>,
//   ll = y * log(yhat > 0 ? yhat : 1) [- lgamma(y + 1) when full_llk],
//   se = (y - yhat)^2,  sp = yhat,
// summed into one (ll, se, sp) float64 partial per block; the host reads
// all partials back once per check and adds them in float64.
//
// What bounds it on the card: as K1's user side, the gather of one random
// Beta row (k * sizeof(T) bytes, seven 32-byte sectors at k = 50 in
// float32) per slot; at the MillionSong shape Beta is 75 MB against the
// H100's 50 MB L2, and the popular items' rows stay there.  It runs once
// per convergence check.
//
// Design: K1's walk (ell_phi_sums.cu), a launch a bucket
// (ops/metrics.py:ell_llk_rmse_sums loops over bucket_llk_parts; one
// launch over every bucket from K1's table of the buckets read 2-4% slower,
// PERF.md).  A bucket whose segments are split over WPS warps has each warp
// walk its own 32-slot groups (s, s + WPS, ...) with its own copy of the
// Theta row.  A warp holds the user's Theta row in registers (KPL elements
// a lane), loads 32 slots' vals and cols with one coalesced load each (the
// next 32 in flight), and a ballot on y > 0 gives the slots to visit, so
// padding costs no gather.  The set slots go G at a time (G = 8, or 4 for
// float64 at k > 128): their cols are handed out by shuffles and all G Beta
// gathers are issued before any arithmetic, and the G dots are added over
// the lanes at once (common.cuh transposed_sums: the same pairs as
// warp_sum, so each yhat has the bits of the warp_sum walk this replaced).
// Over the <= 32 / G rounds of a group every lane keeps one slot's (y,
// yhat), so all 32 lanes then compute their slot's terms in T, as the JAX
// version does (common.cuh llk_add), and add them to float64 sums of their
// own (the walk this replaced had lane 0 do every slot's terms).  The
// block adds its lanes' sums by an xor butterfly a warp and the warps in
// warp order (llk_block_store) into its partial.  The partial count is a
// function of the layout only; no atomics, so every run gives the same
// bits.
#include "common.cuh"

namespace hpf {

constexpr unsigned kLlkMask = 0xffffffffu;

// The (ll, se, sp) sums of this lane's slots of segment ``seg`` of an
// (m, w) bucket, walked by this warp's share (``sub`` of ``wps`` warps).
template <int KPL, bool FULL, typename T>
__device__ __forceinline__ void segment_llk(const T* __restrict__ theta,
                                            const T* __restrict__ beta,
                                            const int32_t* __restrict__ rows,
                                            const int32_t* __restrict__ cols,
                                            const T* __restrict__ vals, int64_t seg, int64_t m,
                                            int w, int k, int64_t col_off, int wps, int sub,
                                            double& ll, double& se, double& sp) {
  // gathers in flight a warp: 8, or 4 where 8 rows would take more than
  // 128 registers (float64 at KPL = 8)
  constexpr int G = KPL * sizeof(T) > 32 ? 4 : 8;
  constexpr int kOwn = kWarp / G;  // lanes that hold one slot's dot; rounds a group at most
  if (seg >= m) return;            // uniform over the warp
  const int lane = threadIdx.x & (kWarp - 1);
  const int own = lane / kOwn;  // the round's slot this lane's dot is
  const int keep_round = lane % kOwn;  // the round whose slot this lane keeps
  const T* trow = theta + (int64_t)rows[seg] * k;
  T th[KPL];
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int c = lane + kWarp * q;
    th[q] = c < k ? trow[c] : T(0);
  }
  const int64_t base = seg * (int64_t)w;
  int g0 = sub * kWarp;
  T my_v = g0 + lane < w ? vals[base + g0 + lane] : T(0);
  int32_t my_c = g0 + lane < w ? cols[base + g0 + lane] : 0;
  for (; g0 < w; g0 += wps * kWarp) {
    const int j1 = g0 + wps * kWarp + lane;
    const T nx_v = j1 < w ? vals[base + j1] : T(0);
    const int32_t nx_c = j1 < w ? cols[base + j1] : 0;
    unsigned pend = __ballot_sync(kLlkMask, my_v > T(0));  // the slots to visit
    T y = T(0), yhat = T(0);
    bool kept = false;
    for (int round = 0; pend != 0u; ++round) {  // uniform
      int src[G], own_src = -1;  // the round's slots; this lane's one
#pragma unroll
      for (int u = 0; u < G; ++u) {
        src[u] = pend != 0u ? __ffs(pend) - 1 : -1;
        pend &= pend - 1u;
        if (u == own) own_src = src[u];
      }
      // all G rows' loads first, then the products (loads and their uses
      // interleaved would keep one gather in flight); a slot that is not
      // set reads row 0 and its dot is never kept
      T o[G][KPL];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const bool ok = src[u] >= 0;
        const int32_t col = __shfl_sync(kLlkMask, my_c, ok ? src[u] : 0);
        const T* brow = beta + ((int64_t)(ok ? col : 0) + col_off) * k;
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          const int c = lane + kWarp * q;
          o[u][q] = c < k ? brow[c] : T(0);
        }
      }
      T d[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        d[u] = T(0);
#pragma unroll
        for (int q = 0; q < KPL; ++q) d[u] += th[q] * o[u][q];
      }
      const T dot = transposed_sums<G, T>(d, lane);
      const T v = __shfl_sync(kLlkMask, my_v, own_src >= 0 ? own_src : 0);
      if (round == keep_round && own_src >= 0) {
        y = v;
        yhat = dot;
        kept = true;
      }
    }
    if (kept) llk_add(y, yhat, FULL, ll, se, sp);
    my_v = nx_v;
    my_c = nx_c;
  }
}

// One bucket: segment blockIdx.x * (8 / wps) + warp / wps, partial row
// blockIdx.x.
template <int KPL, bool FULL, typename T>
__global__ void __launch_bounds__(kThreads)
    ell_llk_kernel(const T* __restrict__ theta, const T* __restrict__ beta,
                   const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                   const T* __restrict__ vals, double* __restrict__ partials, int64_t m, int w,
                   int k, int64_t col_off, int wps) {
  const int warp = threadIdx.x / kWarp;
  const int64_t seg = (int64_t)blockIdx.x * (kWarpsPerBlock / wps) + warp / wps;
  double ll = 0.0, se = 0.0, sp = 0.0;
  segment_llk<KPL, FULL, T>(theta, beta, rows, cols, vals, seg, m, w, k, col_off, wps,
                            warp % wps, ll, se, sp);
  llk_block_store(warp_sum(ll), warp_sum(se), warp_sum(sp), partials);
}

template <int KPL, typename T>
cudaError_t launch_llk(const T* theta, const T* beta, const int32_t* rows, const int32_t* cols,
                       const T* vals, double* partials, int64_t m, int w, int k, int64_t col_off,
                       int full_llk, int wps, cudaStream_t stream) {
  if (wps != 1 && wps != 2 && wps != 4 && wps != 8) return cudaErrorInvalidValue;
  if (m <= 0 || w <= 0) return cudaSuccess;
  const int64_t per_block = kWarpsPerBlock / wps;
  const int64_t blocks = (m + per_block - 1) / per_block;
  if (full_llk)
    ell_llk_kernel<KPL, true, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        theta, beta, rows, cols, vals, partials, m, w, k, col_off, wps);
  else
    ell_llk_kernel<KPL, false, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        theta, beta, rows, cols, vals, partials, m, w, k, col_off, wps);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_ell_llk_f32(const float* theta, const float* beta, const int32_t* rows,
                    const int32_t* cols, const float* vals, double* partials, int64_t m, int32_t w,
                    int32_t k, int64_t col_off, int32_t full_llk, int32_t wps, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_llk, theta, beta, rows, cols, vals, partials, m, w, k, col_off,
                   full_llk, wps, (cudaStream_t)stream);
}

int hpf_ell_llk_f64(const double* theta, const double* beta, const int32_t* rows,
                    const int32_t* cols, const double* vals, double* partials, int64_t m,
                    int32_t w, int32_t k, int64_t col_off, int32_t full_llk, int32_t wps,
                    void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_llk, theta, beta, rows, cols, vals, partials, m, w, k, col_off,
                   full_llk, wps, (cudaStream_t)stream);
}

}  // extern "C"
