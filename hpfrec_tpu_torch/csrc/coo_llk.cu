// K5 — log-likelihood / RMSE partial sums over COO triplets.
//
// Replaces hpfrec_tpu/ops/metrics.py:llk_rmse_sums (metrics.py:22-50),
// which backs val_llk_rmse (the val-llk criterion), the final eval on a
// validation set and HPF.eval_llk.  Over the triplets with y > 0:
//   yhat = <Theta[iu], Beta[ii]>,
//   ll = y * log(yhat > 0 ? yhat : 1) [- lgamma(y + 1) when full_llk],
//   se = (y - yhat)^2,  sp = yhat,
// summed into one (ll, se, sp) float64 partial per block; the host reads
// the partials back once per check and adds them in float64.  Padding
// triplets (y == 0) contribute nothing.
//
// What bounds it on the card: the gathers of two random rows (Theta[iu]
// and Beta[ii], k * sizeof(T) bytes each) per triplet; a dot, a log and a
// few flops per triplet are nothing beside them.
//
// Design: K4's per-slot math (common.cuh llk_add / llk_block_store) over a
// flat stream.  Each warp owns a fixed run of kSlotsPerWarp consecutive
// triplets and walks it 4 at a time, the 8 row gathers issued before the
// shuffle reductions; k is spread over the lanes (coalesced row reads).
// Terms in T, sums in float64 by lane 0, the 8 warps of a block added in
// warp order.  The partition depends only on n, and there are no atomics:
// partials are bit-identical run to run.
#include "common.cuh"

namespace hpf {

constexpr int kCooUnroll = 4;
constexpr int kSlotsPerWarp = 256;

template <int KPL, typename T>
__global__ void __launch_bounds__(kThreads)
    coo_llk_kernel(const T* __restrict__ theta, const T* __restrict__ beta,
                   const T* __restrict__ y, const int32_t* __restrict__ iu,
                   const int32_t* __restrict__ ii, double* __restrict__ partials, int64_t n,
                   int k, int full_llk) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int64_t first = ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * kSlotsPerWarp;
  const int64_t last = first + kSlotsPerWarp < n ? first + kSlotsPerWarp : n;
  double ll = 0.0, se = 0.0, sp = 0.0;

  for (int64_t j0 = first; j0 < last; j0 += kCooUnroll) {
    T yv[kCooUnroll], d[kCooUnroll];
#pragma unroll
    for (int u = 0; u < kCooUnroll; ++u) {
      const int64_t j = j0 + u;
      yv[u] = j < last ? y[j] : T(0);
      d[u] = T(0);
      const bool live = yv[u] > T(0);
      const T* trow = theta + (int64_t)(live ? iu[j] : 0) * k;
      const T* brow = beta + (int64_t)(live ? ii[j] : 0) * k;
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int c = lane + kWarp * q;
        if (live && c < k) d[u] += trow[c] * brow[c];
      }
    }
#pragma unroll
    for (int u = 0; u < kCooUnroll; ++u) d[u] = warp_sum(d[u]);
#pragma unroll
    for (int u = 0; u < kCooUnroll; ++u)
      if (yv[u] > T(0)) llk_add(yv[u], d[u], full_llk, ll, se, sp);
  }
  llk_block_store(ll, se, sp, partials);
}

template <int KPL, typename T>
cudaError_t launch_coo_llk(const T* theta, const T* beta, const T* y, const int32_t* iu,
                           const int32_t* ii, double* partials, int64_t n, int k, int full_llk,
                           int64_t nblocks, cudaStream_t stream) {
  const int64_t per_block = (int64_t)kWarpsPerBlock * kSlotsPerWarp;
  if (n <= 0 || nblocks != (n + per_block - 1) / per_block) return cudaErrorInvalidValue;
  coo_llk_kernel<KPL, T><<<(unsigned)nblocks, kThreads, 0, stream>>>(theta, beta, y, iu, ii,
                                                                      partials, n, k, full_llk);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_coo_llk_f32(const float* theta, const float* beta, const float* y, const int32_t* iu,
                    const int32_t* ii, double* partials, int64_t n, int32_t k, int32_t full_llk,
                    int64_t nblocks, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_coo_llk, theta, beta, y, iu, ii, partials, n, k, full_llk,
                   nblocks, (cudaStream_t)stream);
}

int hpf_coo_llk_f64(const double* theta, const double* beta, const double* y,
                    const int32_t* iu, const int32_t* ii, double* partials, int64_t n, int32_t k,
                    int32_t full_llk, int64_t nblocks, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_coo_llk, theta, beta, y, iu, ii, partials, n, k, full_llk,
                   nblocks, (cudaStream_t)stream);
}

}  // extern "C"
