// K5 — log-likelihood / RMSE partial sums over COO triplets.
//
// Replaces hpfrec_tpu/ops/metrics.py:llk_rmse_sums (metrics.py:22-50),
// which backs val_llk_rmse (the val-llk criterion), the final eval on a
// validation set, HPF.eval_llk and the blocked-COO engine's train metric.
// Over the triplets with y > 0:
//   yhat = <Theta[iu], Beta[ii]>,
//   ll = y * log(yhat > 0 ? yhat : 1) [- lgamma(y + 1) when full_llk],
//   se = (y - yhat)^2,  sp = yhat,
// summed into one (ll, se, sp) float64 partial per block; the host reads
// the partials back once per check and adds them in float64.  Padding
// triplets (y == 0) contribute nothing.
//
// What bounds it on the card: the gathers of two random rows (Theta[iu]
// and Beta[ii], k * sizeof(T) bytes each) per triplet; a dot, a log and a
// few flops per triplet are nothing beside them.  The first design (a warp
// a triplet, k spread over 32 lanes in 4-byte loads, a fixed 2,048
// triplets a block) left the validation set's ~387k triplets 190 blocks
// for 132 SMs and read at 13% of the byte bound.
//
// Design: predict_pairs' walk (pair_walk.cuh: a group of G lanes a
// triplet, 8 at k = 50 float32, vector row loads, the next step's y, iu and
// ii loaded while this step's rows arrive) over predict_pairs' grid, a run
// of a multiple of 32 triplets a warp chosen from n alone
// (ops/metrics.py:_pairs_grid: the validation set makes ~760 blocks, the
// COO engine's 38.7M-triplet train stream ~1,050).  Padding is not read.
// The first lane of a triplet's group adds its terms (common.cuh llk_add:
// the terms in T, the sums in float64); the warp's lanes and then the 8
// warps of a block are added in a fixed order.  The partition and the lane
// split depend only on n, k and the dtype, and there are no atomics:
// partials are bit-identical run to run.
#include "pair_walk.cuh"

namespace hpf {

template <typename T, int VE, int VPL>
__global__ void __launch_bounds__(kThreads)
    coo_llk_kernel(const T* __restrict__ theta, const T* __restrict__ beta,
                   const T* __restrict__ y, const int32_t* __restrict__ iu,
                   const int32_t* __restrict__ ii, double* __restrict__ partials, int64_t n,
                   int k, int full_llk, int log2g, int64_t per_warp) {
  const int warp = threadIdx.x / kWarp;
  const int64_t first = ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * per_warp;
  const int64_t last = first + per_warp < n ? first + per_warp : n;
  double ll = 0.0, se = 0.0, sp = 0.0;
  pair_walk<T, VE, VPL, true>(theta, beta, iu, ii, y, first, last, k, log2g,
                              [&](int64_t, T d, T yv) { llk_add(yv, d, full_llk, ll, se, sp); });
  ll = warp_sum(ll);
  se = warp_sum(se);
  sp = warp_sum(sp);
  llk_block_store(ll, se, sp, partials);
}

template <typename T>
cudaError_t launch_coo_llk(const T* theta, const T* beta, const T* y, const int32_t* iu,
                           const int32_t* ii, double* partials, int64_t n, int k, int full_llk,
                           int64_t per_warp, int64_t nblocks, cudaStream_t stream) {
  if (!pair_grid_ok(n, k, per_warp, nblocks, theta, beta)) return cudaErrorInvalidValue;
  return with_pair_form<T>(k, [&](auto ve, auto vpl, int log2g) {
    coo_llk_kernel<T, decltype(ve)::value, decltype(vpl)::value>
        <<<(unsigned)nblocks, kThreads, 0, stream>>>(theta, beta, y, iu, ii, partials, n, k,
                                                     full_llk, log2g, per_warp);
    return cudaGetLastError();
  });
}

}  // namespace hpf

extern "C" {

int hpf_coo_llk_f32(const float* theta, const float* beta, const float* y, const int32_t* iu,
                    const int32_t* ii, double* partials, int64_t n, int32_t k, int32_t full_llk,
                    int64_t per_warp, int64_t nblocks, void* stream) {
  return hpf::launch_coo_llk(theta, beta, y, iu, ii, partials, n, k, full_llk, per_warp,
                             nblocks, (cudaStream_t)stream);
}

int hpf_coo_llk_f64(const double* theta, const double* beta, const double* y,
                    const int32_t* iu, const int32_t* ii, double* partials, int64_t n, int32_t k,
                    int32_t full_llk, int64_t per_warp, int64_t nblocks, void* stream) {
  return hpf::launch_coo_llk(theta, beta, y, iu, ii, partials, n, k, full_llk, per_warp,
                             nblocks, (cudaStream_t)stream);
}

}  // extern "C"
