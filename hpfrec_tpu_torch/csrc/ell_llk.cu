// K4 — train log-likelihood / RMSE partial sums over a user-side ELL layout.
//
// Replaces hpfrec_tpu/ops/metrics.py:ell_llk_parts (via
// ell_llk_rmse_sums, metrics.py:79-140).  Over the slots of one bucket
// with y = vals > 0:  yhat = <Theta[rows[r]], Beta[col_off + cols[r,j]]>,
//   ll = y * log(yhat > 0 ? yhat : 1) [- lgamma(y + 1) when full_llk],
//   se = (y - yhat)^2,  sp = yhat,
// summed into one (ll, se, sp) float64 partial per block; the host reads
// all partials back once per check and adds them in float64.
//
// What bounds it on the card: as K1, the gather of one random Beta row
// (k * sizeof(T) bytes) per slot; it runs once per convergence check, not
// per iteration.
//
// Design: K1's traversal (one warp per segment, 8 per block, 4 slot
// gathers in flight per warp, shuffle-reduced dots).  Each slot's terms
// are computed in T, as the JAX version does, and accumulated in float64
// by lane 0; the 8 warps' sums are added in warp order through shared
// memory (common.cuh llk_add / llk_block_store, shared with K5).  No
// atomics: partials are bit-identical run to run.
#include "common.cuh"

namespace hpf {

constexpr int kLlkUnroll = 4;

template <int KPL, typename T>
__global__ void __launch_bounds__(kThreads)
    ell_llk_kernel(const T* __restrict__ theta, const T* __restrict__ beta,
                   const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                   const T* __restrict__ vals, double* __restrict__ partials, int64_t m, int w,
                   int k, int64_t col_off, int full_llk) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int64_t seg = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  double ll = 0.0, se = 0.0, sp = 0.0;

  if (seg < m) {  // warp-uniform; no early return before __syncthreads
    const T* trow = theta + (int64_t)rows[seg] * k;
    T th[KPL];
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int c = lane + kWarp * q;
      th[q] = c < k ? trow[c] : T(0);
    }
    const int64_t base = seg * (int64_t)w;
    for (int j0 = 0; j0 < w; j0 += kLlkUnroll) {
      T y[kLlkUnroll], d[kLlkUnroll];
#pragma unroll
      for (int u = 0; u < kLlkUnroll; ++u) {
        const int j = j0 + u;
        y[u] = j < w ? vals[base + j] : T(0);
        d[u] = T(0);
        const T* brow = beta + ((int64_t)(y[u] > T(0) ? cols[base + j] : 0) + col_off) * k;
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          const int c = lane + kWarp * q;
          if (y[u] > T(0) && c < k) d[u] += th[q] * brow[c];
        }
      }
#pragma unroll
      for (int u = 0; u < kLlkUnroll; ++u) d[u] = warp_sum(d[u]);
#pragma unroll
      for (int u = 0; u < kLlkUnroll; ++u)
        if (y[u] > T(0)) llk_add(y[u], d[u], full_llk, ll, se, sp);
    }
  }
  llk_block_store(ll, se, sp, partials);
}

template <int KPL, typename T>
cudaError_t launch_llk(const T* theta, const T* beta, const int32_t* rows, const int32_t* cols,
                       const T* vals, double* partials, int64_t m, int w, int k, int64_t col_off,
                       int full_llk, cudaStream_t stream) {
  if (m <= 0) return cudaSuccess;
  const int64_t blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ell_llk_kernel<KPL, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      theta, beta, rows, cols, vals, partials, m, w, k, col_off, full_llk);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_ell_llk_f32(const float* theta, const float* beta, const int32_t* rows,
                    const int32_t* cols, const float* vals, double* partials, int64_t m, int32_t w,
                    int32_t k, int64_t col_off, int32_t full_llk, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_llk, theta, beta, rows, cols, vals, partials, m, w, k, col_off,
                   full_llk, (cudaStream_t)stream);
}

int hpf_ell_llk_f64(const double* theta, const double* beta, const int32_t* rows,
                    const int32_t* cols, const double* vals, double* partials, int64_t m,
                    int32_t w, int32_t k, int64_t col_off, int32_t full_llk, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_llk, theta, beta, rows, cols, vals, partials, m, w, k, col_off,
                   full_llk, (cudaStream_t)stream);
}

}  // extern "C"
