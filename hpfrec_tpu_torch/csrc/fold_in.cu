// K10 — fold-in CAVI for one user with the item parameters frozen.
//
// Replaces hpfrec_tpu/ops/svi.py:user_factors_loop (svi.py:313-359), the
// jitted while_loop behind HPF.predict_factors and HPF.add_user
// (reference calc_user_factors, cython_loops.pxi:504-518).  Per iteration,
// over the user's P items with E[log beta] rows elogb (P, k):
//   logits[p] = (digamma(G_shp) - log(G_rte)) + elogb[p]
//   phi[p]    = (y[p] / sum(e[p])) e[p],  e[p] = exp(logits[p] - max(logits[p]))
//   G_rte     = k_shp / k_rte + beta_colsum
//   G_shp     = a + sum_p phi[p]
//   Theta'    = G_shp / G_rte;  k_rte = add_k_rte + sum(Theta')
//   stop when ||Theta' - Theta|| < stop_thr (strictly) or at maxiter
// and after the loop phi_norm[p] = e[p] / sum(e[p]) from the final G.
//
// What bounds it on the card: nothing of the card's width.  An iteration
// reads the P x k rows once (P k sizeof(T) bytes, L1/L2-resident after the
// first) and does ~10 flops and an exp per element plus k digammas; the
// loop is a chain of dependent iterations, so its time is latency: launch,
// block barriers and the exp/digamma pipeline.
//
// Design: the whole loop in one launch of one block of 256 threads, with
// no host round trip per iteration.  Items spread over the 8 warps, k over
// the lanes (KPL per lane); a warp's softmax is a shuffle max and sum.
// Each warp adds its items' phi rows in item order in registers; warp 0
// adds the 8 warps' sums in warp order through shared memory and updates
// G, Theta, k_rte and the stop flag, so runs are bit-identical.
// digamma is common.cuh's (as K3's).
#include "common.cuh"

namespace hpf {

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

// logits of item p into lg[] and their exp, shifted by the row max, into
// e[]; returns the sum of e over the k factors (uniform across the warp)
template <int KPL, typename T>
__device__ __forceinline__ T item_softmax(const T* __restrict__ row, const T* eg, int lane, int k,
                                          T* e) {
  T lg[KPL];
  T m = T(-INFINITY);
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int c = lane + kWarp * q;
    lg[q] = c < k ? eg[q] + row[c] : T(-INFINITY);
    m = lg[q] > m ? lg[q] : m;
  }
  m = warp_max(m);
  T s = T(0);
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int c = lane + kWarp * q;
    e[q] = c < k ? dexp(lg[q] - m) : T(0);
    s += e[q];
  }
  return warp_sum(s);
}

template <int KPL, typename T>
__global__ void __launch_bounds__(kThreads)
    fold_in_kernel(const T* __restrict__ y, const T* __restrict__ elogb,
                   const T* __restrict__ beta_colsum, const T* __restrict__ theta0,
                   const T* __restrict__ g_shp0, const T* __restrict__ g_rte0, T k_rte0, T a,
                   T k_shp, T add_k_rte, int maxiter, T stop_thr, int64_t P, int k,
                   T* __restrict__ theta_out, T* __restrict__ g_shp_out,
                   T* __restrict__ g_rte_out, T* __restrict__ phi_out,
                   int32_t* __restrict__ n_iter_out) {
  constexpr int W = kWarp * KPL;
  __shared__ T s_elog[W], s_gshp[W], s_grte[W], s_theta[W];
  __shared__ T red[kWarpsPerBlock][W];
  __shared__ T s_krte;
  __shared__ int s_done;
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;

  for (int c = tid; c < k; c += kThreads) {
    s_gshp[c] = g_shp0[c];
    s_grte[c] = g_rte0[c];
    s_theta[c] = theta0[c];
  }
  if (tid == 0) {
    s_krte = k_rte0;
    s_done = 0;
  }
  __syncthreads();

  int it = 0;
  while (it < maxiter && !s_done) {
    for (int c = tid; c < k; c += kThreads) s_elog[c] = digamma(s_gshp[c]) - dlog(s_grte[c]);
    __syncthreads();
    T eg[KPL], acc[KPL];
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int c = lane + kWarp * q;
      eg[q] = c < k ? s_elog[c] : T(0);
      acc[q] = T(0);
    }
    for (int64_t p = warp; p < P; p += kWarpsPerBlock) {
      T e[KPL];
      const T s = item_softmax<KPL>(elogb + p * k, eg, lane, k, e);
      const T scale = y[p] / s;
#pragma unroll
      for (int q = 0; q < KPL; ++q) acc[q] += scale * e[q];
    }
#pragma unroll
    for (int q = 0; q < KPL; ++q) red[warp][lane + kWarp * q] = acc[q];
    __syncthreads();
    if (warp == 0) {
      const T krte = s_krte;
      T tsum = T(0), dsum = T(0);
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int c = lane + kWarp * q;
        if (c < k) {
          T sphi = T(0);
#pragma unroll
          for (int w = 0; w < kWarpsPerBlock; ++w) sphi += red[w][c];
          const T grte = k_shp / krte + beta_colsum[c];
          const T gshp = a + sphi;
          const T th = gshp / grte;
          const T d = th - s_theta[c];
          s_grte[c] = grte;
          s_gshp[c] = gshp;
          s_theta[c] = th;
          tsum += th;
          dsum += d * d;
        }
      }
      tsum = warp_sum(tsum);
      dsum = warp_sum(dsum);
      if (lane == 0) {
        s_krte = add_k_rte + tsum;
        s_done = dsqrt(dsum) < stop_thr;
      }
    }
    __syncthreads();
    ++it;
  }

  // final normalized phi from the last G
  for (int c = tid; c < k; c += kThreads) s_elog[c] = digamma(s_gshp[c]) - dlog(s_grte[c]);
  __syncthreads();
  T eg[KPL];
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int c = lane + kWarp * q;
    eg[q] = c < k ? s_elog[c] : T(0);
  }
  for (int64_t p = warp; p < P; p += kWarpsPerBlock) {
    T e[KPL];
    const T s = item_softmax<KPL>(elogb + p * k, eg, lane, k, e);
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int c = lane + kWarp * q;
      if (c < k) phi_out[p * k + c] = e[q] / s;
    }
  }
  for (int c = tid; c < k; c += kThreads) {
    theta_out[c] = s_theta[c];
    g_shp_out[c] = s_gshp[c];
    g_rte_out[c] = s_grte[c];
  }
  if (tid == 0) n_iter_out[0] = it;
}

template <int KPL, typename T>
cudaError_t launch_fold_in(const T* y, const T* elogb, const T* beta_colsum, const T* theta0,
                           const T* g_shp0, const T* g_rte0, double k_rte0, double a,
                           double k_shp, double add_k_rte, int32_t maxiter, double stop_thr,
                           int64_t P, int32_t k, T* theta_out, T* g_shp_out, T* g_rte_out,
                           T* phi_out, int32_t* n_iter_out, cudaStream_t stream) {
  if (P < 0 || maxiter < 0) return cudaErrorInvalidValue;
  fold_in_kernel<KPL, T><<<1, kThreads, 0, stream>>>(
      y, elogb, beta_colsum, theta0, g_shp0, g_rte0, (T)k_rte0, (T)a, (T)k_shp, (T)add_k_rte,
      maxiter, (T)stop_thr, P, k, theta_out, g_shp_out, g_rte_out, phi_out, n_iter_out);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_fold_in_f32(const float* y, const float* elogb, const float* beta_colsum,
                    const float* theta0, const float* g_shp0, const float* g_rte0, double k_rte0,
                    double a, double k_shp, double add_k_rte, int32_t maxiter, double stop_thr,
                    int64_t P, int32_t k, float* theta_out, float* g_shp_out, float* g_rte_out,
                    float* phi_out, int32_t* n_iter_out, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_fold_in, y, elogb, beta_colsum, theta0, g_shp0, g_rte0,
                   k_rte0, a, k_shp, add_k_rte, maxiter, stop_thr, P, k, theta_out, g_shp_out,
                   g_rte_out, phi_out, n_iter_out, (cudaStream_t)stream);
}

int hpf_fold_in_f64(const double* y, const double* elogb, const double* beta_colsum,
                    const double* theta0, const double* g_shp0, const double* g_rte0,
                    double k_rte0, double a, double k_shp, double add_k_rte, int32_t maxiter,
                    double stop_thr, int64_t P, int32_t k, double* theta_out,
                    double* g_shp_out, double* g_rte_out, double* phi_out,
                    int32_t* n_iter_out, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_fold_in, y, elogb, beta_colsum, theta0, g_shp0, g_rte0,
                   k_rte0, a, k_shp, add_k_rte, maxiter, stop_thr, P, k, theta_out, g_shp_out,
                   g_rte_out, phi_out, n_iter_out, (cudaStream_t)stream);
}

}  // extern "C"
