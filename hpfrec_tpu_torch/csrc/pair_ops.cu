// K11 — the small pair and table reductions: predict_pairs (and its sum),
// theta_diff_norm, rowsum_dot_rows.
//
// Replaces hpfrec_tpu/ops/metrics.py:predict_pairs (metrics.py:181-185,
// HPF.predict for 65,536 pairs or more and utils/evaluation.py's pair
// scores), sum_pairs_prediction (:188-191), theta_diff_norm (:194-199, the
// diff-norm criterion) and rowsum_dot_rows (:169-178, the final eval of a
// maxiter or diff-norm fit on a validation set):
//   predict_pairs:    yhat[j] = <Theta[iu[j]], Beta[ii[j]]>   (state dtype);
//                     optionally one float64 partial of sum(yhat) per block
//   theta_diff:       one float64 partial of sum((a - b)^2) per block, the
//                     difference and its square taken in the state dtype
//   rowsum_dot:       per block, the float64 partial column sums of
//                     Theta[iu] and of Beta[ii] (2k values)
// The host reads the partials back and adds them in block order in
// float64 (a check's single readback, as K4 and K5 do).
//
// What bounds it on the card: predict_pairs and rowsum_dot gather two
// random k-wide rows per pair (2 k sizeof(T) bytes) for 2k flops, and
// theta_diff streams two (n, k) tables: all three are bound by bytes.
//
// Design: predict_pairs is the pair walk of pair_walk.cuh (a group of G
// lanes a pair, 8 at k = 50 float32; vector row loads; the next step's
// indices loaded ahead) over a run of a multiple of 32 pairs a warp, chosen
// from n (ops/metrics.py:_pairs_grid) so that 100,000 pairs make about 390
// blocks, three an SM, and 4M pairs about 1,024.  theta_diff and
// rowsum_dot walk a fixed grid of at most 1024 blocks grid-stride.  Each
// block adds its 8 warps' sums in warp order; the partition and the lane
// split depend only on n, k and the dtype, and there are no atomics, so
// every result is bit-identical from run to run.
#include "pair_walk.cuh"

namespace hpf {

template <typename T, int VE, int VPL>
__global__ void __launch_bounds__(kThreads)
    predict_pairs_kernel(const T* __restrict__ theta, const T* __restrict__ beta,
                         const int32_t* __restrict__ iu, const int32_t* __restrict__ ii,
                         T* __restrict__ out, double* __restrict__ partials, int64_t n, int k,
                         int log2g, int64_t per_warp) {
  __shared__ double red[kWarpsPerBlock];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int64_t first = ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * per_warp;
  const int64_t last = first + per_warp < n ? first + per_warp : n;
  double total = 0.0;
  pair_walk<T, VE, VPL, false>(theta, beta, iu, ii, nullptr, first, last, k, log2g,
                               [&](int64_t j, T d, T) {
                                 out[j] = d;
                                 total += (double)d;
                               });
  if (partials == nullptr) return;
  total = warp_sum(total);
  if (lane == 0) red[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) s += red[w];
    partials[blockIdx.x] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    theta_diff_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      double* __restrict__ partials, int64_t n) {
  __shared__ double red[kWarpsPerBlock];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  double s = 0.0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) {
    const T d = a[e] - b[e];
    s += (double)(d * d);
  }
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) t += red[w];
    partials[blockIdx.x] = t;
  }
}

template <int KPL, typename T>
__global__ void __launch_bounds__(kThreads)
    rowsum_dot_kernel(const T* __restrict__ theta, const T* __restrict__ beta,
                      const int32_t* __restrict__ iu, const int32_t* __restrict__ ii,
                      double* __restrict__ partials, int64_t n, int k) {
  __shared__ double red[kWarpsPerBlock][2][kWarp * KPL];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  double ts[KPL], bs[KPL];
#pragma unroll
  for (int q = 0; q < KPL; ++q) ts[q] = bs[q] = 0.0;

  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t j = (int64_t)blockIdx.x * kWarpsPerBlock + warp; j < n; j += stride) {
    const T* trow = theta + (int64_t)iu[j] * k;
    const T* brow = beta + (int64_t)ii[j] * k;
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int c = lane + kWarp * q;
      if (c < k) {
        ts[q] += (double)trow[c];
        bs[q] += (double)brow[c];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    red[warp][0][lane + kWarp * q] = ts[q];
    red[warp][1][lane + kWarp * q] = bs[q];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * k; c += kThreads) {
    const int side = c < k ? 0 : 1;
    const int col = c - side * k;
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) s += red[w][side][col];
    partials[(int64_t)blockIdx.x * 2 * k + c] = s;
  }
}

template <typename T>
cudaError_t launch_predict_pairs(const T* theta, const T* beta, const int32_t* iu,
                                 const int32_t* ii, T* out, double* partials, int64_t n, int k,
                                 int64_t per_warp, int64_t nblocks, cudaStream_t stream) {
  if (!pair_grid_ok(n, k, per_warp, nblocks, theta, beta)) return cudaErrorInvalidValue;
  return with_pair_form<T>(k, [&](auto ve, auto vpl, int log2g) {
    predict_pairs_kernel<T, decltype(ve)::value, decltype(vpl)::value>
        <<<(unsigned)nblocks, kThreads, 0, stream>>>(theta, beta, iu, ii, out, partials, n, k,
                                                     log2g, per_warp);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_theta_diff(const T* a, const T* b, double* partials, int64_t n,
                              int32_t nblocks, cudaStream_t stream) {
  if (n <= 0 || nblocks <= 0 || nblocks > 1024) return cudaErrorInvalidValue;
  theta_diff_kernel<T><<<(unsigned)nblocks, kThreads, 0, stream>>>(a, b, partials, n);
  return cudaGetLastError();
}

template <int KPL, typename T>
cudaError_t launch_rowsum_dot(const T* theta, const T* beta, const int32_t* iu,
                              const int32_t* ii, double* partials, int64_t n, int k,
                              int32_t nblocks, cudaStream_t stream) {
  if (n <= 0 || nblocks <= 0 || nblocks > 1024) return cudaErrorInvalidValue;
  rowsum_dot_kernel<KPL, T><<<(unsigned)nblocks, kThreads, 0, stream>>>(theta, beta, iu, ii,
                                                                         partials, n, k);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_predict_pairs_f32(const float* theta, const float* beta, const int32_t* iu,
                          const int32_t* ii, float* out, double* partials, int64_t n, int32_t k,
                          int64_t per_warp, int64_t nblocks, void* stream) {
  return hpf::launch_predict_pairs(theta, beta, iu, ii, out, partials, n, k, per_warp, nblocks,
                                   (cudaStream_t)stream);
}

int hpf_predict_pairs_f64(const double* theta, const double* beta, const int32_t* iu,
                          const int32_t* ii, double* out, double* partials, int64_t n,
                          int32_t k, int64_t per_warp, int64_t nblocks, void* stream) {
  return hpf::launch_predict_pairs(theta, beta, iu, ii, out, partials, n, k, per_warp, nblocks,
                                   (cudaStream_t)stream);
}

int hpf_theta_diff_f32(const float* a, const float* b, double* partials, int64_t n,
                       int32_t nblocks, void* stream) {
  return hpf::launch_theta_diff(a, b, partials, n, nblocks, (cudaStream_t)stream);
}

int hpf_theta_diff_f64(const double* a, const double* b, double* partials, int64_t n,
                       int32_t nblocks, void* stream) {
  return hpf::launch_theta_diff(a, b, partials, n, nblocks, (cudaStream_t)stream);
}

int hpf_rowsum_dot_f32(const float* theta, const float* beta, const int32_t* iu,
                       const int32_t* ii, double* partials, int64_t n, int32_t k,
                       int32_t nblocks, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_rowsum_dot, theta, beta, iu, ii, partials, n, k, nblocks,
                   (cudaStream_t)stream);
}

int hpf_rowsum_dot_f64(const double* theta, const double* beta, const int32_t* iu,
                       const int32_t* ii, double* partials, int64_t n, int32_t k,
                       int32_t nblocks, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_rowsum_dot, theta, beta, iu, ii, partials, n, k, nblocks,
                   (cudaStream_t)stream);
}

}  // extern "C"
