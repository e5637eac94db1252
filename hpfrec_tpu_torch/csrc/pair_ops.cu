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
//   rowsum_dot:       colsum(Theta[iu]) . colsum(Beta[ii]) in float64, one
//                     value on the device
// The host reads theta_diff's partials back and adds them in block order
// in float64 (a check's single readback, as K4 and K5 do).
//
// What bounds it on the card: predict_pairs and rowsum_dot gather two
// random k-wide rows per pair (2 k sizeof(T) bytes) for 2k flops, and
// theta_diff streams two (n, k) tables: all three are bound by bytes.
//
// Design: predict_pairs is the pair walk of pair_walk.cuh (a group of G
// lanes a pair, 8 at k = 50 float32; vector row loads; the next step's
// indices loaded ahead) over a run of a multiple of 32 pairs a warp, chosen
// from n (ops/metrics.py:_pairs_grid) so that 100,000 pairs make about 390
// blocks, three an SM, and 4M pairs about 1,024.  rowsum_dot walks the same
// steps on the same grid (pair_steps): each lane adds its group's rows into
// float64 sums of its slice of the k columns, a warp's groups add theirs by
// shuffles, the block its warps' in warp order into one (2k) partial row,
// and a second launch of one block adds the partial rows in block order
// (a fixed split of the blocks into ranges, the ranges then added in
// order) and takes the dot in float64: one value is copied back, not the
// partials.  theta_diff walks a fixed grid of at most 1024 blocks
// grid-stride; each block adds its 8 warps' sums in warp order.  The
// partition and the lane split depend only on n, k and the dtype, and
// there are no atomics, so every result is bit-identical from run to
// run.
#include "pair_walk.cuh"

namespace hpf {

constexpr int kMaxK = 256;  // hpfrec_tpu_torch/_cuda MAX_K

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

// Per block, the float64 column sums of Theta[iu] (partials[b][0, k)) and
// of Beta[ii] (partials[b][k, 2k)) of its warps' pairs.
template <typename T, int VE, int VPL>
__global__ void __launch_bounds__(kThreads)
    rowsum_cols_kernel(const T* __restrict__ theta, const T* __restrict__ beta,
                       const int32_t* __restrict__ iu, const int32_t* __restrict__ ii,
                       double* __restrict__ partials, int64_t n, int k, int log2g,
                       int64_t per_warp) {
  constexpr int U = pair_step_u<T, VE, VPL>();
  __shared__ double red[kWarpsPerBlock][2 * kMaxK];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int G = 1 << log2g;
  const int l = lane & (G - 1);
  const int nv = k / VE;
  const int64_t first = ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * per_warp;
  const int64_t last = first + per_warp < n ? first + per_warp : n;
  double ts[VPL][VE], bs[VPL][VE];  // this lane's columns (l + G q) * VE + e
#pragma unroll
  for (int q = 0; q < VPL; ++q) {
#pragma unroll
    for (int e = 0; e < VE; ++e) ts[q][e] = bs[q][e] = 0.0;
  }
  pair_steps<T, VE, VPL, false>(
      theta, beta, iu, ii, nullptr, first, last, k, log2g,
      [&](int64_t, const auto& t, const auto& b, const auto& ok, const auto&) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int q = 0; q < VPL; ++q) {
            if (ok[u] && l + G * q < nv) {
#pragma unroll
              for (int e = 0; e < VE; ++e) {
                ts[q][e] += (double)t[u][q].v[e];
                bs[q][e] += (double)b[u][q].v[e];
              }
            }
          }
        }
      });
  // lanes l, l + G, l + 2G, ... hold the same columns: add the groups'
#pragma unroll
  for (int q = 0; q < VPL; ++q) {
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      for (int o = G; o < kWarp; o <<= 1) {
        ts[q][e] += __shfl_xor_sync(0xffffffffu, ts[q][e], o);
        bs[q][e] += __shfl_xor_sync(0xffffffffu, bs[q][e], o);
      }
    }
  }
  if (lane < G) {
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int c = l + G * q;
      if (c < nv) {
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          red[warp][c * VE + e] = ts[q][e];
          red[warp][k + c * VE + e] = bs[q][e];
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * k; c += kThreads) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) s += red[w][c];
    partials[(int64_t)blockIdx.x * 2 * k + c] = s;
  }
}

constexpr int kFinishThreads = 1024;

// One block: the (nblocks, 2k) partial rows added over the blocks, then
// the dot of the two column sums, in float64, into out[0].  Column c gets
// R = kFinishThreads / 2k threads; thread r adds the blocks of range r (of
// R ranges of consecutive blocks) in block order, then the column's R
// range sums are added in range order.
__global__ void __launch_bounds__(kFinishThreads)
    rowsum_dot_finish_kernel(const double* __restrict__ partials, double* __restrict__ out,
                             int64_t nblocks, int k) {
  __shared__ double part[kFinishThreads];
  __shared__ double col[2 * kMaxK];
  const int cols = 2 * k;
  const int R = kFinishThreads / cols;
  const int c = threadIdx.x % cols, r = threadIdx.x / cols;
  const int64_t span = (nblocks + R - 1) / R;
  double s = 0.0;
  if (r < R) {
    const int64_t b1 = (r + 1) * span < nblocks ? (r + 1) * span : nblocks;
    for (int64_t b = r * span; b < b1; ++b) s += partials[b * cols + c];
  }
  part[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < cols) {
    double t = 0.0;
    for (int q = 0; q < R; ++q) t += part[q * cols + threadIdx.x];
    col[threadIdx.x] = t;
  }
  __syncthreads();
  if (threadIdx.x < kWarp) {
    double d = 0.0;
    for (int j = threadIdx.x; j < k; j += kWarp) d += col[j] * col[k + j];
    d = warp_sum(d);
    if (threadIdx.x == 0) out[0] = d;
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

template <typename T>
cudaError_t launch_rowsum_dot(const T* theta, const T* beta, const int32_t* iu,
                              const int32_t* ii, double* partials, double* out, int64_t n, int k,
                              int64_t per_warp, int64_t nblocks, cudaStream_t stream) {
  if (!pair_grid_ok(n, k, per_warp, nblocks, theta, beta, /*spare=*/true))
    return cudaErrorInvalidValue;
  const cudaError_t err = with_pair_form<T>(k, [&](auto ve, auto vpl, int log2g) {
    rowsum_cols_kernel<T, decltype(ve)::value, decltype(vpl)::value>
        <<<(unsigned)nblocks, kThreads, 0, stream>>>(theta, beta, iu, ii, partials, n, k, log2g,
                                                     per_warp);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  rowsum_dot_finish_kernel<<<1, kFinishThreads, 0, stream>>>(partials, out, nblocks, k);
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

// partials (nblocks, 2k) float64 scratch; out (1,) float64
int hpf_rowsum_dot_f32(const float* theta, const float* beta, const int32_t* iu,
                       const int32_t* ii, double* partials, double* out, int64_t n, int32_t k,
                       int64_t per_warp, int64_t nblocks, void* stream) {
  return hpf::launch_rowsum_dot(theta, beta, iu, ii, partials, out, n, k, per_warp, nblocks,
                                (cudaStream_t)stream);
}

int hpf_rowsum_dot_f64(const double* theta, const double* beta, const int32_t* iu,
                       const int32_t* ii, double* partials, double* out, int64_t n, int32_t k,
                       int64_t per_warp, int64_t nblocks, void* stream) {
  return hpf::launch_rowsum_dot(theta, beta, iu, ii, partials, out, n, k, per_warp, nblocks,
                                (cudaStream_t)stream);
}

}  // extern "C"
