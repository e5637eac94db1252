// K8 — the SVI natural-gradient blend of one mini-batch, and the batch's
// row mask.
//
// Replaces hpfrec_tpu/ops/svi.py:_svi_update_math (svi.py:49-115) and
// build_row_mask (svi.py:297-307).  The batch's "local" side is the side
// whose rows were sampled (users in a user epoch), the "global" side the
// other one.  Written per side, with (shp, rte, scaler, prior,
// scaler_shape, add_scaler) = (G_shp, G_rte, k_rte, a, k_shp, a'/b') for
// users and (L_shp, L_rte, t_rte, c, t_shp, c'/d') for items:
//   local pass, every row r of the local side:
//     rte = scaler_shape / scaler[r] + colsum(mean of the global side, old)
//     shp = (mask[r] ? prior : shp[r]) + sums[r]
//   global pass, every row r of the global side:
//     scat = (mask[r] ? prior : shp[r]) + sums[r]
//     mask[r]:  shp = step mult scat + (1 - step) shp[r]
//               rte = step (scaler_shape / scaler[r] + colsum(local mean,
//                     new)) + (1 - step) rte[r]
//     else:     shp = scat, rte = rte[r]
//   both passes:
//     new = step (add_scaler + rowsum(shp / rte)) + (1 - step) scaler[r]
//     scaler[r] = (mask[r] || blend_all) ? new : scaler[r]
// These are the reference's asymmetries, kept as they are: the local rate
// is rewritten for ALL rows, only the global side blends, and the scalers
// blend on masked rows only unless blend_all (partial_fit).  The global
// rate needs colsum of the NEW local means, so the local pass writes
// per-block colsum partials that K3's colsum_finish adds in block order
// before the global pass starts.  The old global colsum comes from K3's
// derive of the same batch.
//
// What bounds it on the card: bytes.  Each pass streams its side's tables
// once: reads shp, rte (global pass), sums, mask and scaler, writes shp,
// rte and scaler -- 16-20 bytes per element in float32 -- against ~10
// flops per element.
//
// Design: K3's layout -- one warp per row, k over the lanes (KPL elements
// per lane in registers), row sums by shuffle reduction, colsum partials
// from a fixed grid of at most 1024 blocks added in warp order and then in
// block order.  Outputs are new buffers, never the inputs, so a row is
// never read after it was written.  No atomics: every output is
// bit-identical run to run.  build_row_mask sets mask[rows[i]] = 1 on a
// zeroed mask (duplicates write the same byte).
#include "common.cuh"

namespace hpf {

template <int KPL, bool GLOBAL, typename T>
__global__ void __launch_bounds__(kThreads)
    svi_pass_kernel(const T* __restrict__ shp_in, const T* __restrict__ rte_in,
                    const T* __restrict__ sums, const uint8_t* __restrict__ mask,
                    const T* __restrict__ scaler_in, const T* __restrict__ colsum, T prior,
                    T scaler_shape, T add_scaler, T step, T mult, int blend_all,
                    T* __restrict__ shp_out, T* __restrict__ rte_out,
                    T* __restrict__ scaler_out, T* __restrict__ partials, int64_t n, int k) {
  __shared__ T red[kWarpsPerBlock][kWarp * KPL];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const T step_prev = T(1) - step;
  const T step_mult = step * mult;

  T col[KPL], cs[KPL];
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int c = lane + kWarp * q;
    col[q] = T(0);
    cs[q] = c < k ? colsum[c] : T(0);
  }

  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + warp; r < n; r += stride) {
    const int64_t off = r * k;
    const bool m = mask[r] != 0;
    const T s_old = scaler_in[r];
    const T base = scaler_shape / s_old;
    T rowsum = T(0);
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int c = lane + kWarp * q;
      if (c < k) {
        const T old = shp_in[off + c];
        const T scat = (m ? prior : old) + sums[off + c];
        T shp, rte;
        if constexpr (GLOBAL) {
          if (m) {
            shp = step_mult * scat + step_prev * old;
            rte = step * (base + cs[q]) + step_prev * rte_in[off + c];
          } else {
            shp = scat;
            rte = rte_in[off + c];
          }
        } else {
          shp = scat;
          rte = base + cs[q];
        }
        shp_out[off + c] = shp;
        rte_out[off + c] = rte;
        const T mean = shp / rte;
        rowsum += mean;
        if constexpr (!GLOBAL) col[q] += mean;
      }
    }
    rowsum = warp_sum(rowsum);
    if (lane == 0)
      scaler_out[r] = (m || blend_all) ? step * (add_scaler + rowsum) + step_prev * s_old : s_old;
  }

  if constexpr (!GLOBAL) {
#pragma unroll
    for (int q = 0; q < KPL; ++q) red[warp][lane + kWarp * q] = col[q];
    __syncthreads();
    for (int c = threadIdx.x; c < k; c += kThreads) {
      T s = T(0);
#pragma unroll
      for (int w = 0; w < kWarpsPerBlock; ++w) s += red[w][c];
      partials[(int64_t)blockIdx.x * k + c] = s;
    }
  }
}

__global__ void row_mask_kernel(const int32_t* __restrict__ rows, int64_t m,
                                uint8_t* __restrict__ mask) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride)
    mask[rows[i]] = 1;
}

template <int KPL, typename T>
cudaError_t launch_svi_pass(const T* shp_in, const T* rte_in, const T* sums, const uint8_t* mask,
                            const T* scaler_in, const T* colsum, double prior,
                            double scaler_shape, double add_scaler, double step, double mult,
                            int blend_all, int global, T* shp_out, T* rte_out, T* scaler_out,
                            T* partials, int64_t n, int k, int nblocks, cudaStream_t stream) {
  if (nblocks <= 0 || n <= 0) return cudaErrorInvalidValue;
  if (global) {
    svi_pass_kernel<KPL, true, T><<<nblocks, kThreads, 0, stream>>>(
        shp_in, rte_in, sums, mask, scaler_in, colsum, (T)prior, (T)scaler_shape,
        (T)add_scaler, (T)step, (T)mult, blend_all, shp_out, rte_out, scaler_out, nullptr, n, k);
  } else {
    svi_pass_kernel<KPL, false, T><<<nblocks, kThreads, 0, stream>>>(
        shp_in, nullptr, sums, mask, scaler_in, colsum, (T)prior, (T)scaler_shape,
        (T)add_scaler, (T)step, (T)mult, blend_all, shp_out, rte_out, scaler_out, partials, n,
        k);
  }
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_svi_pass_f32(const float* shp_in, const float* rte_in, const float* sums,
                     const uint8_t* mask, const float* scaler_in, const float* colsum,
                     double prior, double scaler_shape, double add_scaler, double step,
                     double mult, int32_t blend_all, int32_t global, float* shp_out,
                     float* rte_out, float* scaler_out, float* partials, int64_t n, int32_t k,
                     int32_t nblocks, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_svi_pass, shp_in, rte_in, sums, mask, scaler_in, colsum, prior,
                   scaler_shape, add_scaler, step, mult, blend_all, global, shp_out, rte_out,
                   scaler_out, partials, n, k, nblocks, (cudaStream_t)stream);
}

int hpf_svi_pass_f64(const double* shp_in, const double* rte_in, const double* sums,
                     const uint8_t* mask, const double* scaler_in, const double* colsum,
                     double prior, double scaler_shape, double add_scaler, double step,
                     double mult, int32_t blend_all, int32_t global, double* shp_out,
                     double* rte_out, double* scaler_out, double* partials, int64_t n, int32_t k,
                     int32_t nblocks, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_svi_pass, shp_in, rte_in, sums, mask, scaler_in, colsum, prior,
                   scaler_shape, add_scaler, step, mult, blend_all, global, shp_out, rte_out,
                   scaler_out, partials, n, k, nblocks, (cudaStream_t)stream);
}

int hpf_row_mask(const int32_t* rows, int64_t m, uint8_t* mask, void* stream) {
  if (m <= 0) return cudaSuccess;
  int64_t blocks = (m + hpf::kThreads - 1) / hpf::kThreads;
  if (blocks > 4096) blocks = 4096;
  hpf::row_mask_kernel<<<(unsigned)blocks, hpf::kThreads, 0, (cudaStream_t)stream>>>(rows, m,
                                                                                     mask);
  return cudaGetLastError();
}

}  // extern "C"
