// K3 — per-side table update of a CAVI iteration.
//
// Replaces hpfrec_tpu/ops/cavi.py:exp_elog_tables fused with the table
// math of hpfrec_tpu/ops/ell.py:cavi_step_ell_carried (ell.py:795-812) and
// with _carry_init (ell.py:743).  Per row r of one side:
//   update form:  shp = prior + sums[r];  rte = scaler_shape / scaler_old[r]
//                 + colsum_other;  scaler_new[r] = add_scaler + rowsum(mean),
//                 or 0 for r >= n_real (the pad-row form below)
//   derive form:  shp, rte given
//   both:         mean = shp / rte;  tab = exp(digamma(shp) - log(rte) -
//                 rowmax), a non-finite rowmax set to 0 (cavi.py:61-68);
//                 colsum(mean) as per-block partials
// colsum_finish adds the partials over blocks in block order.  With
// gather_dtype='bfloat16' (ell.py:752-754, 804-806) tab is stored in
// bfloat16 (narrow() in common.cuh: float64 rounds through float32, as the
// frameworks' conversions do); shp, rte, the scaler and the colsums stay in
// the state dtype.
//
// Pad-row form (the table-sharded engine, replacing the row-masked scaler
// update of hpfrec_tpu/parallel/table_sharded.py:432-433): a rank's table
// rows at or past n_real are padding, the tail of its rows, and write
// scaler 0.  A pad row enters with shp 1, rte +inf and scaler 0, so its
// next rate is scaler_shape / 0 = +inf, its mean shp / inf = +0.0 and its
// tab exp(-inf - 0) = +0.0 (the non-finite rowmax set to 0): it adds
// exactly nothing to any colsum or phi sum, and writing scaler 0 keeps
// that true for the next iteration.  This needs IEEE division and logf
// (no --use_fast_math).  n_real = n is the plain update form.
//
// What bounds it on the card: one streaming pass over the side's tables
// (read sums or shp+rte, write shp, rte and tab: 16-20 bytes per element
// in float32) plus a digamma, a log and an exp per element, about 40
// flops per element in float32 — bandwidth-bound at float32, and close to
// the float64 unit's limit at float64.
//
// Design: one warp per row, KPL = ceil(k/32) elements per lane in
// registers; the row max and row sum are shuffle reductions.  A fixed grid
// of at most 1024 blocks walks the rows grid-stride, each warp adding its
// rows' means into registers; the 8 warps of a block then add theirs in
// warp order through shared memory into one (k,) partial per block, and
// colsum_finish adds those in block order.  The update form writes new
// buffers and reads scaler_old before scaler_new exists, so it can never
// read a value it wrote.  No atomics: colsums are bit-identical run to
// run.  CUDA has no digamma; common.cuh has one for float and double.
#include "common.cuh"

namespace hpf {

template <int KPL, bool UPDATE, typename T, typename TabT>
__global__ void __launch_bounds__(kThreads)
    table_kernel(const T* __restrict__ a_in, const T* __restrict__ b_in,
                 const T* __restrict__ colsum_other, T prior, T scaler_shape, T add_scaler,
                 T* __restrict__ shp_out, T* __restrict__ rte_out, TabT* __restrict__ tab_out,
                 T* __restrict__ scaler_out, T* __restrict__ partials, int64_t n,
                 int64_t n_real, int k) {
  __shared__ T red[kWarpsPerBlock][kWarp * KPL];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;

  T col[KPL], cso[KPL];
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int c = lane + kWarp * q;
    col[q] = T(0);
    cso[q] = (UPDATE && c < k) ? colsum_other[c] : T(0);
  }

  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + warp; r < n; r += stride) {
    const int64_t off = r * k;
    const T rate_base = UPDATE ? scaler_shape / b_in[r] : T(0);
    T shp[KPL], rte[KPL], elog[KPL];
    T rowsum = T(0), mx = T(-INFINITY);
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int c = lane + kWarp * q;
      elog[q] = T(-INFINITY);
      if (c < k) {
        if (UPDATE) {
          shp[q] = prior + a_in[off + c];
          rte[q] = rate_base + cso[q];
        } else {
          shp[q] = a_in[off + c];
          rte[q] = b_in[off + c];
        }
        const T mean = shp[q] / rte[q];
        rowsum += mean;
        col[q] += mean;
        elog[q] = digamma(shp[q]) - dlog(rte[q]);
        mx = elog[q] > mx ? elog[q] : mx;
      }
    }
    mx = warp_max(mx);
    if (!isfinite(mx)) mx = T(0);
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int c = lane + kWarp * q;
      if (c < k) {
        tab_out[off + c] = narrow<TabT>(dexp(elog[q] - mx));
        if (UPDATE) {
          shp_out[off + c] = shp[q];
          rte_out[off + c] = rte[q];
        }
      }
    }
    if (UPDATE) {
      rowsum = warp_sum(rowsum);
      if (lane == 0) scaler_out[r] = r < n_real ? add_scaler + rowsum : T(0);
    }
  }

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

// colsum[c] = sum over blocks of partials[b, c]: one warp per column, lane
// l adds blocks l, l + 32, ... in order, then a shuffle reduction.
template <typename T>
__global__ void colsum_finish_kernel(const T* __restrict__ partials, T* __restrict__ colsum,
                                     int nblocks, int k) {
  const int c = blockIdx.x;
  T s = T(0);
  for (int b = threadIdx.x; b < nblocks; b += kWarp) s += partials[(int64_t)b * k + c];
  s = warp_sum(s);
  if (threadIdx.x == 0) colsum[c] = s;
}

template <int KPL, typename T, typename TabT>
cudaError_t launch_update(const T* sums, const T* scaler_old, const T* colsum_other, double prior,
                          double scaler_shape, double add_scaler, T* shp, T* rte, TabT* tab,
                          T* scaler_new, T* partials, int64_t n, int64_t n_real, int k,
                          int nblocks, cudaStream_t stream) {
  if (nblocks <= 0 || n_real < 0 || n_real > n) return cudaErrorInvalidValue;
  table_kernel<KPL, true, T, TabT><<<nblocks, kThreads, 0, stream>>>(
      sums, scaler_old, colsum_other, (T)prior, (T)scaler_shape, (T)add_scaler, shp, rte, tab,
      scaler_new, partials, n, n_real, k);
  return cudaGetLastError();
}

template <int KPL, typename T, typename TabT>
cudaError_t launch_derive(const T* shp, const T* rte, TabT* tab, T* partials, int64_t n, int k,
                          int nblocks, cudaStream_t stream) {
  if (nblocks <= 0) return cudaErrorInvalidValue;
  table_kernel<KPL, false, T, TabT><<<nblocks, kThreads, 0, stream>>>(
      shp, rte, nullptr, T(0), T(0), T(0), nullptr, nullptr, tab, nullptr, partials, n, n, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_finish(const T* partials, T* colsum, int nblocks, int k, cudaStream_t stream) {
  if (k <= 0 || nblocks <= 0) return cudaErrorInvalidValue;
  colsum_finish_kernel<T><<<k, kWarp, 0, stream>>>(partials, colsum, nblocks, k);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_table_update_f32(const float* sums, const float* scaler_old, const float* colsum_other,
                         double prior, double scaler_shape, double add_scaler, float* shp,
                         float* rte, float* tab, float* scaler_new, float* partials, int64_t n,
                         int64_t n_real, int32_t k, int32_t nblocks, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_update, sums, scaler_old, colsum_other, prior, scaler_shape,
                   add_scaler, shp, rte, tab, scaler_new, partials, n, n_real, k, nblocks,
                   (cudaStream_t)stream);
}

int hpf_table_update_f64(const double* sums, const double* scaler_old,
                         const double* colsum_other, double prior, double scaler_shape,
                         double add_scaler, double* shp, double* rte, double* tab,
                         double* scaler_new, double* partials, int64_t n, int64_t n_real,
                         int32_t k, int32_t nblocks, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_update, sums, scaler_old, colsum_other, prior, scaler_shape,
                   add_scaler, shp, rte, tab, scaler_new, partials, n, n_real, k, nblocks,
                   (cudaStream_t)stream);
}

int hpf_table_derive_f32(const float* shp, const float* rte, float* tab, float* partials,
                         int64_t n, int32_t k, int32_t nblocks, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_derive, shp, rte, tab, partials, n, k, nblocks,
                   (cudaStream_t)stream);
}

int hpf_table_derive_f64(const double* shp, const double* rte, double* tab, double* partials,
                         int64_t n, int32_t k, int32_t nblocks, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_derive, shp, rte, tab, partials, n, k, nblocks,
                   (cudaStream_t)stream);
}

// bfloat16 tab, everything else in the state dtype
int hpf_table_update_bf16_f32(const float* sums, const float* scaler_old,
                              const float* colsum_other, double prior, double scaler_shape,
                              double add_scaler, float* shp, float* rte, __nv_bfloat16* tab,
                              float* scaler_new, float* partials, int64_t n, int64_t n_real,
                              int32_t k, int32_t nblocks, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_update, sums, scaler_old, colsum_other, prior, scaler_shape,
                   add_scaler, shp, rte, tab, scaler_new, partials, n, n_real, k, nblocks,
                   (cudaStream_t)stream);
}

int hpf_table_update_bf16_f64(const double* sums, const double* scaler_old,
                              const double* colsum_other, double prior, double scaler_shape,
                              double add_scaler, double* shp, double* rte, __nv_bfloat16* tab,
                              double* scaler_new, double* partials, int64_t n, int64_t n_real,
                              int32_t k, int32_t nblocks, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_update, sums, scaler_old, colsum_other, prior, scaler_shape,
                   add_scaler, shp, rte, tab, scaler_new, partials, n, n_real, k, nblocks,
                   (cudaStream_t)stream);
}

int hpf_table_derive_bf16_f32(const float* shp, const float* rte, __nv_bfloat16* tab,
                              float* partials, int64_t n, int32_t k, int32_t nblocks,
                              void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_derive, shp, rte, tab, partials, n, k, nblocks,
                   (cudaStream_t)stream);
}

int hpf_table_derive_bf16_f64(const double* shp, const double* rte, __nv_bfloat16* tab,
                              double* partials, int64_t n, int32_t k, int32_t nblocks,
                              void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_derive, shp, rte, tab, partials, n, k, nblocks,
                   (cudaStream_t)stream);
}

int hpf_colsum_finish_f32(const float* partials, float* colsum, int32_t nblocks, int32_t k,
                          void* stream) {
  return hpf::launch_finish(partials, colsum, nblocks, k, (cudaStream_t)stream);
}

int hpf_colsum_finish_f64(const double* partials, double* colsum, int32_t nblocks, int32_t k,
                          void* stream) {
  return hpf::launch_finish(partials, colsum, nblocks, k, (cudaStream_t)stream);
}

}  // extern "C"
