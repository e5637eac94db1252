// K1 — per-segment phi sums of one ELL bucket (the E-step).
//
// Replaces hpfrec_tpu/ops/ell.py:_bucket_phi_sums (driven by
// all_bucket_sums and ell_phi_sums).  For segment r of an (m, w) bucket:
//   out[r] = sum_j vals[r,j] * s (.) o_j / <s, o_j>,
//   s = t_self[rows[r]],  o_j = t_other[col_off + cols[r,j]],
// with a slot contributing 0 when <s, o_j> <= 0 (ell.py:522).  Slots with
// vals == 0 (padding) contribute exactly 0 and are skipped.
//
// What bounds it on the card: the gather of o_j, one random row of
// t_other (k * sizeof(T) bytes) per slot; everything else is a few flops
// per element.  At k = 50 in float32 that is 200 bytes per slot against
// ~4 flops per byte, far under the H100's compute-to-bandwidth ratio, so
// the kernel is bound by device-memory latency and bandwidth of scattered
// 200-byte rows.
//
// Design: a group of WPS warps per segment (WPS = 1, 2, 4 or 8, chosen per
// bucket by the wrapper from w), 256-thread blocks.  Each warp loads s
// once into registers (KPL elements per lane), then walks its share of the
// slots 4 at a time: the 4 row gathers are issued before any of their
// shuffle reductions, so each warp keeps 4 independent row loads in
// flight.  A row of t_other is read by consecutive lanes at consecutive
// addresses (coalesced).  A warp's slot walk is a chain of dependent loads
// (cols, then the row), so a 8192-slot segment on one warp is a long
// serial tail; WPS warps split it (warp s takes slot groups s, s + WPS,
// ...) and add their partial sums through shared memory in warp order.
// Accumulation is in the JAX version's accumulation dtype: the table type
// for float32 and float64 tables; for bfloat16 tables (gather_dtype=
// 'bfloat16', ell.py:476, 519-524) rows are widened to float32 as they are
// loaded, vals (float32 or float64) are rounded to float32, and the sums are
// float32.  One launch per bucket; no atomics, so the result is
// bit-identical run to run.
#include "common.cuh"

namespace hpf {

constexpr int kSlotUnroll = 4;

// TT: table storage, V: vals, T: arithmetic and output.
template <int KPL, typename TT, typename V, typename T>
__global__ void __launch_bounds__(kThreads)
    ell_phi_sums_kernel(const TT* __restrict__ t_self, const TT* __restrict__ t_other,
                        const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                        const V* __restrict__ vals, T* __restrict__ out, int64_t m, int w, int k,
                        int64_t col_off, int wps) {
  __shared__ T red[kWarpsPerBlock][kWarp * KPL];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int sub = warp % wps;  // this warp's share of the segment's slots
  const int64_t seg = (int64_t)blockIdx.x * (kWarpsPerBlock / wps) + warp / wps;
  const bool active = seg < m;  // uniform over the warp

  T acc[KPL];
#pragma unroll
  for (int q = 0; q < KPL; ++q) acc[q] = T(0);

  if (active) {
    const TT* srow = t_self + (int64_t)rows[seg] * k;
    T s[KPL];
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int c = lane + kWarp * q;
      s[q] = c < k ? widen<T>(srow[c]) : T(0);
    }
    const int64_t base = seg * (int64_t)w;
    for (int j0 = sub * kSlotUnroll; j0 < w; j0 += wps * kSlotUnroll) {
      T v[kSlotUnroll], d[kSlotUnroll], p[kSlotUnroll][KPL];
#pragma unroll
      for (int u = 0; u < kSlotUnroll; ++u) {
        const int j = j0 + u;
        v[u] = j < w ? (T)vals[base + j] : T(0);
        d[u] = T(0);
        const TT* orow = t_other + ((int64_t)(v[u] != T(0) ? cols[base + j] : 0) + col_off) * k;
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          const int c = lane + kWarp * q;
          p[u][q] = (v[u] != T(0) && c < k) ? s[q] * widen<T>(orow[c]) : T(0);
          d[u] += p[u][q];
        }
      }
#pragma unroll
      for (int u = 0; u < kSlotUnroll; ++u) d[u] = warp_sum(d[u]);
#pragma unroll
      for (int u = 0; u < kSlotUnroll; ++u) {
        if (v[u] != T(0) && d[u] > T(0)) {
          const T scale = v[u] / d[u];
#pragma unroll
          for (int q = 0; q < KPL; ++q) acc[q] += scale * p[u][q];
        }
      }
    }
  }

  if (wps > 1) {  // add the group's partial sums in warp order
#pragma unroll
    for (int q = 0; q < KPL; ++q) red[warp][lane + kWarp * q] = acc[q];
    __syncthreads();
    if (sub != 0) return;
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      T a = red[warp][lane + kWarp * q];
      for (int t = 1; t < wps; ++t) a += red[warp + t][lane + kWarp * q];
      acc[q] = a;
    }
  }
  if (!active) return;
  T* orow = out + seg * k;
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int c = lane + kWarp * q;
    if (c < k) orow[c] = acc[q];
  }
}

template <int KPL, typename TT, typename V, typename T>
cudaError_t launch_phi(const TT* t_self, const TT* t_other, const int32_t* rows,
                       const int32_t* cols, const V* vals, T* out, int64_t m, int w, int k,
                       int64_t col_off, int wps, cudaStream_t stream) {
  if (m <= 0) return cudaSuccess;
  if (wps != 1 && wps != 2 && wps != 4 && wps != 8) return cudaErrorInvalidValue;
  const int64_t per_block = kWarpsPerBlock / wps;
  const int64_t blocks = (m + per_block - 1) / per_block;
  ell_phi_sums_kernel<KPL, TT, V, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      t_self, t_other, rows, cols, vals, out, m, w, k, col_off, wps);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_ell_phi_sums_f32(const float* t_self, const float* t_other, const int32_t* rows,
                         const int32_t* cols, const float* vals, float* out, int64_t m, int32_t w,
                         int32_t k, int64_t col_off, int32_t wps, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_phi, t_self, t_other, rows, cols, vals, out, m, w, k, col_off,
                   wps, (cudaStream_t)stream);
}

int hpf_ell_phi_sums_f64(const double* t_self, const double* t_other, const int32_t* rows,
                         const int32_t* cols, const double* vals, double* out, int64_t m,
                         int32_t w, int32_t k, int64_t col_off, int32_t wps, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_phi, t_self, t_other, rows, cols, vals, out, m, w, k, col_off,
                   wps, (cudaStream_t)stream);
}

// bfloat16 tables; vals in the state dtype; float32 sums
int hpf_ell_phi_sums_bf16_f32(const __nv_bfloat16* t_self, const __nv_bfloat16* t_other,
                              const int32_t* rows, const int32_t* cols, const float* vals,
                              float* out, int64_t m, int32_t w, int32_t k, int64_t col_off,
                              int32_t wps, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_phi, t_self, t_other, rows, cols, vals, out, m, w, k, col_off,
                   wps, (cudaStream_t)stream);
}

int hpf_ell_phi_sums_bf16_f64(const __nv_bfloat16* t_self, const __nv_bfloat16* t_other,
                              const int32_t* rows, const int32_t* cols, const double* vals,
                              float* out, int64_t m, int32_t w, int32_t k, int64_t col_off,
                              int32_t wps, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_phi, t_self, t_other, rows, cols, vals, out, m, w, k, col_off,
                   wps, (cudaStream_t)stream);
}

const char* hpf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
