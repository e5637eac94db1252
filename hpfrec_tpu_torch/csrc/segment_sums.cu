// K2 — reassemble per-segment phi sums into table order.
//
// Replaces hpfrec_tpu/ops/ell.py:segment_table_sums: out = seg[inv_perm],
// then out[split_rows] += sum_p seg[split_seg_pos[:, p]] with position -1
// contributing nothing (ell.py:352-379, 574-587).  split_rows repeats a
// row once per chunk of P positions; here the chunks of row r are the
// contiguous range [split_indptr[r], split_indptr[r + 1]) of
// split_seg_pos, a per-row CSR built on the host at upload.
//
// With bfloat16 gather tables under a float64 state, K1's segment sums are
// float32: the sums are taken in float32 and written as float64, the cast
// of ell.py:726-727 after the reassembly.
//
// What bounds it on the card: moving (n_rows + n_split_segments) rows of
// k values; a pure memory pass with no arithmetic to speak of.
//
// Design: one warp per table row, lanes over the k columns (coalesced).
// Each row adds its split chunks in chunk order, each chunk's P positions
// in order, so no float atomics are needed and runs are bit-identical
// (the reference contract for a fixed seed, dtype and layout).
#include "common.cuh"

namespace hpf {

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
    segment_table_sums_kernel(const T* __restrict__ seg, const int32_t* __restrict__ inv_perm,
                              const int32_t* __restrict__ split_indptr,
                              const int32_t* __restrict__ split_seg_pos, O* __restrict__ out,
                              int64_t n, int k, int P) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (row >= n) return;
  const int64_t first = inv_perm[row];
  const int c0 = split_indptr[row];
  const int c1 = split_indptr[row + 1];
  for (int c = lane; c < k; c += kWarp) {
    T a = seg[first * k + c];
    for (int ch = c0; ch < c1; ++ch) {
      T e = T(0);
      for (int p = 0; p < P; ++p) {
        const int32_t pos = split_seg_pos[(int64_t)ch * P + p];
        if (pos >= 0) e += seg[(int64_t)pos * k + c];
      }
      a += e;
    }
    out[row * k + c] = (O)a;
  }
}

template <typename T, typename O>
cudaError_t launch_segment_sums(const T* seg, const int32_t* inv_perm, const int32_t* split_indptr,
                                const int32_t* split_seg_pos, O* out, int64_t n, int k, int P,
                                cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (k <= 0 || P <= 0) return cudaErrorInvalidValue;
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_table_sums_kernel<T, O><<<(unsigned)blocks, kThreads, 0, stream>>>(
      seg, inv_perm, split_indptr, split_seg_pos, out, n, k, P);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_segment_table_sums_f32(const float* seg, const int32_t* inv_perm,
                               const int32_t* split_indptr, const int32_t* split_seg_pos,
                               float* out, int64_t n, int32_t k, int32_t P, void* stream) {
  return hpf::launch_segment_sums(seg, inv_perm, split_indptr, split_seg_pos, out, n, k, P,
                                  (cudaStream_t)stream);
}

int hpf_segment_table_sums_f64(const double* seg, const int32_t* inv_perm,
                               const int32_t* split_indptr, const int32_t* split_seg_pos,
                               double* out, int64_t n, int32_t k, int32_t P, void* stream) {
  return hpf::launch_segment_sums(seg, inv_perm, split_indptr, split_seg_pos, out, n, k, P,
                                  (cudaStream_t)stream);
}

// float32 segment sums written as float64
int hpf_segment_table_sums_f32_f64(const float* seg, const int32_t* inv_perm,
                                   const int32_t* split_indptr, const int32_t* split_seg_pos,
                                   double* out, int64_t n, int32_t k, int32_t P, void* stream) {
  return hpf::launch_segment_sums(seg, inv_perm, split_indptr, split_seg_pos, out, n, k, P,
                                  (cudaStream_t)stream);
}

}  // extern "C"
