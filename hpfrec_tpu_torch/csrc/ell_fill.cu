// K15 — a side's bucketed ELL layout filled from its CSR on the card.
//
// Replaces no kernel of hpfrec_tpu: the JAX package packs its layouts on
// the host (hpfrec_tpu/ops/ell.py:build_ell, numpy).  A fit on a card
// packs them here: the host plans the layout from the side's row degrees
// (ops/ell.py:plan_ell: the segments, the width ladder and its merges, the
// buckets' sizes) and this kernel writes every bucket's (m, w) cols and
// vals, padding included, into one slab of each that the buckets view,
// from the CSR the card sorted (ops/ingest.py).  On a mesh a rank writes
// its slice of every bucket, whose padding segments have no entries.  One
// launch a side.
//
// Segment s (in layout order, bucket after bucket) belongs to the last
// bucket b whose first segment is at or before s (a binary search over the
// bucket table, a few dozen rows, the same for a warp); it starts at slot
// base[b] + (s - first[b]) * w[b] of the slabs and copies seg_len[s]
// entries from seg_src[s] of the CSR, then zeros to the width.  A warp
// takes a segment: its lanes write 32 consecutive slots a step, so each
// segment is one coalesced copy, reads and writes alike, and no slot is
// written twice.  What bounds it is the bytes: the CSR read once, the
// slabs written once.
#include "common.cuh"

namespace hpf {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ell_fill_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                    const int32_t* __restrict__ seg_src, const int32_t* __restrict__ seg_len,
                    const int64_t* __restrict__ btab, int nb, int64_t n_segs,
                    int32_t* __restrict__ out_cols, T* __restrict__ out_vals) {
  const int lane = threadIdx.x % kWarp;
  for (int64_t s = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp; s < n_segs;
       s += (int64_t)gridDim.x * kWarpsPerBlock) {
    int lo = 0, hi = nb - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (btab[3 * mid] <= s) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int64_t first = btab[3 * lo], w = btab[3 * lo + 2];
    const int64_t dst = btab[3 * lo + 1] + (s - first) * w;
    const int64_t src = seg_src[s];
    const int64_t len = seg_len[s];
    for (int64_t j = lane; j < w; j += kWarp) {
      const bool in = j < len;
      out_cols[dst + j] = in ? cols[src + j] : 0;
      out_vals[dst + j] = in ? vals[src + j] : (T)0;
    }
  }
}

template <typename T>
int launch_ell_fill(const int32_t* cols, const T* vals, const int32_t* seg_src,
                    const int32_t* seg_len, const int64_t* btab, int32_t nb, int64_t n_segs,
                    int32_t* out_cols, T* out_vals, cudaStream_t stream) {
  if (nb < 0 || n_segs < 0 || (n_segs > 0 && nb == 0)) return cudaErrorInvalidValue;
  if (n_segs == 0) return cudaSuccess;
  const int64_t blocks = (n_segs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int grid = blocks < (1 << 20) ? (int)blocks : (1 << 20);
  ell_fill_kernel<T><<<grid, kThreads, 0, stream>>>(cols, vals, seg_src, seg_len, btab, nb,
                                                     n_segs, out_cols, out_vals);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_ell_fill_f32(const int32_t* cols, const float* vals, const int32_t* seg_src,
                     const int32_t* seg_len, const int64_t* btab, int32_t nb, int64_t n_segs,
                     int32_t* out_cols, float* out_vals, void* stream) {
  return hpf::launch_ell_fill(cols, vals, seg_src, seg_len, btab, nb, n_segs, out_cols,
                              out_vals, (cudaStream_t)stream);
}

int hpf_ell_fill_f64(const int32_t* cols, const double* vals, const int32_t* seg_src,
                     const int32_t* seg_len, const int64_t* btab, int32_t nb, int64_t n_segs,
                     int32_t* out_cols, double* out_vals, void* stream) {
  return hpf::launch_ell_fill(cols, vals, seg_src, seg_len, btab, nb, n_segs, out_cols,
                              out_vals, (cudaStream_t)stream);
}

}  // extern "C"
