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
// 200-byte rows.  At the MillionSong shape the item side gathers Theta
// (1,019,318 x 50 float32 = 204 MB, four times the L2) from HBM: 38.7M
// rows of seven 32-byte sectors, ~8.7 GB, ~2.6 ms at 3.35 TB/s.
//
// Design: a group of WPS warps per segment (WPS = 1, 2, 4 or 8, chosen per
// bucket by the wrapper from w), 256-thread blocks.  Each warp loads s
// once into registers (KPL elements per lane), then walks its share of the
// slots 32 at a time: lane l loads slot g0 + l's vals and cols with one
// coalesced load (the next 32 slots' are loaded while this group's rows
// are added), and a ballot on vals != 0 gives the slots to visit, so
// padding costs no row gather wherever it starts.  The set slots are taken
// G at a time in slot order (G = 8, or 4 where eight rows of KPL elements
// would not fit: float64 at k > 128): their cols are handed out by
// shuffles and all G row gathers are issued before any arithmetic on them,
// so each warp keeps G independent row loads in flight (the walk was a
// chain of three dependent loads a slot, vals, cols, row, four slots at a
// time).  The G dots are added over the lanes at once (transposed_sums:
// ~9 shuffles for eight dots, not 40), each lane divides one slot's value
// by its dot, and the scales are handed out by shuffles; the bits are
// warp_sum's and the division's as before.  A row of t_other is read by
// consecutive lanes at consecutive addresses (coalesced).  WPS warps split
// a wide segment by 32-slot groups (warp s takes groups s, s + WPS, ...)
// and add their partial sums through shared memory in warp order.
// Accumulation is in the JAX version's accumulation dtype: the table type
// for float32 and float64 tables; for bfloat16 tables (gather_dtype=
// 'bfloat16', ell.py:476, 519-524) rows are widened to float32 as they are
// loaded, vals (float32 or float64) are rounded to float32, and the sums are
// float32.  A segment's slots are added in slot order (with WPS = 1 the
// walk adds exactly what the four-slot walk added, in the same order).
//
// Launches: ell_phi_sums_all_kernel runs every bucket of a side in one
// launch, from a device table of bucket descriptors (the wrapper builds it
// once per layout, buckets with the longest walk a warp first), so the
// short buckets fill the card while the long ones run; with one launch per
// bucket (49 an iteration at the MillionSong shape) each bucket's last,
// partial wave idled the card.  The table-sharded ring launches it once a
// ring offset, from a table of that offset's buckets, each with its
// sub-tile's column base, writing their segments into the rank's sums.
// ell_phi_sums_kernel runs one bucket (the same walk; the card tests hold
// the two launch forms to the same bits).  No atomics, so the result is
// bit-identical run to run.  Registers (ptxas, sm_90a, -O3, KPL = 2 float32): see
// the build log of -Xptxas -v; no kernel here spills at any KPL.
#include "common.cuh"

namespace hpf {

constexpr unsigned kFullMask = 0xffffffffu;

// The phi sums of segment ``seg`` of an (m, w) bucket by the WPS warps of
// one block that share it (``sub`` = this warp's share); every thread of
// the block calls it (it synchronizes the block when WPS > 1).
template <int KPL, typename TT, typename V, typename T>
__device__ __forceinline__ void segment_phi_sums(
    const TT* __restrict__ t_self, const TT* __restrict__ t_other,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
    const V* __restrict__ vals, T* __restrict__ out, int64_t seg, int64_t m, int w, int k,
    int64_t col_off, int wps, T (*red)[kWarp * KPL]) {
  // row gathers in flight a warp: 8, or 4 where 8 rows would take more
  // than 128 registers (float64 at KPL = 8)
  constexpr int G = KPL * sizeof(T) > 32 ? 4 : 8;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int sub = warp % wps;  // this warp's share of the segment's slots
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
    constexpr int kOwn = kWarp / G;  // lanes that hold one slot's dot
    const int own = lane / kOwn;     // the round's slot this lane's dot is
    int g0 = sub * kWarp;
    T my_v = g0 + lane < w ? (T)vals[base + g0 + lane] : T(0);
    int32_t my_c = g0 + lane < w ? cols[base + g0 + lane] : 0;
    for (; g0 < w; g0 += wps * kWarp) {
      const int j1 = g0 + wps * kWarp + lane;
      const T nx_v = j1 < w ? (T)vals[base + j1] : T(0);
      const int32_t nx_c = j1 < w ? cols[base + j1] : 0;
      unsigned pend = __ballot_sync(kFullMask, my_v != T(0));  // the slots to visit
      while (pend != 0u) {  // uniform
        int src[G], own_src = -1;  // the round's slots; this lane's one
#pragma unroll
        for (int u = 0; u < G; ++u) {
          src[u] = pend != 0u ? __ffs(pend) - 1 : -1;
          pend &= pend - 1u;
          if (u == own) own_src = src[u];
        }
        T d[G], p[G][KPL];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const bool ok = src[u] >= 0;
          const int32_t col = __shfl_sync(kFullMask, my_c, ok ? src[u] : 0);
          const TT* orow = t_other + ((int64_t)(ok ? col : 0) + col_off) * k;
          d[u] = T(0);
#pragma unroll
          for (int q = 0; q < KPL; ++q) {
            const int c = lane + kWarp * q;
            p[u][q] = (ok && c < k) ? s[q] * widen<T>(orow[c]) : T(0);
            d[u] += p[u][q];
          }
        }
        // one division a lane: the scale of the slot whose dot it holds
        const T dot = transposed_sums<G, T>(d, lane);
        const T v = __shfl_sync(kFullMask, my_v, own_src >= 0 ? own_src : 0);
        const bool good = own_src >= 0 && dot > T(0);
        const T scale = good ? v / dot : T(0);
        const unsigned use = __ballot_sync(kFullMask, good);
#pragma unroll
        for (int u = 0; u < G; ++u) {
          if ((use >> (u * kOwn)) & 1u) {
            const T su = __shfl_sync(kFullMask, scale, u * kOwn);
#pragma unroll
            for (int q = 0; q < KPL; ++q) acc[q] += su * p[u][q];
          }
        }
      }
      my_v = nx_v;
      my_c = nx_c;
    }
  }

  if (wps > 1) {  // add the group's partial sums in warp order
#pragma unroll
    for (int q = 0; q < KPL; ++q) red[warp][lane + kWarp * q] = acc[q];
    __syncthreads();
    if (sub == 0) {
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        T a = red[warp][lane + kWarp * q];
        for (int t = 1; t < wps; ++t) a += red[warp + t][lane + kWarp * q];
        acc[q] = a;
      }
    }
    __syncthreads();  // the block's warps leave together (measured the faster form)
    if (sub != 0) return;
  }
  if (!active) return;
  T* orow = out + seg * k;
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int c = lane + kWarp * q;
    if (c < k) orow[c] = acc[q];
  }
}

// One bucket: segment blockIdx.x * (8 / wps) + warp / wps.
template <int KPL, typename TT, typename V, typename T>
__global__ void __launch_bounds__(kThreads)
    ell_phi_sums_kernel(const TT* __restrict__ t_self, const TT* __restrict__ t_other,
                        const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                        const V* __restrict__ vals, T* __restrict__ out, int64_t m, int w, int k,
                        int64_t col_off, int wps) {
  __shared__ T red[kWarpsPerBlock][kWarp * KPL];
  const int64_t seg =
      (int64_t)blockIdx.x * (kWarpsPerBlock / wps) + (threadIdx.x / kWarp) / wps;
  segment_phi_sums<KPL, TT, V, T>(t_self, t_other, rows, cols, vals, out, seg, m, w, k,
                                  col_off, wps, red);
}

// A bucket of a side, as ops/ell.py:_bucket_table writes it (int64 fields):
// its arrays, the position of its first segment in the side's sums, its
// shape, column base offset and warps per segment, and its first block.
struct EllBucketDesc {
  int64_t rows, cols, vals, out0, m, col_off, w, wps, block0;
};

// Every bucket of a side: block b runs the bucket whose block range holds
// it (a binary search over the table's ascending block0).
template <int KPL, typename TT, typename V, typename T>
__global__ void __launch_bounds__(kThreads)
    ell_phi_sums_all_kernel(const TT* __restrict__ t_self, const TT* __restrict__ t_other,
                            const EllBucketDesc* __restrict__ table, int nb,
                            T* __restrict__ out, int k) {
  __shared__ T red[kWarpsPerBlock][kWarp * KPL];
  const int64_t block = blockIdx.x;
  int lo = 0, hi = nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].block0 <= block) lo = mid;
    else hi = mid - 1;
  }
  const EllBucketDesc d = table[lo];
  const int wps = (int)d.wps;
  const int64_t seg = (block - d.block0) * (kWarpsPerBlock / wps) + (threadIdx.x / kWarp) / wps;
  segment_phi_sums<KPL, TT, V, T>(t_self, t_other, (const int32_t*)d.rows,
                                  (const int32_t*)d.cols, (const V*)d.vals, out + d.out0 * k,
                                  seg, d.m, (int)d.w, k, d.col_off, wps, red);
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

template <int KPL, typename TT, typename V, typename T>
cudaError_t launch_phi_all(const TT* t_self, const TT* t_other, const int64_t* table, int nb,
                           int64_t blocks, const V*, T* out, int k, cudaStream_t stream) {
  if (nb <= 0 || blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ell_phi_sums_all_kernel<KPL, TT, V, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      t_self, t_other, (const EllBucketDesc*)table, nb, out, k);
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

// Every bucket of a side in one launch: table (nb, 9) int64 on the device
// (EllBucketDesc), blocks the sum of the buckets' blocks; out (n_segs, k).
int hpf_ell_phi_sums_all_f32(const float* t_self, const float* t_other, const int64_t* table,
                             int32_t nb, int64_t blocks, float* out, int32_t k, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_phi_all, t_self, t_other, table, nb, blocks,
                   (const float*)nullptr, out, k, (cudaStream_t)stream);
}

int hpf_ell_phi_sums_all_f64(const double* t_self, const double* t_other, const int64_t* table,
                             int32_t nb, int64_t blocks, double* out, int32_t k, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_phi_all, t_self, t_other, table, nb, blocks,
                   (const double*)nullptr, out, k, (cudaStream_t)stream);
}

// bfloat16 tables; vals (in the table) of the state dtype; float32 sums
int hpf_ell_phi_sums_all_bf16_f32(const __nv_bfloat16* t_self, const __nv_bfloat16* t_other,
                                  const int64_t* table, int32_t nb, int64_t blocks, float* out,
                                  int32_t k, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_phi_all, t_self, t_other, table, nb, blocks,
                   (const float*)nullptr, out, k, (cudaStream_t)stream);
}

int hpf_ell_phi_sums_all_bf16_f64(const __nv_bfloat16* t_self, const __nv_bfloat16* t_other,
                                  const int64_t* table, int32_t nb, int64_t blocks, float* out,
                                  int32_t k, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_phi_all, t_self, t_other, table, nb, blocks,
                   (const double*)nullptr, out, k, (cudaStream_t)stream);
}

const char* hpf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
