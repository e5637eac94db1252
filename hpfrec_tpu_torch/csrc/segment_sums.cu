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
// k values, a pure memory pass.  All but a few rows are a permuted copy:
// a random row read (k * size bytes, 7-8 sectors of 32 bytes at k = 50
// float32) and a coalesced row write.
//
// Design: two passes, the second over every row.  (1) Over the split
// chunks only (730 at MillionSong, all on the item side): each chunk's sum
// of its P positions, flat over (chunk, vector) into a scratch table, so
// a heavy row's many chunks are summed in parallel.  (2) A warp takes 32
// consecutive rows, a lane one row's index loads (inv_perm and the split
// CSR, coalesced), then runs flat over the warp's (row, vector) pairs, VE
// elements a vector (16 or 8 bytes where k and the base addresses allow
// it, else one element): lane l takes the vectors l, l + 32, ..., so the
// stores of the warp's 32 contiguous output rows are coalesced, and U
// vectors a lane (128 bytes) are loaded before the first of them is
// stored.  In a warp with split rows (a warp-uniform branch) each of their
// vectors then adds its row's chunk sums in chunk order, eight loads ahead
// of the adds.  Each element is summed in one fixed order, the plain
// version's (ops/ell.py:_segment_table_sums_plain): the first segment,
// then per chunk its P positions in order from zero, then that chunk sum;
// so the two agree bit for bit, and no float atomics are needed.  Pass (1) exists because the chunks gather on
// a few head rows, which sit side by side in the first warps: summed in
// those warps, their dependent loads would be the launch's tail.
#include "common.cuh"

namespace hpf {

// bytes of row data a lane loads before it stores (the copy), and chunk
// sums a lane loads before it adds them (a split row)
constexpr int kCopyBytesInFlight = 128;
constexpr int kChunkBatch = 8;

// Pass 1, over the split chunks only: each chunk's sum, from zero, of its
// P positions in order (-1 adds nothing), flat over (chunk, vector).
template <typename T, int VE>
__global__ void __launch_bounds__(kThreads)
    chunk_sums_kernel(const T* __restrict__ seg, const int32_t* __restrict__ split_seg_pos,
                      T* __restrict__ chunk_sums, int64_t items, int nv, int P) {
  using In = Vec<T, VE>;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const int64_t ch = i / nv;
  const int c = (int)(i - ch * nv);
  const In* __restrict__ segv = reinterpret_cast<const In*>(seg);
  const int32_t* __restrict__ pos = split_seg_pos + ch * P;
  In e;
#pragma unroll
  for (int y = 0; y < VE; ++y) e.v[y] = T(0);
  for (int p0 = 0; p0 < P; p0 += 4) {
    int32_t q[4];
    In x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = p0 + j < P ? pos[p0 + j] : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (q[j] >= 0) x[j] = segv[(int64_t)q[j] * nv + c];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (q[j] >= 0)
#pragma unroll
        for (int y = 0; y < VE; ++y) e.v[y] += x[j].v[y];
  }
  reinterpret_cast<In*>(chunk_sums)[i] = e;
}

// Pass 2: every row.  VE: elements a vector.
template <typename T, typename O, int VE>
__global__ void __launch_bounds__(kThreads)
    segment_table_sums_kernel(const T* __restrict__ seg, const int32_t* __restrict__ inv_perm,
                              const int32_t* __restrict__ split_indptr,
                              const T* __restrict__ chunk_sums, O* __restrict__ out, int64_t n,
                              int k) {
  using In = Vec<T, VE>;
  constexpr int U = kCopyBytesInFlight / (int)sizeof(In);
  const int lane = threadIdx.x & (kWarp - 1);
  const int nv = k / VE;
  const In* __restrict__ segv = reinterpret_cast<const In*>(seg);
  const In* __restrict__ sumv = reinterpret_cast<const In*>(chunk_sums);
  const int64_t row0 = ((int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp) * kWarp;
  if (row0 >= n) return;
  const int rows = n - row0 >= kWarp ? kWarp : (int)(n - row0);

  // a lane's row: its first segment and its range of split chunks
  int32_t first = 0, c0 = 0, c1 = 0;
  if (lane < rows) {
    first = inv_perm[row0 + lane];
    c0 = split_indptr[row0 + lane];
    c1 = split_indptr[row0 + lane + 1];
  }
  const bool any_split = __any_sync(0xffffffffu, c1 > c0);

  // flat over the warp's rows x vectors; f = r * nv + c
  const int total = rows * nv;
  const int dq = kWarp / nv, dr = kWarp % nv;  // f += 32 moves r by dq and c by dr
  int r = lane / nv, c = lane % nv;
  Vec<O, VE>* __restrict__ dst = reinterpret_cast<Vec<O, VE>*>(out) + row0 * nv;
  for (int base = 0; base < total; base += U * kWarp) {
    In x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int src = __shfl_sync(0xffffffffu, first, r & (kWarp - 1));
      if (base + u * kWarp + lane < total) x[u] = segv[(int64_t)src * nv + c];
      c += dr;
      r += dq;
      if (c >= nv) {
        c -= nv;
        ++r;
      }
    }
    if (any_split) {  // add each split row's chunk sums in chunk order
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int f = base + u * kWarp + lane;
        const int fr = f / nv, fc = f - fr * nv;
        const int cs = __shfl_sync(0xffffffffu, c0, fr & (kWarp - 1));
        const int ce = __shfl_sync(0xffffffffu, c1, fr & (kWarp - 1));
        if (f < total) {
          for (int ch = cs; ch < ce; ch += kChunkBatch) {
            In e[kChunkBatch];
#pragma unroll
            for (int j = 0; j < kChunkBatch; ++j)
              if (ch + j < ce) e[j] = sumv[(int64_t)(ch + j) * nv + fc];
#pragma unroll
            for (int j = 0; j < kChunkBatch; ++j)
              if (ch + j < ce)
#pragma unroll
                for (int y = 0; y < VE; ++y) x[u].v[y] += e[j].v[y];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * kWarp + lane < total) {
        Vec<O, VE> o;
#pragma unroll
        for (int y = 0; y < VE; ++y) o.v[y] = (O)x[u].v[y];
        dst[base + u * kWarp + lane] = o;
      }
    }
  }
}

template <typename T, typename O, int VE>
cudaError_t launch_segment_sums_ve(const T* seg, const int32_t* inv_perm,
                                   const int32_t* split_indptr, const int32_t* split_seg_pos,
                                   T* chunk_sums, O* out, int64_t n, int k, int64_t n_chunks,
                                   int P, cudaStream_t stream) {
  const int nv = k / VE;
  if (n_chunks > 0) {
    const int64_t items = n_chunks * nv;
    chunk_sums_kernel<T, VE><<<(unsigned)((items + kThreads - 1) / kThreads), kThreads, 0,
                               stream>>>(seg, split_seg_pos, chunk_sums, items, nv, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  segment_table_sums_kernel<T, O, VE><<<(unsigned)blocks, kThreads, 0, stream>>>(
      seg, inv_perm, split_indptr, chunk_sums, out, n, k);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t launch_segment_sums(const T* seg, const int32_t* inv_perm, const int32_t* split_indptr,
                                const int32_t* split_seg_pos, T* chunk_sums, O* out, int64_t n,
                                int k, int64_t n_chunks, int P, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (k <= 0 || k > 256 || P <= 0 || n_chunks < 0) return cudaErrorInvalidValue;
  const void* ptrs[3] = {seg, out, chunk_sums};
  const int sizes[3] = {(int)sizeof(T), (int)sizeof(O), (int)sizeof(T)};
  switch (vec_elems(k, 16 / (int)sizeof(T), ptrs, sizes, n_chunks > 0 ? 3 : 2)) {
    case 4:
      if constexpr (sizeof(T) == 4)
        return launch_segment_sums_ve<T, O, 4>(seg, inv_perm, split_indptr, split_seg_pos,
                                               chunk_sums, out, n, k, n_chunks, P, stream);
      break;
    case 2:
      return launch_segment_sums_ve<T, O, 2>(seg, inv_perm, split_indptr, split_seg_pos,
                                             chunk_sums, out, n, k, n_chunks, P, stream);
    default:
      return launch_segment_sums_ve<T, O, 1>(seg, inv_perm, split_indptr, split_seg_pos,
                                             chunk_sums, out, n, k, n_chunks, P, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace hpf

extern "C" {

int hpf_segment_table_sums_f32(const float* seg, const int32_t* inv_perm,
                               const int32_t* split_indptr, const int32_t* split_seg_pos,
                               float* chunk_sums, float* out, int64_t n, int32_t k,
                               int64_t n_chunks, int32_t P, void* stream) {
  return hpf::launch_segment_sums(seg, inv_perm, split_indptr, split_seg_pos, chunk_sums, out, n,
                                  k, n_chunks, P, (cudaStream_t)stream);
}

int hpf_segment_table_sums_f64(const double* seg, const int32_t* inv_perm,
                               const int32_t* split_indptr, const int32_t* split_seg_pos,
                               double* chunk_sums, double* out, int64_t n, int32_t k,
                               int64_t n_chunks, int32_t P, void* stream) {
  return hpf::launch_segment_sums(seg, inv_perm, split_indptr, split_seg_pos, chunk_sums, out, n,
                                  k, n_chunks, P, (cudaStream_t)stream);
}

// float32 segment sums written as float64
int hpf_segment_table_sums_f32_f64(const float* seg, const int32_t* inv_perm,
                                   const int32_t* split_indptr, const int32_t* split_seg_pos,
                                   float* chunk_sums, double* out, int64_t n, int32_t k,
                                   int64_t n_chunks, int32_t P, void* stream) {
  return hpf::launch_segment_sums(seg, inv_perm, split_indptr, split_seg_pos, chunk_sums, out, n,
                                  k, n_chunks, P, (cudaStream_t)stream);
}

}  // extern "C"
