// K9 — one SVI epoch's nonzero stream in shuffled-row order.
//
// Replaces hpfrec_tpu/ops/svi.py:build_epoch_buffers (svi.py:153-192).
// The CSR (or CSC) arrays of the epoch's side stay on the device; the
// host ships the shuffled rows `perm` (n,) and `offsets` (n + 1,), the
// exclusive prefix sum of the permuted row degrees.  For epoch position j:
//   p = the permuted row with offsets[p] <= j < offsets[p + 1]
//       (binary search: the last p with offsets[p] <= j),
//   src = indptr[perm[p]] + j - offsets[p],
//   e_y[j] = y[src],  e_row[j] = perm[p],  e_col[j] = cols[src].
// Zero-degree rows have offsets[p] == offsets[p + 1] and are never found.
// Unlike the JAX function, the stream has exactly nnz entries: no chunk
// capacity padding (nothing on the card needs static shapes).
//
// What bounds it on the card: bytes.  Per position it reads y and cols
// (8-12 bytes, consecutive within a row run) and writes 12-16 bytes; the
// binary search reads ~log2(n) entries of `offsets`, which at n = 1M rows
// (4 MB) live in L2.
//
// Design: one thread per position, each with its own binary search, as
// the JAX function does.  A warp or block per row would serialize the
// head rows of a Zipf side (the rank-1 item holds ~7.5% of all nonzeros);
// one thread per position spreads every row evenly over the grid.
// Consecutive threads read and write consecutive addresses.  No atomics.
#include "common.cuh"

namespace hpf {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    epoch_gather_kernel(const T* __restrict__ y, const int32_t* __restrict__ cols,
                        const int32_t* __restrict__ indptr, const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ offsets, T* __restrict__ e_y,
                        int32_t* __restrict__ e_row, int32_t* __restrict__ e_col, int64_t nnz,
                        int64_t n_rows) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < nnz; j += stride) {
    // last p in [0, n_rows) with offsets[p] <= j; offsets[0] = 0 <= j
    int64_t lo = 0, hi = n_rows;  // invariant: offsets[lo] <= j, answer < hi
    while (hi - lo > 1) {
      const int64_t mid = (lo + hi) >> 1;
      if (offsets[mid] <= j) lo = mid; else hi = mid;
    }
    const int32_t row = perm[lo];
    const int64_t src = (int64_t)indptr[row] + (j - offsets[lo]);
    e_y[j] = y[src];
    e_row[j] = row;
    e_col[j] = cols[src];
  }
}

template <typename T>
cudaError_t launch_epoch(const T* y, const int32_t* cols, const int32_t* indptr,
                         const int32_t* perm, const int32_t* offsets, T* e_y, int32_t* e_row,
                         int32_t* e_col, int64_t nnz, int64_t n_rows, cudaStream_t stream) {
  if (nnz <= 0) return cudaSuccess;
  if (n_rows <= 0) return cudaErrorInvalidValue;
  int64_t blocks = (nnz + kThreads - 1) / kThreads;
  if (blocks > 65535 * 16) blocks = 65535 * 16;  // grid-stride beyond
  epoch_gather_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      y, cols, indptr, perm, offsets, e_y, e_row, e_col, nnz, n_rows);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_epoch_gather_f32(const float* y, const int32_t* cols, const int32_t* indptr,
                         const int32_t* perm, const int32_t* offsets, float* e_y, int32_t* e_row,
                         int32_t* e_col, int64_t nnz, int64_t n_rows, void* stream) {
  return hpf::launch_epoch(y, cols, indptr, perm, offsets, e_y, e_row, e_col, nnz, n_rows,
                           (cudaStream_t)stream);
}

int hpf_epoch_gather_f64(const double* y, const int32_t* cols, const int32_t* indptr,
                         const int32_t* perm, const int32_t* offsets, double* e_y,
                         int32_t* e_row, int32_t* e_col, int64_t nnz, int64_t n_rows,
                         void* stream) {
  return hpf::launch_epoch(y, cols, indptr, perm, offsets, e_y, e_row, e_col, nnz, n_rows,
                           (cudaStream_t)stream);
}

}  // extern "C"
