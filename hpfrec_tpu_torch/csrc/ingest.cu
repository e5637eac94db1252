// K15a, K15b — a fit's triplets checked and narrowed, and a sorted side's
// CSR row pointers, on the card.
//
// Replace no function of hpfrec_tpu: the JAX package ingests on the host
// (hpfrec_tpu/utils/data.py:process_data, its counting-sort CSR builds).
// A fit on a card uploads the caller's triplets once (ops/ingest.py) and
// sorts them there with PyTorch's stable key sort; these two kernels are
// the rest of that ingest beyond the sort, the payload gathers and plain
// casts.
//
// K15a ids_narrow: one pass over an id array of int32 or int64 that
// writes it narrowed to int32 (as numpy's astype(int32) wraps) and the
// least and the largest id as int64.  The host reads the four scalars of
// both sides back once: a negative id raises, and without a shape the
// maxima size the tables.  Each block reduces its share in registers and
// shared memory and folds it into the two results with one integer
// atomicMin / atomicMax each (no float atomics; min and max are exact in
// any order).
//
// K15b csr_indptr: the row pointers of a side from its sorted keys, from
// the run bounds alone: position p starts every row r with keys[p - 1] <
// r <= keys[p] (row -1 before the first key, n_rows after the last), so
// each of the n_rows + 1 pointers is written exactly once, by the thread
// of the first position whose key reaches it; no atomics.
#include <limits.h>

#include "common.cuh"

namespace hpf {

constexpr int kIngestGrid = 2048;  // blocks of a grid-stride pass

__global__ void ids_minmax_init_kernel(long long* minmax) {
  minmax[0] = LLONG_MAX;
  minmax[1] = LLONG_MIN;
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
    ids_narrow_kernel(const I* __restrict__ ids, int64_t n, int32_t* __restrict__ out,
                      long long* __restrict__ minmax) {
  long long lo = LLONG_MAX, hi = LLONG_MIN;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * kThreads) {
    const long long v = (long long)ids[j];
    lo = v < lo ? v : lo;
    hi = v > hi ? v : hi;
    if (out != nullptr) out[j] = (int32_t)v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long a = __shfl_xor_sync(0xffffffffu, lo, o);
    const long long b = __shfl_xor_sync(0xffffffffu, hi, o);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
  }
  __shared__ long long s_lo[kWarpsPerBlock], s_hi[kWarpsPerBlock];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarpsPerBlock; ++w) {
      lo = s_lo[w] < lo ? s_lo[w] : lo;
      hi = s_hi[w] > hi ? s_hi[w] : hi;
    }
    if (lo != LLONG_MAX) atomicMin(&minmax[0], lo);
    if (hi != LLONG_MIN) atomicMax(&minmax[1], hi);
  }
}

template <typename I>
int launch_ids_narrow(const I* ids, int64_t n, int32_t* out, long long* minmax,
                      cudaStream_t stream) {
  if (n < 0) return cudaErrorInvalidValue;
  ids_minmax_init_kernel<<<1, 1, 0, stream>>>(minmax);
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    const int grid = blocks < kIngestGrid ? (int)blocks : kIngestGrid;
    ids_narrow_kernel<I><<<grid, kThreads, 0, stream>>>(ids, n, out, minmax);
  }
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
    csr_indptr_kernel(const int32_t* __restrict__ keys, int64_t n, int64_t n_rows,
                      int32_t* __restrict__ indptr) {
  for (int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x; p <= n;
       p += (int64_t)gridDim.x * kThreads) {
    const int64_t prev = p == 0 ? -1 : (int64_t)keys[p - 1];
    const int64_t cur = p == n ? n_rows : (int64_t)keys[p];
    const int64_t r0 = prev + 1 > 0 ? prev + 1 : 0;
    const int64_t r1 = cur < n_rows ? cur : n_rows;
    for (int64_t r = r0; r <= r1; ++r) indptr[r] = (int32_t)p;
  }
}

}  // namespace hpf

extern "C" {

int hpf_ids_narrow_i32(const int32_t* ids, int64_t n, int32_t* out, long long* minmax,
                       void* stream) {
  return hpf::launch_ids_narrow(ids, n, out, minmax, (cudaStream_t)stream);
}

int hpf_ids_narrow_i64(const int64_t* ids, int64_t n, int32_t* out, long long* minmax,
                       void* stream) {
  return hpf::launch_ids_narrow(ids, n, out, minmax, (cudaStream_t)stream);
}

int hpf_csr_indptr(const int32_t* keys, int64_t n, int64_t n_rows, int32_t* indptr,
                   void* stream) {
  if (n < 0 || n_rows < 0) return cudaErrorInvalidValue;
  const int64_t blocks = (n + 1 + hpf::kThreads - 1) / hpf::kThreads;
  const int grid = blocks < hpf::kIngestGrid ? (int)blocks : hpf::kIngestGrid;
  hpf::csr_indptr_kernel<<<grid, hpf::kThreads, 0, (cudaStream_t)stream>>>(keys, n, n_rows,
                                                                           indptr);
  return cudaGetLastError();
}

}  // extern "C"
