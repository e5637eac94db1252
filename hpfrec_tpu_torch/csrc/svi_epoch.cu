// K9 — one SVI epoch's nonzero stream in shuffled-row order.
//
// Replaces hpfrec_tpu/ops/svi.py:build_epoch_buffers (svi.py:153-192).
// The CSR (or CSC) arrays of the epoch's side stay on the device; the
// host ships the shuffled rows `perm` (n,) and `offsets` (n + 1,), the
// exclusive prefix sum of the permuted row degrees.  For epoch position j:
//   p = the permuted row with offsets[p] <= j < offsets[p + 1]
//       (the last p with offsets[p] <= j),
//   src = indptr[perm[p]] + j - offsets[p],
//   e_y[j] = y[src],  e_row[j] = perm[p],  e_col[j] = cols[src].
// Zero-degree rows have offsets[p] == offsets[p + 1] and are never found.
// Unlike the JAX function, the stream has exactly nnz entries: no chunk
// capacity padding (nothing on the card needs static shapes).
//
// What bounds it on the card: bytes.  Per position it reads y and cols
// (8-12 bytes, consecutive within a row run) and writes 12-16 bytes.
// Finding a position's row must not add a chain of dependent loads: a
// binary search over `offsets` a position (the first design) paid ~20 of
// them at 1M rows, and read at 27% of the byte bound.
//
// Design: a block owns a tile of kEpochTile consecutive positions and finds
// each row once a tile, not once a position.  Warp 0 finds the tile's first
// row with a 32-ary search (one probe a lane, then a ballot: 4 rounds at 1M
// rows).  The block then stages the rows from there in pieces of
// kEpochPiece rows (coalesced loads of `offsets`, then `perm` and `indptr`
// for the rows that start inside the tile), until a row starts at or past
// the tile's end: a run of zero-degree rows of any length takes more
// pieces, and a tile inside one row (the rank-1 item of a Zipf side spans
// hundreds of tiles) takes one.  Each non-empty row writes its start into
// shared memory; an inclusive max-scan over the tile gives every position
// the start of its row, and with it the row's id and source base.  The
// gather then reads y and cols (contiguous within a row run) and stores 4
// consecutive positions a lane as one vector of each output (16 bytes; 32
// of double), with scalar stores at the stream's ragged end.  No atomics:
// the outputs are a pure gather, bit-equal to the plain version.
#include "common.cuh"

namespace hpf {

constexpr int kEpochTile = 2048;                   // positions a block
constexpr int kEpochScan = kEpochTile / kThreads;  // 8 a thread in the scan
constexpr int kEpochRows = 4;                      // rows a thread a piece
constexpr int kEpochPiece = kThreads * kEpochRows; // rows a staging piece
constexpr int kEpochVec = 4;                       // positions a lane a store
constexpr int kEpochRounds = kEpochTile / (kThreads * kEpochVec);

// The last p in [0, n_rows) with offsets[p] <= t (offsets[0] = 0 <= t),
// found by one warp: each round probes 32 evenly spaced rows of the range
// and keeps the span after the last probe at or below t.
__device__ __forceinline__ int64_t warp_find_row(const int32_t* __restrict__ offsets,
                                                 int64_t n_rows, int64_t t, int lane) {
  int64_t lo = 0, hi = n_rows;  // offsets[lo] <= t, the answer < hi
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + kWarp - 1) / kWarp;
    const int64_t q = lo + lane * step;
    const unsigned below = __ballot_sync(0xffffffffu, q < hi && offsets[q] <= t);
    lo += (31 - __clz(below)) * step;  // lane 0 probes lo itself: its bit is set
    hi = lo + step < hi ? lo + step : hi;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    epoch_gather_kernel(const T* __restrict__ y, const int32_t* __restrict__ cols,
                        const int32_t* __restrict__ indptr, const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ offsets, T* __restrict__ e_y,
                        int32_t* __restrict__ e_row, int32_t* __restrict__ e_col, int64_t nnz,
                        int64_t n_rows) {
  // per tile position: after staging, the position itself where a row
  // starts there (else -1); after the scan, the start of its row
  __shared__ __align__(16) int32_t s_start[kEpochTile];
  __shared__ int32_t s_row[kEpochTile];   // at a row's start: perm[p]
  __shared__ int32_t s_base[kEpochTile];  // at a row's start: indptr[perm[p]] - offsets[p]
  __shared__ int32_t s_warp_max[kWarpsPerBlock];
  __shared__ int64_t s_first;
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const int64_t t0 = (int64_t)blockIdx.x * kEpochTile;
  const int64_t t1 = t0 + kEpochTile < nnz ? t0 + kEpochTile : nnz;
  const int width = (int)(t1 - t0);

  if (warp == 0) {
    const int64_t p0 = warp_find_row(offsets, n_rows, t0, lane);
    if (lane == 0) s_first = p0;
  }
  for (int i = tid; i < kEpochTile; i += kThreads) s_start[i] = -1;
  __syncthreads();

  // Stage the rows from the first on.  The first row starts at or before
  // t0 and every later one after it, so non-empty rows mark distinct
  // positions.  The loop's condition is the same for every thread.
  for (int64_t pb = s_first;; pb += kEpochPiece) {
    const int64_t p = pb + (int64_t)tid * kEpochRows;
    int32_t o[kEpochRows + 1];
#pragma unroll
    for (int r = 0; r <= kEpochRows; ++r) o[r] = p + r <= n_rows ? offsets[p + r] : INT32_MAX;
    bool mark[kEpochRows];
    int32_t row[kEpochRows];
#pragma unroll
    for (int r = 0; r < kEpochRows; ++r) {
      mark[r] = p + r < n_rows && o[r] < t1 && o[r + 1] > o[r];
      row[r] = mark[r] ? perm[p + r] : 0;
    }
    int32_t start[kEpochRows];
#pragma unroll
    for (int r = 0; r < kEpochRows; ++r) start[r] = mark[r] ? indptr[row[r]] : 0;
#pragma unroll
    for (int r = 0; r < kEpochRows; ++r) {
      if (mark[r]) {
        const int at = o[r] > t0 ? (int)(o[r] - t0) : 0;
        s_start[at] = at;
        s_row[at] = row[r];
        s_base[at] = start[r] - o[r];
      }
    }
    const int64_t next = pb + kEpochPiece;
    if (next >= n_rows || offsets[next] >= t1) break;
  }
  __syncthreads();

  // Inclusive max-scan of s_start: thread tid takes kEpochScan consecutive
  // positions; the warps' maxima carry across the block.
  {
    int32_t v[kEpochScan];
    const int4* src = reinterpret_cast<const int4*>(s_start + tid * kEpochScan);
#pragma unroll
    for (int h = 0; h < kEpochScan / 4; ++h) {
      const int4 q = src[h];
      v[4 * h] = q.x;
      v[4 * h + 1] = q.y;
      v[4 * h + 2] = q.z;
      v[4 * h + 3] = q.w;
    }
#pragma unroll
    for (int e = 1; e < kEpochScan; ++e) v[e] = max(v[e], v[e - 1]);
    int32_t incl = v[kEpochScan - 1];
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int32_t u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = max(incl, u);
    }
    int32_t carry = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) carry = -1;
    if (lane == kWarp - 1) s_warp_max[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) carry = max(carry, s_warp_max[w]);
    int4* dst = reinterpret_cast<int4*>(s_start + tid * kEpochScan);
#pragma unroll
    for (int h = 0; h < kEpochScan / 4; ++h)
      dst[h] = make_int4(max(v[4 * h], carry), max(v[4 * h + 1], carry),
                         max(v[4 * h + 2], carry), max(v[4 * h + 3], carry));
  }
  __syncthreads();

  // The gather: every load of the lane's positions before the first store.
  T vy[kEpochRounds][kEpochVec];
  int32_t vr[kEpochRounds][kEpochVec], vc[kEpochRounds][kEpochVec];
#pragma unroll
  for (int c = 0; c < kEpochRounds; ++c) {
    const int l0 = (c * kThreads + tid) * kEpochVec;
    const int4 q = *reinterpret_cast<const int4*>(s_start + l0);
    const int32_t starts[kEpochVec] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < kEpochVec; ++e) {
      if (l0 + e < width) {
        const int s = starts[e];
        const int64_t src = (int64_t)s_base[s] + t0 + l0 + e;
        vy[c][e] = y[src];
        vc[c][e] = cols[src];
        vr[c][e] = s_row[s];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kEpochRounds; ++c) {
    const int l0 = (c * kThreads + tid) * kEpochVec;
    const int64_t j = t0 + l0;
    if (l0 + kEpochVec <= width) {
      Vec<T, kEpochVec> oy;
#pragma unroll
      for (int e = 0; e < kEpochVec; ++e) oy.v[e] = vy[c][e];
      *reinterpret_cast<Vec<T, kEpochVec>*>(e_y + j) = oy;
      *reinterpret_cast<int4*>(e_row + j) = make_int4(vr[c][0], vr[c][1], vr[c][2], vr[c][3]);
      *reinterpret_cast<int4*>(e_col + j) = make_int4(vc[c][0], vc[c][1], vc[c][2], vc[c][3]);
    } else {
#pragma unroll
      for (int e = 0; e < kEpochVec; ++e) {
        if (l0 + e < width) {
          e_y[j + e] = vy[c][e];
          e_row[j + e] = vr[c][e];
          e_col[j + e] = vc[c][e];
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_epoch(const T* y, const int32_t* cols, const int32_t* indptr,
                         const int32_t* perm, const int32_t* offsets, T* e_y, int32_t* e_row,
                         int32_t* e_col, int64_t nnz, int64_t n_rows, cudaStream_t stream) {
  static_assert(kEpochTile % (kThreads * kEpochVec) == 0 && kEpochScan % 4 == 0,
                "K9's tile splits into whole scans and stores");
  if (nnz <= 0) return cudaSuccess;
  // the outputs take 4-position vector stores from tile starts
  if (n_rows <= 0 || nnz > INT32_MAX || (uintptr_t)e_y % (kEpochVec * sizeof(T)) != 0 ||
      (uintptr_t)e_row % 16 != 0 || (uintptr_t)e_col % 16 != 0)
    return cudaErrorInvalidValue;
  const int64_t blocks = (nnz + kEpochTile - 1) / kEpochTile;
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
