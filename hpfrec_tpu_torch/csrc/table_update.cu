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
// (read sums or shp+rte, write shp, rte and tab: 16 bytes an element in
// the update form and 12 in the derive form, float32) plus a digamma, a
// log, an exp and two divisions an element.  On an H100 the instructions
// bound it, not the bytes: without the digamma the same pass runs at
// ~70% of the byte bound, and with it at ~40-46% (PERF.md).
//
// Design: a tiled streaming pass.  A block of 256 threads owns kTilesPerBlock
// consecutive tiles of R rows (a function of k and the dtype,
// ops/cavi.py:_k3_grid: R a multiple of 4 with R * k a multiple of 8, ~8 KB a
// table a tile), so a tile is R * k contiguous elements that start 16-byte
// aligned in every table, the bfloat16 tab included.  The tile's inputs (sums
// and the row scalers, or shp and rte) are copied into shared memory with
// cp.async, 16 bytes a copy, double-buffered: the next tile's copies are in
// flight while this one computes.  Where a table pointer is not 16-byte
// aligned (a view that starts at another row) every copy and store is one
// element (the `vec` flag, uniform over the launch); a partial last tile
// copies its tail the same way.  Each thread takes V consecutive elements of
// the flat tile at a time (V = 16 bytes of T; the partial chunk of a partial
// last tile, if any, after the full ones), so no thread idles whatever k is:
// pass A computes shp, rte, the mean and E[log] (into shared memory, in place
// of the input) and stores shp and rte; pass B reduces each row by 8 lanes
// (max, and the sum of the means, in an order fixed by k) and the first k
// threads add the tile's means down its rows into their column's running sum;
// pass C writes tab = exp(elog - rowmax) (a non-finite rowmax set to 0) and
// the row scalers, all stores 16 bytes wide (a bfloat16 tab's 8 or 4: 16-byte
// bfloat16 chunks, 8 elements a thread, measured slower).  Each block writes
// its column sums as one (k,) partial, so the partial count is a function of
// n, k and the dtype only (never of the card), and colsum_finish adds the
// partials in block order: no atomics, the same bits from run to run and rank
// to rank.  The update form writes new buffers and reads scaler_old before
// scaler_new exists, so it can never read a value it wrote.  The digamma
// (common.cuh) divides once for its recurrence's shift (was once a step;
// digamma_stepwise below keeps the old form as the yardstick of
// digamma_eval).  Build without --use_fast_math (IEEE division and logf: the
// pad-row form above).
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace hpf {

constexpr int kTilesPerBlock = 8;  // ops/cavi.py _K3_TILES_PER_BLOCK
constexpr int kRowLanes = 8;       // lanes that reduce one row in pass B

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// A block's shared memory, in bytes from the start: two stages of inputs
// (a: sums or shp, E elements; b: the row scalers, R, or rte, E), the
// means, the row maxima, and in the update form the new row scalers, the
// row rates scaler_shape / scaler_old and colsum_other.
template <bool UPDATE, typename T>
struct TileSmem {
  int stage, b, mean, mx, sc, base, cso, total;  // stage s: a at s * stage, b at s * stage + b
  __host__ __device__ TileSmem(int R, int k) {
    const int ea = align16(R * k * (int)sizeof(T));
    const int eb = align16((UPDATE ? R : R * k) * (int)sizeof(T));
    const int er = align16(R * (int)sizeof(T));
    stage = ea + eb;
    b = ea;
    mean = 2 * stage;
    mx = mean + ea;
    sc = mx + er;
    base = sc + (UPDATE ? er : 0);
    cso = base + (UPDATE ? er : 0);
    total = cso + (UPDATE ? align16(k * (int)sizeof(T)) : 0);
  }
};

// cnt elements global -> shared, asynchronously: 16-byte copies where vec
// (both ends 16-byte aligned), one element a copy for the rest.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int cnt, int vec) {
  constexpr int P = 16 / sizeof(T);
  int done = 0;
  if (vec) {
    const int pieces = cnt / P;
    for (int i = threadIdx.x; i < pieces; i += kThreads) async_copy16(dst + i * P, src + i * P);
    done = pieces * P;
  }
  for (int i = done + (int)threadIdx.x; i < cnt; i += kThreads)
    async_copy_elem<sizeof(T)>(dst + i, src + i);
}

// V elements at p (aligned to their size when cnt == V and wide): accesses
// of 16 bytes (or one of 8 or 4 where V elements take less), else cnt
// single ones.
template <int B>
struct Word;
template <>
struct Word<4> {
  using type = uint32_t;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<16> {
  using type = uint4;
};

template <int V, typename X>
__device__ __forceinline__ void load_v(X (&v)[V], const X* p, int cnt, bool wide) {
  constexpr int B = V * sizeof(X) < 16 ? V * sizeof(X) : 16;
  using W = typename Word<B>::type;
  if (wide && cnt == V) {
#pragma unroll
    for (int i = 0; i < (int)(V * sizeof(X) / B); ++i) {
      const W u = reinterpret_cast<const W*>(p)[i];
      memcpy(&v[i * B / sizeof(X)], &u, B);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = j < cnt ? p[j] : X(0);
  }
}

template <int V, typename X>
__device__ __forceinline__ void store_v(X* p, const X (&v)[V], int cnt, bool wide) {
  constexpr int B = V * sizeof(X) < 16 ? V * sizeof(X) : 16;
  using W = typename Word<B>::type;
  if (wide && cnt == V) {
#pragma unroll
    for (int i = 0; i < (int)(V * sizeof(X) / B); ++i) {
      W u;
      memcpy(&u, &v[i * B / sizeof(X)], B);
      reinterpret_cast<W*>(p)[i] = u;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < cnt) p[j] = v[j];
  }
}

// Float32: at most 51 registers, five blocks an SM (3% faster than the
// four that 52 registers allowed).
template <bool UPDATE, typename T, typename TabT>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 5 : 1)
    table_tile_kernel(const T* __restrict__ a_in, const T* __restrict__ b_in,
                      const T* __restrict__ colsum_other, T prior, T scaler_shape, T add_scaler,
                      T* __restrict__ shp_out, T* __restrict__ rte_out, TabT* __restrict__ tab_out,
                      T* __restrict__ scaler_out, T* __restrict__ partials, int64_t n,
                      int64_t n_real, int k, int R, int vec) {
  constexpr int V = 16 / sizeof(T);  // elements a thread takes at a time
  constexpr int P = 16 / sizeof(T);  // row scalers a 16-byte store
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem<UPDATE, T> L(R, k);
  T* const mean_s = reinterpret_cast<T*>(smem + L.mean);
  T* const mx_s = reinterpret_cast<T*>(smem + L.mx);
  T* const sc_s = reinterpret_cast<T*>(smem + L.sc);
  T* const base_s = reinterpret_cast<T*>(smem + L.base);
  T* const cso_s = reinterpret_cast<T*>(smem + L.cso);
  const int tid = threadIdx.x;
  const int64_t ntiles = (n + R - 1) / R;
  const int64_t t_begin = (int64_t)blockIdx.x * kTilesPerBlock;
  const int64_t t_end = t_begin + kTilesPerBlock < ntiles ? t_begin + kTilesPerBlock : ntiles;

  if (UPDATE)
    for (int c = tid; c < k; c += kThreads) cso_s[c] = colsum_other[c];

  auto prefetch = [&](int64_t t, int s) {
    const int64_t r0 = t * R;
    const int rows = (int)(n - r0 < R ? n - r0 : R);
    T* const a_s = reinterpret_cast<T*>(smem + s * L.stage);
    T* const b_s = reinterpret_cast<T*>(smem + s * L.stage + L.b);
    copy_async(a_s, a_in + r0 * k, rows * k, vec);
    if (UPDATE) copy_async(b_s, b_in + r0, rows, vec);
    else copy_async(b_s, b_in + r0 * k, rows * k, vec);
  };

  T col_acc = T(0);  // thread c < k: the block's sum of column c of the means
  if (t_begin < t_end) prefetch(t_begin, 0);
  async_commit();
  for (int64_t t = t_begin; t < t_end; ++t) {
    const int s = (int)(t - t_begin) & 1;
    if (t + 1 < t_end) prefetch(t + 1, s ^ 1);
    async_commit();
    async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const int64_t r0 = t * R;
    const int rows = (int)(n - r0 < R ? n - r0 : R);
    const int ne = rows * k;
    T* const as = reinterpret_cast<T*>(smem + s * L.stage);
    const T* const bs = reinterpret_cast<const T*>(smem + s * L.stage + L.b);
    if (UPDATE) {
      for (int r = tid; r < rows; r += kThreads) base_s[r] = scaler_shape / bs[r];
      __syncthreads();
    }

    // A: shp, rte, the mean and E[log x] of V elements a thread (full
    // chunks; the one partial chunk of a partial last tile after them)
    auto pass_a = [&](int e0, auto full) {
      constexpr bool F = decltype(full)::value;
      const int cnt = F ? V : ne - e0;
      int row = e0 / k, col = e0 - row * k;
      T a[V], b[V], shp[V], rte[V], mean[V];
      load_v(a, as + e0, cnt, true);
      if (!UPDATE) load_v(b, bs + e0, cnt, true);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        shp[j] = UPDATE ? prior + a[j] : a[j];
        rte[j] = UPDATE ? (F || j < cnt ? base_s[row] + cso_s[col] : T(1)) : b[j];
        mean[j] = shp[j] / rte[j];
        a[j] = digamma(shp[j]) - dlog(rte[j]);
        if (++col == k) {
          col = 0;
          ++row;
        }
      }
      store_v(as + e0, a, cnt, true);
      store_v(mean_s + e0, mean, cnt, true);
      if (UPDATE) {
        store_v(shp_out + r0 * k + e0, shp, cnt, vec);
        store_v(rte_out + r0 * k + e0, rte, cnt, vec);
      }
    };
    int e0 = tid * V;
    for (; e0 + V <= ne; e0 += kThreads * V) pass_a(e0, std::true_type{});
    if (e0 < ne) pass_a(e0, std::false_type{});
    __syncthreads();

    // B: each row's max (and sum of the means) by kRowLanes lanes, lane g
    // taking columns g, g + 8, ... then an xor butterfly; the column sums
    for (int rb = 0; rb < rows; rb += kThreads / kRowLanes) {
      const int r = rb + tid / kRowLanes;
      const int g = tid % kRowLanes;
      T mx = T(-INFINITY), sum = T(0);
      if (r < rows) {
        for (int c = g; c < k; c += kRowLanes) {
          const T e = as[r * k + c];
          mx = e > mx ? e : mx;
          if (UPDATE) sum += mean_s[r * k + c];
        }
      }
#pragma unroll
      for (int o = kRowLanes / 2; o > 0; o >>= 1) {
        const T u = __shfl_xor_sync(0xffffffffu, mx, o);
        mx = u > mx ? u : mx;
        if (UPDATE) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      if (r < rows && g == 0) {
        mx_s[r] = isfinite(mx) ? mx : T(0);
        if (UPDATE) sc_s[r] = r0 + r < n_real ? add_scaler + sum : T(0);
      }
    }
    if (tid < k)
      for (int r = 0; r < rows; ++r) col_acc += mean_s[r * k + tid];
    __syncthreads();

    // C: tab = exp(elog - rowmax), narrowed to TabT; the row scalers
    auto pass_c = [&](int e0, auto full) {
      constexpr bool F = decltype(full)::value;
      const int cnt = F ? V : ne - e0;
      int row = e0 / k, col = e0 - row * k;
      T a[V];
      TabT tab[V];
      load_v(a, as + e0, cnt, true);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        tab[j] = narrow<TabT>(dexp(a[j] - mx_s[F || j < cnt ? row : 0]));
        if (++col == k) {
          col = 0;
          ++row;
        }
      }
      store_v(tab_out + r0 * k + e0, tab, cnt, vec);
    };
    for (e0 = tid * V; e0 + V <= ne; e0 += kThreads * V) pass_c(e0, std::true_type{});
    if (e0 < ne) pass_c(e0, std::false_type{});
    if (UPDATE) {
      for (int i0 = tid * P; i0 < rows; i0 += kThreads * P) {
        T v[P];
        const int cnt = rows - i0 < P ? rows - i0 : P;
        load_v(v, sc_s + i0, cnt, true);
        store_v(scaler_out + r0 + i0, v, cnt, vec);
      }
    }
    __syncthreads();  // the stage and the row buffers are free again
  }
  async_wait<0>();
  if (tid < k) partials[(int64_t)blockIdx.x * k + tid] = col_acc;
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

inline bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15u) == 0; }

// Checks a launch's tiling against ops/cavi.py:_k3_grid and launches it.
template <bool UPDATE, typename T, typename TabT>
cudaError_t launch_table(const T* a, const T* b, const T* colsum_other, double prior,
                         double scaler_shape, double add_scaler, T* shp, T* rte, TabT* tab,
                         T* scaler_new, T* partials, int64_t n, int64_t n_real, int k, int R,
                         int nblocks, cudaStream_t stream) {
  if (k <= 0 || k > kThreads || R <= 0 || R % 4 != 0 || ((int64_t)R * k) % 8 != 0 || n < 0 ||
      n_real < 0 || n_real > n)
    return cudaErrorInvalidValue;
  const int64_t ntiles = (n + R - 1) / R;
  const int64_t want = ntiles > 0 ? (ntiles + kTilesPerBlock - 1) / kTilesPerBlock : 1;
  if (nblocks != want) return cudaErrorInvalidValue;
  const TileSmem<UPDATE, T> L(R, k);
  const auto kernel = table_tile_kernel<UPDATE, T, TabT>;
  if (L.total > 48 * 1024) {
    // float64 at odd k above 128: tiles of 8 rows (R * k a multiple of 8),
    // up to 16 KB a table and ~80 KB a block; a block may ask for more than
    // the default 48 KB (227 KB on an H100)
    int dev = 0, most = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    if (L.total > most) return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return e;
  }
  const int vec = aligned16(a) && aligned16(b) && aligned16(shp) && aligned16(rte) &&
                  aligned16(tab) && aligned16(scaler_new);
  kernel<<<nblocks, kThreads, L.total, stream>>>(
      a, b, colsum_other, (T)prior, (T)scaler_shape, (T)add_scaler, shp, rte, tab, scaler_new,
      partials, n, n_real, k, R, vec);
  return cudaGetLastError();
}

template <typename T, typename TabT>
cudaError_t launch_update(const T* sums, const T* scaler_old, const T* colsum_other, double prior,
                          double scaler_shape, double add_scaler, T* shp, T* rte, TabT* tab,
                          T* scaler_new, T* partials, int64_t n, int64_t n_real, int k, int R,
                          int nblocks, cudaStream_t stream) {
  return launch_table<true, T, TabT>(sums, scaler_old, colsum_other, prior, scaler_shape,
                                     add_scaler, shp, rte, tab, scaler_new, partials, n, n_real,
                                     k, R, nblocks, stream);
}

template <typename T, typename TabT>
cudaError_t launch_derive(const T* shp, const T* rte, TabT* tab, T* partials, int64_t n, int k,
                          int R, int nblocks, cudaStream_t stream) {
  return launch_table<false, T, TabT>(shp, rte, nullptr, 0.0, 0.0, 0.0, nullptr, nullptr, tab,
                                      nullptr, partials, n, n, k, R, nblocks, stream);
}

template <typename T>
cudaError_t launch_finish(const T* partials, T* colsum, int nblocks, int k, cudaStream_t stream) {
  if (k <= 0 || nblocks <= 0) return cudaErrorInvalidValue;
  colsum_finish_kernel<T><<<k, kWarp, 0, stream>>>(partials, colsum, nblocks, k);
  return cudaGetLastError();
}

// The digamma K3 used up to its tiled form: the same recurrence and
// series, with a reciprocal at each step of the shift.  Kept only as the
// yardstick that digamma_eval measures the kernels' digamma against.
__device__ __forceinline__ float digamma_stepwise(float x) {
  if (!(x > 0.f)) return x == 0.f ? -INFINITY : NAN;
  float r = 0.f;
  while (x < 6.f) {
    r -= 1.f / x;
    x += 1.f;
  }
  const float f = 1.f / (x * x);
  const float t =
      f * (-1.f / 12.f + f * (1.f / 120.f + f * (-1.f / 252.f + f * (1.f / 240.f + f * (-1.f / 132.f)))));
  return r + logf(x) - 0.5f / x + t;
}

__device__ __forceinline__ double digamma_stepwise(double x) {
  if (!(x > 0.0)) return x == 0.0 ? -INFINITY : NAN;
  double r = 0.0;
  while (x < 10.0) {
    r -= 1.0 / x;
    x += 1.0;
  }
  const double f = 1.0 / (x * x);
  const double t =
      f * (-1.0 / 12.0 +
           f * (1.0 / 120.0 +
                f * (-1.0 / 252.0 +
                     f * (1.0 / 240.0 + f * (-1.0 / 132.0 + f * (691.0 / 32760.0 + f * (-1.0 / 12.0)))))));
  return r + log(x) - 0.5 / x + t;
}

template <typename T>
__global__ void digamma_eval_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
                                    int stepwise) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = stepwise ? digamma_stepwise(x[i]) : digamma(x[i]);
}

template <typename T>
cudaError_t launch_digamma(const T* x, T* out, int64_t n, int stepwise, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t blocks = (n + kThreads - 1) / kThreads < 4096 ? (n + kThreads - 1) / kThreads : 4096;
  digamma_eval_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(x, out, n, stepwise);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_table_update_f32(const float* sums, const float* scaler_old, const float* colsum_other,
                         double prior, double scaler_shape, double add_scaler, float* shp,
                         float* rte, float* tab, float* scaler_new, float* partials, int64_t n,
                         int64_t n_real, int32_t k, int32_t R, int32_t nblocks, void* stream) {
  return hpf::launch_update(sums, scaler_old, colsum_other, prior, scaler_shape, add_scaler, shp,
                            rte, tab, scaler_new, partials, n, n_real, k, R, nblocks,
                            (cudaStream_t)stream);
}

int hpf_table_update_f64(const double* sums, const double* scaler_old,
                         const double* colsum_other, double prior, double scaler_shape,
                         double add_scaler, double* shp, double* rte, double* tab,
                         double* scaler_new, double* partials, int64_t n, int64_t n_real,
                         int32_t k, int32_t R, int32_t nblocks, void* stream) {
  return hpf::launch_update(sums, scaler_old, colsum_other, prior, scaler_shape, add_scaler, shp,
                            rte, tab, scaler_new, partials, n, n_real, k, R, nblocks,
                            (cudaStream_t)stream);
}

int hpf_table_derive_f32(const float* shp, const float* rte, float* tab, float* partials,
                         int64_t n, int32_t k, int32_t R, int32_t nblocks, void* stream) {
  return hpf::launch_derive(shp, rte, tab, partials, n, k, R, nblocks, (cudaStream_t)stream);
}

int hpf_table_derive_f64(const double* shp, const double* rte, double* tab, double* partials,
                         int64_t n, int32_t k, int32_t R, int32_t nblocks, void* stream) {
  return hpf::launch_derive(shp, rte, tab, partials, n, k, R, nblocks, (cudaStream_t)stream);
}

// bfloat16 tab, everything else in the state dtype
int hpf_table_update_bf16_f32(const float* sums, const float* scaler_old,
                              const float* colsum_other, double prior, double scaler_shape,
                              double add_scaler, float* shp, float* rte, __nv_bfloat16* tab,
                              float* scaler_new, float* partials, int64_t n, int64_t n_real,
                              int32_t k, int32_t R, int32_t nblocks, void* stream) {
  return hpf::launch_update(sums, scaler_old, colsum_other, prior, scaler_shape, add_scaler, shp,
                            rte, tab, scaler_new, partials, n, n_real, k, R, nblocks,
                            (cudaStream_t)stream);
}

int hpf_table_update_bf16_f64(const double* sums, const double* scaler_old,
                              const double* colsum_other, double prior, double scaler_shape,
                              double add_scaler, double* shp, double* rte, __nv_bfloat16* tab,
                              double* scaler_new, double* partials, int64_t n, int64_t n_real,
                              int32_t k, int32_t R, int32_t nblocks, void* stream) {
  return hpf::launch_update(sums, scaler_old, colsum_other, prior, scaler_shape, add_scaler, shp,
                            rte, tab, scaler_new, partials, n, n_real, k, R, nblocks,
                            (cudaStream_t)stream);
}

int hpf_table_derive_bf16_f32(const float* shp, const float* rte, __nv_bfloat16* tab,
                              float* partials, int64_t n, int32_t k, int32_t R, int32_t nblocks,
                              void* stream) {
  return hpf::launch_derive(shp, rte, tab, partials, n, k, R, nblocks, (cudaStream_t)stream);
}

int hpf_table_derive_bf16_f64(const double* shp, const double* rte, __nv_bfloat16* tab,
                              double* partials, int64_t n, int32_t k, int32_t R, int32_t nblocks,
                              void* stream) {
  return hpf::launch_derive(shp, rte, tab, partials, n, k, R, nblocks, (cudaStream_t)stream);
}

int hpf_colsum_finish_f32(const float* partials, float* colsum, int32_t nblocks, int32_t k,
                          void* stream) {
  return hpf::launch_finish(partials, colsum, nblocks, k, (cudaStream_t)stream);
}

int hpf_colsum_finish_f64(const double* partials, double* colsum, int32_t nblocks, int32_t k,
                          void* stream) {
  return hpf::launch_finish(partials, colsum, nblocks, k, (cudaStream_t)stream);
}

// The kernels' digamma (stepwise = 0) or the stepwise form it replaced
// (1), elementwise: out[i] = digamma(x[i]).
int hpf_digamma_eval_f32(const float* x, float* out, int64_t n, int32_t stepwise, void* stream) {
  return hpf::launch_digamma(x, out, n, stepwise, (cudaStream_t)stream);
}

int hpf_digamma_eval_f64(const double* x, double* out, int64_t n, int32_t stepwise,
                         void* stream) {
  return hpf::launch_digamma(x, out, n, stepwise, (cudaStream_t)stream);
}

}  // extern "C"
