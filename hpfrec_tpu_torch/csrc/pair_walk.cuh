// The walk over (iu, ii) pairs that K11's predict_pairs and rowsum_dot
// (pair_ops.cu) and K5's llk sums (coo_llk.cu) share: pair_steps loads
// each step's rows and hands them to the caller (rowsum_dot adds them into
// column sums); pair_walk takes each pair's dot <Theta[iu], Beta[ii]> and
// hands it to the caller's visitor.
//
// What bounds it on the card: the gathers of two random k-wide rows a pair.
// A group of G lanes takes a pair (8 at k = 50 float32: 25 vectors of 8
// bytes a row over 8 lanes) and loads its rows in 16- or 8-byte vectors
// where k allows (one element at odd k: the scalar form).  A warp loads a
// step's pairs' rows (32 / G pairs, and more where small rows leave
// registers for them) before the first multiply-add, and the next step's
// indices (and values) while they arrive; a pair's lanes add with log2(G)
// shuffles.  Few registers a pair keep many warps an SM: on the H100 that
// gathered faster than 16 pairs a warp in flight (scripts/split_k2_k11.py
// turns, PERF.md).  The lane split is a function of k and the dtype alone
// (the callers pass 16-byte aligned tables), so a pair's dot has the same
// bits at any n.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace hpf {

// A group of G lanes a pair (G a power of two, the least with G * VPL >= k
// / VE; VPL = 4, or 8 above 128 vectors a row), VE elements a vector load;
// U pairs a group in flight (kPairRegs registers of rows a lane), so S =
// (32 / G) * min(U, G) <= 32 pairs a warp a step.
constexpr int kPairRegs = 16;

// Pairs a group has in flight a step: U rows of each table a lane, within
// kPairRegs registers.
template <typename T, int VE, int VPL>
__host__ __device__ constexpr int pair_step_u() {
  constexpr int kWords = (int)sizeof(Vec<T, VE>) / 4 * VPL * 2;  // both rows' registers a pair
  return kPairRegs / kWords > 1 ? kPairRegs / kWords : 1;
}

// The warp's pairs [first, last), in steps of S: each step loads every
// row of its pairs, then calls step(j0, t, b, ok, yv) on every lane, where
// t[u][q] / b[u][q] are vector q of this lane's share of round u's rows
// (vector l + G * q of the row, valid where it is < k / VE), ok[u] whether
// round u holds a pair (pair j0 + u * groups + g) and yv[u] its value.
// With a value stream `y` (kY), a pair whose value is not > 0 is padding:
// its rows are not read and it is not ok.
template <typename T, int VE, int VPL, bool kY, typename Step>
__device__ __forceinline__ void pair_steps(const T* __restrict__ theta,
                                           const T* __restrict__ beta,
                                           const int32_t* __restrict__ iu,
                                           const int32_t* __restrict__ ii,
                                           const T* __restrict__ y, int64_t first, int64_t last,
                                           int k, int log2g, Step&& step) {
  using In = Vec<T, VE>;
  constexpr int U = pair_step_u<T, VE, VPL>();
  const In* __restrict__ tv = reinterpret_cast<const In*>(theta);
  const In* __restrict__ bv = reinterpret_cast<const In*>(beta);
  const int lane = threadIdx.x & (kWarp - 1);
  const int G = 1 << log2g;
  const int groups = kWarp >> log2g;
  const int g = lane >> log2g;        // the lane's pair in a round
  const int l = lane & (G - 1);       // the lane in its group
  const int urun = U < G ? U : G;     // rounds a step
  const int S = groups * urun;        // pairs a step
  const int nv = k / VE;

  // a step's pair indices (and values), one a lane, coalesced; the next
  // step's are loaded while this step's rows are
  int32_t mu = 0, mi = 0;
  T my = T(0);
  if (lane < S && first + lane < last) {
    mu = iu[first + lane];
    mi = ii[first + lane];
    if (kY) my = y[first + lane];
  }
  for (int64_t j0 = first; j0 < last; j0 += S) {
    int32_t nu = 0, ni = 0;
    T ny = T(0);
    if (lane < S && j0 + S + lane < last) {
      nu = iu[j0 + S + lane];
      ni = ii[j0 + S + lane];
      if (kY) ny = y[j0 + S + lane];
    }
    // every row load of the step before the first use
    In t[U][VPL], b[U][VPL];
    bool ok[U];
    T yv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int slot = u * groups + g;
      const int64_t su = __shfl_sync(0xffffffffu, mu, slot & (kWarp - 1));
      const int64_t si = __shfl_sync(0xffffffffu, mi, slot & (kWarp - 1));
      yv[u] = kY ? __shfl_sync(0xffffffffu, my, slot & (kWarp - 1)) : T(0);
      ok[u] = u < urun && j0 + slot < last && (!kY || yv[u] > T(0));
#pragma unroll
      for (int q = 0; q < VPL; ++q) {
        const int c = l + G * q;
        if (ok[u] && c < nv) {
          t[u][q] = tv[su * nv + c];
          b[u][q] = bv[si * nv + c];
        }
      }
    }
    step(j0, t, b, ok, yv);
    mu = nu;
    mi = ni;
    my = ny;
  }
}

// Each pair's dot: visit(j, dot, y_j) runs on the first lane of pair j's
// group.
template <typename T, int VE, int VPL, bool kY, typename Visit>
__device__ __forceinline__ void pair_walk(const T* __restrict__ theta,
                                          const T* __restrict__ beta,
                                          const int32_t* __restrict__ iu,
                                          const int32_t* __restrict__ ii,
                                          const T* __restrict__ y, int64_t first, int64_t last,
                                          int k, int log2g, Visit&& visit) {
  constexpr int U = pair_step_u<T, VE, VPL>();
  const int lane = threadIdx.x & (kWarp - 1);
  const int G = 1 << log2g;
  const int groups = kWarp >> log2g;
  const int g = lane >> log2g;
  const int l = lane & (G - 1);
  const int nv = k / VE;
  pair_steps<T, VE, VPL, kY>(
      theta, beta, iu, ii, y, first, last, k, log2g,
      [&](int64_t j0, const auto& t, const auto& b, const auto& ok, const auto& yv) {
        T d[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          d[u] = T(0);
#pragma unroll
          for (int q = 0; q < VPL; ++q) {
            if (ok[u] && l + G * q < nv) {
#pragma unroll
              for (int e = 0; e < VE; ++e) d[u] += t[u][q].v[e] * b[u][q].v[e];
            }
          }
        }
        for (int o = G >> 1; o > 0; o >>= 1) {  // log2(G) shuffles a pair
#pragma unroll
          for (int u = 0; u < U; ++u) d[u] += __shfl_xor_sync(0xffffffffu, d[u], o);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ok[u] && l == 0) visit(j0 + u * groups + g, d[u], yv[u]);
      });
}

// The walk's grid: a warp takes `per_warp` consecutive pairs (a multiple
// of 32), a block kWarpsPerBlock warps.  The caller passes both (chosen
// from n alone, ops/metrics.py:_pairs_grid); this checks them and the
// tables' alignment.  With `spare`, blocks past the last pair are allowed
// (they walk nothing).
inline bool pair_grid_ok(int64_t n, int k, int64_t per_warp, int64_t nblocks, const void* theta,
                         const void* beta, bool spare = false) {
  const int64_t per_block = (int64_t)kWarpsPerBlock * per_warp;
  const int64_t need = per_warp > 0 ? (n + per_block - 1) / per_block : 0;
  return n > 0 && k > 0 && k <= 256 && per_warp > 0 && per_warp % kWarp == 0 &&
         (spare ? nblocks >= need && nblocks <= 0x7fffffffLL : nblocks == need) &&
         (uintptr_t)theta % 16 == 0 && (uintptr_t)beta % 16 == 0;
}

// Calls launch(VE, VPL, log2g) with VE and VPL as integral constants: the
// vector width is a function of k and the dtype alone.
template <typename T, typename Launch>
cudaError_t with_pair_form(int k, Launch&& launch) {
  const int ve = sizeof(T) == 4 && k % 4 == 0 ? 4 : k % 2 == 0 ? 2 : 1;
  const int nv = k / ve;
  const int vpl = nv <= 128 ? 4 : 8;
  int log2g = 0;
  while ((1 << log2g) * vpl < nv) ++log2g;
  if (log2g > 5) return cudaErrorInvalidValue;
  using std::integral_constant;
  if constexpr (sizeof(T) == 4) {
    if (ve == 4 && vpl == 4)
      return launch(integral_constant<int, 4>(), integral_constant<int, 4>(), log2g);
  }
  if (ve == 2 && vpl == 4)
    return launch(integral_constant<int, 2>(), integral_constant<int, 4>(), log2g);
  if (ve == 1 && vpl == 4)  // the scalar form: odd k
    return launch(integral_constant<int, 1>(), integral_constant<int, 4>(), log2g);
  if (ve == 1 && vpl == 8)
    return launch(integral_constant<int, 1>(), integral_constant<int, 8>(), log2g);
  return cudaErrorInvalidValue;
}

}  // namespace hpf
