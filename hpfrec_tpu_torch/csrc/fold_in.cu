// K10 — fold-in CAVI for one user with the item parameters frozen.
//
// Replaces hpfrec_tpu/ops/svi.py:user_factors_loop (svi.py:313-359), the
// jitted while_loop behind HPF.predict_factors and HPF.add_user
// (reference calc_user_factors, cython_loops.pxi:504-518).  Per iteration,
// over the user's P items with E[log beta] rows elogb (P, k):
//   logits[p] = (digamma(G_shp) - log(G_rte)) + elogb[p]
//   phi[p]    = (y[p] / sum(e[p])) e[p],  e[p] = exp(logits[p] - max(logits[p]))
//   G_rte     = k_shp / k_rte + beta_colsum
//   G_shp     = a + sum_p phi[p]
//   Theta'    = G_shp / G_rte;  k_rte = add_k_rte + sum(Theta')
//   stop when ||Theta' - Theta|| < stop_thr (strictly) or at maxiter
// and after the loop phi_norm[p] = e[p] / sum(e[p]) from the final G.
//
// What bounds it on the card: nothing of the card's width.  An iteration
// reads the P x k rows once (P k sizeof(T) bytes, L1/L2-resident after the
// first) and does ~10 flops and an exp per element plus k digammas; the
// loop is a chain of dependent iterations, so its time is latency and
// issue on one SM: the launch, the block barriers, the E step's exps,
// shuffles and divisions, and the update's chain (sums, divisions, norm,
// digammas).
//
// Design: the whole loop in one launch of one block of W warps, with no
// host round trip per iteration and two block barriers an iteration.
//  - Items (the E step): an item's k factors spread over a group of L
//    lanes, 4 a lane (L = 8 for k <= 32, 16 for k <= 64, 32 above; 8 a lane
//    above 128), so a warp holds 32 / L items at once and each shuffle
//    reduction serves all of them; each group keeps NI items' loads, row
//    maxima, exps and sums in flight together.  W grows with P up to 32
//    warps, so a heavy user's items spread over up to 1,024 threads.
//  - Each lane adds its items' phi rows in item order in registers; the
//    groups of a warp add theirs by xor shuffles (the same bits in every
//    lane), and each warp stores its row of k sums in shared memory.
//  - The update, one factor a lane of warps 0 .. KPL - 1: G_rte and its log
//    (they need only k_rte) before the E step; after the barrier the W rows
//    added in warp order, G_shp, Theta, the next digamma(G_shp) - log(G_rte)
//    into shared memory (the state stays there) and each warp's sums of
//    Theta and of its squared change; after the second barrier every warp
//    adds those KPL pairs in order into k_rte and the stop test (the same
//    bits in every thread, so the warps leave the loop together).
//  - W, L, NI and so the order of every sum are fixed by P, k and the
//    dtype: reruns are bit-identical (no atomics).
//  - The final phi_norm pass is written only when the caller asks for it
//    (phi_out not NULL).  Theta, G_shp, G_rte and the iteration count go to
//    one output buffer: out[0, k) Theta, [k, 2k) G_shp, [2k, 3k) G_rte, and
//    the count as an int32 at out + 3k (one element of T kept for it).
// digamma is common.cuh's (as K3's).
#include "common.cuh"

namespace hpf {

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

// The item layout for k up to 32 KPL: kLanes lanes an item, kPer factors
// a lane, kGroups items a warp at once, kItems items in flight a group, and
// the largest block.
template <int KPL, typename T>
struct FoldShape {
  static constexpr int kLanes = KPL <= 2 ? 8 * KPL : kWarp;
  static constexpr int kPer = KPL <= 4 ? 4 : 8;
  static constexpr int kGroups = kWarp / kLanes;
  static constexpr int kItems = kPer * (int)sizeof(T) <= 16 ? 2 : 1;
  static constexpr int kMaxWarps = kPer * (int)sizeof(T) <= 32 ? 32 : 16;
};

// One round of a group: the softmax rows of items base .. base + NI - 1
// (those below P; every lane of the warp calls it, for the shuffles) over
// the group's lanes (sub = lane in the group), their shuffle reductions
// interleaved.  With phi_out NULL, adds (y[p] / s[p])
// e[p] into acc in item order; else writes phi_out[p] = e[p] / s[p].
template <int L, int PER, int NI, typename T>
__device__ __forceinline__ void fold_round(const T* __restrict__ y, const T* __restrict__ elogb,
                                           const T (&eg)[PER], int64_t base, int64_t P, int k,
                                           int sub, T (&acc)[PER], T* __restrict__ phi_out) {
  T e[NI][PER], m[NI], s[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int64_t p = base + j < P ? base + j : P - 1;  // past P: a real row, not added
    const T* row = elogb + p * k;
    m[j] = T(-INFINITY);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int c = sub + L * q;
      e[j][q] = c < k ? eg[q] + row[c] : T(-INFINITY);
      m[j] = e[j][q] > m[j] ? e[j][q] : m[j];
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const T u = __shfl_xor_sync(0xffffffffu, m[j], o);
      m[j] = u > m[j] ? u : m[j];
    }
  }
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    s[j] = T(0);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int c = sub + L * q;
      e[j][q] = c < k ? dexp(e[j][q] - m[j]) : T(0);
      s[j] += e[j][q];
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < NI; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
  }
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int64_t p = base + j;
    if (p < P) {
      if (phi_out == nullptr) {
        const T scale = y[p] / s[j];
#pragma unroll
        for (int q = 0; q < PER; ++q) acc[q] += scale * e[j][q];
      } else {
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          const int c = sub + L * q;
          if (c < k) phi_out[p * k + c] = e[j][q] / s[j];
        }
      }
    }
  }
}

template <int KPL, typename T>
__global__ void __launch_bounds__(FoldShape<KPL, T>::kMaxWarps * kWarp)
    fold_in_kernel(const T* __restrict__ y, const T* __restrict__ elogb,
                   const T* __restrict__ beta_colsum, const T* __restrict__ theta0,
                   const T* __restrict__ g_shp0, const T* __restrict__ g_rte0, T k_rte0, T a,
                   T k_shp, T add_k_rte, int maxiter, T stop_thr, int64_t P, int k,
                   T* __restrict__ out, T* __restrict__ phi_out) {
  using S = FoldShape<KPL, T>;
  constexpr int L = S::kLanes, PER = S::kPer, NI = S::kItems;
  constexpr int Wk = kWarp * KPL;
  __shared__ T red[S::kMaxWarps][Wk];
  __shared__ T s_th[Wk], s_gshp[Wk], s_grte[Wk], s_eg[Wk], s_tpart[KPL], s_dpart[KPL];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int W = blockDim.x / kWarp;
  const int sub = lane % L;  // this lane's place in its item group
  // a warp's rounds start at warp_items + r * stride (the same count in
  // every lane, as the shuffles need); its group's items at + g_items
  const int64_t warp_items = (int64_t)warp * S::kGroups * NI;
  const int64_t stride = (int64_t)W * S::kGroups * NI;
  const int g_items = lane / L * NI;
  // the update: warp w < KPL takes factors 32 w .. 32 w + 31, one a lane
  const int cu = lane + kWarp * warp;
  const bool upd = warp < KPL && cu < k;
  const T cs = upd ? beta_colsum[cu] : T(0);

  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    s_th[c] = theta0[c];
    s_gshp[c] = g_shp0[c];
    s_grte[c] = g_rte0[c];
    s_eg[c] = digamma(g_shp0[c]) - dlog(g_rte0[c]);
  }
  T krte = k_rte0;  // every thread's, the same bits
  bool done = false;
  __syncthreads();

  T eg[PER];
  int it = 0;
  while (it < maxiter && !done) {
    // the update's G_rte and its log need only k_rte: ahead of the E step
    T grte = T(1), lg = T(0);
    if (upd) {
      grte = k_shp / krte + cs;
      lg = dlog(grte);
    }
    T acc[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int c = sub + L * q;
      eg[q] = c < k ? s_eg[c] : T(0);
      acc[q] = T(0);
    }
    for (int64_t base = warp_items; base < P; base += stride)
      fold_round<L, PER, NI>(y, elogb, eg, base + g_items, P, k, sub, acc, (T*)nullptr);
#pragma unroll
    for (int o = L; o < kWarp; o <<= 1) {
#pragma unroll
      for (int q = 0; q < PER; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
    }
    if (lane < L) {
#pragma unroll
      for (int q = 0; q < PER; ++q)
        if (sub + L * q < k) red[warp][sub + L * q] = acc[q];
    }
    __syncthreads();
    if (warp < KPL) {
      T t = T(0), d = T(0);
      if (upd) {
        T sphi = T(0);
        for (int w = 0; w < W; ++w) sphi += red[w][cu];
        const T gshp = a + sphi;
        t = gshp / grte;
        d = t - s_th[cu];
        s_th[cu] = t;
        s_gshp[cu] = gshp;
        s_grte[cu] = grte;
        s_eg[cu] = digamma(gshp) - lg;
      }
      t = warp_sum(t);
      d = warp_sum(d * d);
      if (lane == 0) {
        s_tpart[warp] = t;
        s_dpart[warp] = d;
      }
    }
    __syncthreads();
    T tsum = T(0), dsum = T(0);
#pragma unroll
    for (int w = 0; w < KPL; ++w) {
      tsum += s_tpart[w];
      dsum += s_dpart[w];
    }
    krte = add_k_rte + tsum;
    done = dsqrt(dsum) < stop_thr;
    ++it;
  }

  // the final normalized phi from the last G (s_eg holds its logits' shift)
  if (phi_out != nullptr) {
    T unused[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int c = sub + L * q;
      eg[q] = c < k ? s_eg[c] : T(0);
      unused[q] = T(0);
    }
    for (int64_t base = warp_items; base < P; base += stride)
      fold_round<L, PER, NI>(y, elogb, eg, base + g_items, P, k, sub, unused, phi_out);
  }
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    out[c] = s_th[c];
    out[k + c] = s_gshp[c];
    out[2 * k + c] = s_grte[c];
  }
  if (threadIdx.x == 0) *reinterpret_cast<int32_t*>(out + 3 * k) = it;
}

template <int KPL, typename T>
cudaError_t launch_fold_in(const T* y, const T* elogb, const T* beta_colsum, const T* theta0,
                           const T* g_shp0, const T* g_rte0, double k_rte0, double a,
                           double k_shp, double add_k_rte, int32_t maxiter, double stop_thr,
                           int64_t P, int32_t k, T* out, T* phi_out, cudaStream_t stream) {
  using S = FoldShape<KPL, T>;
  if (P < 0 || maxiter < 0) return cudaErrorInvalidValue;
  const int per_warp = S::kGroups * S::kItems;
  const int64_t want = (P + per_warp - 1) / per_warp;
  const int W = want < KPL ? KPL : want > S::kMaxWarps ? S::kMaxWarps : (int)want;
  fold_in_kernel<KPL, T><<<1, W * kWarp, 0, stream>>>(
      y, elogb, beta_colsum, theta0, g_shp0, g_rte0, (T)k_rte0, (T)a, (T)k_shp, (T)add_k_rte,
      maxiter, (T)stop_thr, P, k, out, phi_out);
  return cudaGetLastError();
}

}  // namespace hpf

extern "C" {

int hpf_fold_in_f32(const float* y, const float* elogb, const float* beta_colsum,
                    const float* theta0, const float* g_shp0, const float* g_rte0, double k_rte0,
                    double a, double k_shp, double add_k_rte, int32_t maxiter, double stop_thr,
                    int64_t P, int32_t k, float* out, float* phi_out, void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_fold_in, y, elogb, beta_colsum, theta0, g_shp0, g_rte0,
                   k_rte0, a, k_shp, add_k_rte, maxiter, stop_thr, P, k, out, phi_out,
                   (cudaStream_t)stream);
}

int hpf_fold_in_f64(const double* y, const double* elogb, const double* beta_colsum,
                    const double* theta0, const double* g_shp0, const double* g_rte0,
                    double k_rte0, double a, double k_shp, double add_k_rte, int32_t maxiter,
                    double stop_thr, int64_t P, int32_t k, double* out, double* phi_out,
                    void* stream) {
  HPF_DISPATCH_KPL(k, hpf::launch_fold_in, y, elogb, beta_colsum, theta0, g_shp0, g_rte0,
                   k_rte0, a, k_shp, add_k_rte, maxiter, stop_thr, P, k, out, phi_out,
                   (cudaStream_t)stream);
}

}  // extern "C"
