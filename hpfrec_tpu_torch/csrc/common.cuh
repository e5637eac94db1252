// Shared device helpers of the hpfrec_tpu_torch kernels.
//
// Every kernel maps one warp to one row (a table row or an ELL segment);
// a row's k factors are spread over the 32 lanes, KPL = ceil(k/32)
// elements per lane, held in registers.  Dot products and row maxima are
// xor-butterfly shuffle reductions: every lane ends with the same bits, so
// a value that all lanes use (a phi denominator, a row max) is uniform.
// No kernel uses atomics, so every result is bit-identical from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hpf {

// Table storage to arithmetic type: a plain cast, but bfloat16 widens
// exactly through its intrinsic.
template <typename A, typename S>
__device__ __forceinline__ A widen(S x) {
  return (A)x;
}
template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Arithmetic type to table storage.  float64 -> bfloat16 rounds through
// float32 (two round-to-nearest-even steps), as PyTorch's and XLA's CPU
// conversions do; a single direct rounding (__double2bfloat16) would
// differ on values within 2^-30 of a bfloat16 rounding midpoint.
template <typename S, typename A>
__device__ __forceinline__ S narrow(A x) {
  return (S)x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, double>(double x) {
  return __float2bfloat16_rn((float)x);
}

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;  // hpfrec_tpu_torch/_cuda WARPS_PER_BLOCK
constexpr int kThreads = kWarp * kWarpsPerBlock;

// Elements per lane for k factors: the kernels are instantiated for
// k <= 32, 64, 128 and 256; 0 = unsupported.
inline int kpl_for(int k) {
  return k <= 0 ? 0 : k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : k <= 256 ? 8 : 0;
}

// VE consecutive elements of T as one aligned load or store (8 or 16
// bytes: LDG/STG.64 or .128; 32 bytes of double are two 16-byte accesses).
template <typename T, int VE>
struct alignas(sizeof(T) * VE) Vec {
  T v[VE];
};

// The widest vector of at most 16 bytes a lane that tiles rows of k
// elements of each of the given sizes (k * size a multiple of the vector's
// bytes), with every base address aligned to it; 1 when none does.
__host__ inline int vec_elems(int k, int max_ve, const void* const* ptrs, const int* sizes,
                              int n) {
  for (int ve = max_ve; ve > 1; ve /= 2) {
    bool ok = k % ve == 0;
    for (int i = 0; i < n && ok; ++i)
      ok = (uintptr_t)ptrs[i] % ((uintptr_t)ve * sizes[i]) == 0;
    if (ok) return ve;
  }
  return 1;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The 32-lane sums of G values a lane (G = 4 or 8) at the cost of about one
// warp_sum: lane l ends with the sum of value l / (32 / G) (so value u's sum
// is on lanes u * 32 / G ..).  The first log2(G) levels of the butterfly
// trade halves of the values with the partner lane instead of all of them;
// every level adds the same pairs as warp_sum adds, so each sum has
// warp_sum's bits.
template <int G, typename T>
__device__ __forceinline__ T transposed_sums(const T (&v)[G], int lane) {
  static_assert(G == 4 || G == 8, "transposed_sums: G is 4 or 8");
  T e[G / 2];
  const bool h16 = lane & 16;
#pragma unroll
  for (int i = 0; i < G / 2; ++i) {
    const T keep = h16 ? v[i + G / 2] : v[i];
    e[i] = keep + __shfl_xor_sync(0xffffffffu, h16 ? v[i] : v[i + G / 2], 16);
  }
  const bool h8 = lane & 8;
  T r;
  if constexpr (G == 8) {
    T f[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const T keep = h8 ? e[i + 2] : e[i];
      f[i] = keep + __shfl_xor_sync(0xffffffffu, h8 ? e[i] : e[i + 2], 8);
    }
    const bool h4 = lane & 4;
    r = (h4 ? f[1] : f[0]) + __shfl_xor_sync(0xffffffffu, h4 ? f[0] : f[1], 4);
    r += __shfl_xor_sync(0xffffffffu, r, 2);
  } else {
    r = (h8 ? e[1] : e[0]) + __shfl_xor_sync(0xffffffffu, h8 ? e[0] : e[1], 8);
    r += __shfl_xor_sync(0xffffffffu, r, 4);
    r += __shfl_xor_sync(0xffffffffu, r, 2);
  }
  r += __shfl_xor_sync(0xffffffffu, r, 1);
  return r;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// Asynchronous global -> shared copies (cp.async, sm_80 and later): 16
// bytes (.cg, L2 only) or one 4- or 8-byte element (.ca); a group is
// committed and waited for as a whole.
__device__ __forceinline__ void async_copy16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
template <int N>
__device__ __forceinline__ void async_copy_elem(void* smem, const void* gmem) {
  static_assert(N == 4 || N == 8, "async_copy_elem: 4 or 8 bytes");
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N)
               : "memory");
}
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlgamma(float x) { return lgammaf(x); }
__device__ __forceinline__ double dlgamma(double x) { return lgamma(x); }

// digamma(x) for x > 0 (CUDA's math library has none).  Away from its
// positive root x0 = 1.46163214496836..., the recurrence psi(x) = psi(x + n)
// - sum_{i<n} 1/(x + i) up to y = x + n >= X0, then the asymptotic series
// ln y - 1/(2y) - sum_j B_2j / (2j y^2j).  The shift's sum is kept as one
// fraction p / q (p' = p (x+i) + q, q' = q (x+i): no reciprocal a step).
// The float form carries p and q in double (exact steps), takes the shift
// as six predicated steps and divides once, 1 / (q y), for both p / q and
// 1 / y; the double form loops to X0 and divides twice.  Float stops the
// series at y^-10 with X0 = 6 (next term < 1e-9), double at y^-14 with
// X0 = 10 (< 1e-16).  Near the root the recurrence and the series cancel
// to a small result; there (|x - x0| < 0.3) the Taylor series psi(x0 + d)
// = sum_n c_n d^n is used instead, with d = (x - x0_hi) - x0_lo and c_n =
// psi^(n)(x0) / n! (mpmath: polygamma(n, x0) / factorial(n)), 11 terms in
// float, 25 in double (the next term < 2^-25 and 2^-54 of the result at
// |d| = 0.3).  The float form has no branch (both results are computed and
// one selected), so a caller's unrolled loop interleaves several of them.
// x = 0 gives -inf; x < 0 and NaN give NaN (the shapes it is called on are
// prior + non-negative sums, always > 0).  chip_smoke.py (phase 3) and
// scripts/split_k3_k4.py measure its error against scipy beside the
// stepwise form it replaced (digamma_stepwise, table_update.cu).
__device__ __forceinline__ float digamma(float x) {
  const float d = (x - 1.4616321325302124f) - 1.243815006546356e-08f;
  constexpr float c[11] = {0.9676722454476212f,    -0.4427631689835921f,  0.258499760955651f,
                           -0.16394270544240652f,  0.10782405069126237f,  -0.07219956125645471f,
                           0.04880428816414311f,   -0.03316112647484736f, 0.022597648232218104f,
                           -0.01542476590494896f,  0.010538791616612175f};
  float s = c[10];
#pragma unroll
  for (int i = 9; i >= 0; --i) s = fmaf(s, d, c[i]);
  s *= d;
  double y = x, p = 0.0, q = 1.0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (y < 6.0) {
      p = fma(p, y, q);
      q *= y;
      y += 1.0;
    }
  }
  const float z = (float)y;
  const float qf = (float)q;
  const float one = 1.f / (qf * z);  // the one division: 1/z = q one, p/q = p z one
  const float inv = qf * one;
  const float f = inv * inv;
  const float t =
      f * (-1.f / 12.f + f * (1.f / 120.f + f * (-1.f / 252.f + f * (1.f / 240.f + f * (-1.f / 132.f)))));
  const float r = ((-((float)p * z * one) + logf(z)) - 0.5f * inv) + t;
  const float v = fabsf(d) < 0.3f ? s : r;
  return x > 0.f ? v : x == 0.f ? -INFINITY : NAN;
}

__device__ __forceinline__ double digamma(double x) {
  if (!(x > 0.0)) return x == 0.0 ? -INFINITY : NAN;
  const double d = (x - 1.4616321449683622) - 9.549995429965697e-17;
  if (fabs(d) < 0.3) {
    constexpr double c[25] = {
        0.9676722454476212,      -0.4427631689835921,      0.258499760955651,
        -0.16394270544240652,    0.10782405069126237,      -0.07219956125645471,
        0.04880428816414311,     -0.03316112647484736,     0.022597648232218104,
        -0.01542476590494896,    0.010538791616612175,     -0.007204534386356869,
        0.004926781395729853,    -0.003369801655439328,    0.002305126326734928,
        -0.0015769367714301972,  0.0010788252019162967,    -0.0007380709389960052,
        0.000504953265834602,    -0.0003454680251063077,   0.00023635601564027053,
        -0.00016170622091974803, 0.0001106337276874741,    -7.569179582195066e-05,
        5.178575795222081e-05};
    double s = c[24];
#pragma unroll
    for (int i = 23; i >= 0; --i) s = fma(s, d, c[i]);
    return s * d;
  }
  double p = 0.0, q = 1.0;
  while (x < 10.0) {
    p = fma(p, x, q);
    q *= x;
    x += 1.0;
  }
  const double inv = 1.0 / x;
  const double f = inv * inv;
  const double t =
      f * (-1.0 / 12.0 +
           f * (1.0 / 120.0 +
                f * (-1.0 / 252.0 +
                     f * (1.0 / 240.0 + f * (-1.0 / 132.0 + f * (691.0 / 32760.0 + f * (-1.0 / 12.0)))))));
  return ((-(p / q) + log(x)) - 0.5 * inv) + t;
}

// One slot's llk pieces (hpfrec_tpu/ops/metrics.py:36-47): the terms in T,
// as the JAX version computes them, accumulated in double.  Callers pass
// only slots with y > 0.
template <typename T>
__device__ __forceinline__ void llk_add(T y, T yhat, int full_llk, double& ll, double& se,
                                        double& sp) {
  T l = y * dlog(yhat > T(0) ? yhat : T(1));
  if (full_llk) l -= dlgamma(y + T(1));
  const T e = y - yhat;
  ll += (double)l;
  se += (double)(e * e);
  sp += (double)yhat;
}

// The block's (ll, se, sp) partial: lane 0 of each warp holds its warp's
// sums; the warps are added in warp order into partials[blockIdx.x].
// Every thread of the block must call it.
__device__ __forceinline__ void llk_block_store(double ll, double se, double sp,
                                                double* __restrict__ partials) {
  __shared__ double red[kWarpsPerBlock][3];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  if (lane == 0) {
    red[warp][0] = ll;
    red[warp][1] = se;
    red[warp][2] = sp;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) s += red[w][threadIdx.x];
    partials[(int64_t)blockIdx.x * 3 + threadIdx.x] = s;
  }
}

}  // namespace hpf

// One switch over the supported elements-per-lane counts; FN is a function
// template whose first template parameter is KPL.
#define HPF_DISPATCH_KPL(k, FN, ...)      \
  switch (::hpf::kpl_for(k)) {            \
    case 1: return FN<1>(__VA_ARGS__);    \
    case 2: return FN<2>(__VA_ARGS__);    \
    case 4: return FN<4>(__VA_ARGS__);    \
    case 8: return FN<8>(__VA_ARGS__);    \
    default: return cudaErrorInvalidValue; \
  }
