// AMLA MUL-by-ADD numerics for the Hopper kernels, one element at a time.
//
// Device counterparts of repro_torch/core/numerics.py (and of the JAX
// reference repro/core/numerics.py).  The int32 bit patterns must equal the
// reference's, so the floating-point steps of the state update use the
// explicitly rounded intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn): nvcc would
// otherwise contract a*b+c into one FMA and round once where the reference
// rounds twice.  expf/logf are the accurate library versions (the build
// never passes --use_fast_math).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace amla {

constexpr int kMantissaBits = 23;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMInit = -1.0e5f;
constexpr float kMClamp = 8.0e4f;
constexpr int kMinExpDelta = -30;

// Round-trip through bf16, round to nearest even (the paper's S16).
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element of a tensor of type T, as float.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// A value rounded to the matmul type TQ (the reference casts page strips and
// probabilities to the query dtype before each matmul).
template <typename TQ>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return bf16_round(x);
}

// n = round(-m / ln2) (half to even), inv_r = exp(n * ln2 + m).
__device__ __forceinline__ void round_scale_to_pow2(float m, int* n,
                                                    float* inv_r) {
  *n = __float2int_rn(__fdiv_rn(-m, kLn2));
  *inv_r = expf(__fadd_rn(__fmul_rn(static_cast<float>(*n), kLn2), m));
}

// round(2^23 * (max(delta_n, MIN_EXP_DELTA) + 1.5 * eps)), half to even.
__device__ __forceinline__ int pow2_int_increment(int delta_n, float eps) {
  float d = fmaxf(static_cast<float>(delta_n),
                  static_cast<float>(kMinExpDelta));
  d = __fadd_rn(d, __fmul_rn(1.5f, eps));
  return __float2int_rn(__fmul_rn(d, 8388608.0f));
}

// x * 2^(inc / 2^23) as an integer add on x's bits.  The add wraps as
// uint32 (a signed overflow would be undefined behaviour), the exponent
// delta is an arithmetic shift of the possibly negative increment, and a
// zero exponent field (zero or subnormal) or an exponent underflow flushes
// to +0 — the reference's guard on a platform that flushes subnormals.
__device__ __forceinline__ float apply_int_increment(float x, int inc) {
  const uint32_t i = __float_as_uint(x);
  const int e = static_cast<int>((i >> kMantissaBits) & 0xFFu);
  const int n_eff = static_cast<int>(
      (static_cast<int64_t>(inc) + (1 << (kMantissaBits - 1))) >>
      kMantissaBits);
  const float out = __uint_as_float(i + static_cast<uint32_t>(inc));
  return (e == 0 || e + n_eff <= 0) ? 0.0f : out;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace amla
