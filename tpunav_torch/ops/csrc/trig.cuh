// The RBPF's bearing and cell arithmetic as device functions: the same
// polynomial atan2, positive_mod and round_half_up as
// tpunav_torch/ops/trig.py (and tpunav/ops/trig.py), operation for
// operation, and the world-to-cell index of the kernels' endpoints.
//
// A cell's covering beam is round_half_up(bearing / δ) and many cells sit
// within an ulp of a half-beam edge, so the kernel must round exactly as the
// plain version does. Every multiply, add and divide here is an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn):
// nvcc never contracts those into a fused multiply-add. Constants are
// double literals rounded once to float, as Python floats are when they
// meet a float32 tensor.
#pragma once

#include <cuda_runtime.h>

namespace tpunav {

constexpr double kPi = 3.14159265358979323846;

__device__ __forceinline__ float atan_poly(float t) {
  const bool big = t > static_cast<float>(0.41421356237309503);
  const float one = 1.0f;
  const float tr = big ? __fdiv_rn(__fsub_rn(t, one), __fadd_rn(t, one)) : t;
  const float z = __fmul_rn(tr, tr);
  float r = __fmul_rn(static_cast<float>(8.05374449538e-2), z);
  r = __fsub_rn(r, static_cast<float>(1.38776856032e-1));
  r = __fmul_rn(r, z);
  r = __fadd_rn(r, static_cast<float>(1.99777106478e-1));
  r = __fmul_rn(r, z);
  r = __fsub_rn(r, static_cast<float>(3.33329491539e-1));
  r = __fmul_rn(__fmul_rn(r, z), tr);
  r = __fadd_rn(r, tr);
  return big ? __fadd_rn(r, static_cast<float>(kPi / 4.0)) : r;
}

__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float hi = fmaxf(ax, ay);
  const float lo = fminf(ax, ay);
  const float t = __fdiv_rn(lo, fmaxf(hi, static_cast<float>(1e-30)));
  float r = atan_poly(t);
  if (ay > ax) r = __fsub_rn(static_cast<float>(kPi / 2.0), r);
  if (x < 0.0f) r = __fsub_rn(static_cast<float>(kPi), r);
  return y < 0.0f ? -r : r;
}

// a mod period into [0, period); inv_period = float(1/period) and
// period = float(period), both rounded from double on the host.
__device__ __forceinline__ float positive_mod(float a, float period,
                                              float inv_period) {
  const float q = floorf(__fmul_rn(a, inv_period));
  const float m = __fsub_rn(a, __fmul_rn(q, period));
  return m >= period ? __fsub_rn(m, period) : fmaxf(m, 0.0f);
}

__device__ __forceinline__ float round_half_up(float a) {
  return floorf(__fadd_rn(a, 0.5f));
}

// The map cell of world coordinate e along one axis: floor((e − lo)/res),
// taken as a product with inv_res = float(1/res), clamped into [0, n).
// The clamp comes first (a clamp to integer bounds commutes with floor, and
// takes a NaN to 0 as fmaxf does), then the floor is one round-down add of
// 2^23, whose low mantissa bits are the integer: no conversion instruction,
// which issues at a quarter of the add rate (n ≤ 2^23). cell_bits returns
// the sum's bits, kCellBias + the index, for callers that fold the bias
// into an address.
constexpr unsigned kCellBias = 0x4B000000u;   // the bits of 2^23

__device__ __forceinline__ unsigned cell_bits(float e, float lo,
                                              float inv_res, int n) {
  const float f = fminf(fmaxf(__fmul_rn(__fsub_rn(e, lo), inv_res), 0.0f),
                        static_cast<float>(n - 1));
  return __float_as_uint(__fadd_rd(f, 8388608.0f));
}

__device__ __forceinline__ int cell_index(float e, float lo, float inv_res,
                                          int n) {
  return static_cast<int>(cell_bits(e, lo, inv_res, n) - kCellBias);
}

}  // namespace tpunav
