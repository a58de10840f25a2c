// XLA:CPU's float32 exp and log as device functions, rounding for
// rounding: the transcendentals of the reference's jitted first-order LP
// (src/repro/core/hlp_jax.py::_solve_choice), which the choice entry of
// hlp_fo_sm90.cu takes in place of the card's expf / logf.  The torch twin
// is kernels/hlp_fo/xla_math.py (xla_exp_f32, xla_log_f32), which holds
// the derivation: each is the Cephes-style polynomial XLA emits, every
// multiply feeding an add contracted into one fused multiply-add as its
// LLVM backend contracts them, and every operand and result flushed to zero
// where it is denormal, as XLA:CPU's runtime runs (DAZ and FTZ).  Every op
// names its rounding (__fmul_rn / __fadd_rn / __fsub_rn / __fmaf_rn), so
// nvcc neither contracts nor reorders them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace xla_math {

constexpr float FLT_MIN_F = 1.17549435e-38f;   // 0x00800000

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < FLT_MIN_F ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ float bits_f(unsigned int b) { return __uint_as_float(b); }

// jnp.exp(x) on float32 as XLA:CPU computes it.
__device__ __forceinline__ float xla_exp_f32(float x) {
  x = ftz(x);
  const float lo = bits_f(0xC2AF999Au), hi = bits_f(0x42B1999Au);   // -87.8, 88.8
  x = x < lo ? lo : x;   // NaN passes
  x = x > hi ? hi : x;
  float n = floorf(__fmaf_rn(x, bits_f(0x3FB8AA3Bu), 0.5f));         // x log2(e) + 0.5
  n = n < -127.0f ? -127.0f : n;
  n = n > 127.0f ? 127.0f : n;
  float r = __fmaf_rn(-n, bits_f(0x3F318000u), x);                    // x - n ln2 (hi)
  r = __fmaf_rn(-n, bits_f(0xB95E8083u), r);                          // - n ln2 (lo)
  float p = bits_f(0x39506967u);
  p = __fmaf_rn(p, r, bits_f(0x3AB743CEu));
  p = __fmaf_rn(p, r, bits_f(0x3C088908u));
  p = __fmaf_rn(p, r, bits_f(0x3D2AA9C1u));
  p = __fmaf_rn(p, r, bits_f(0x3E2AAAAAu));
  p = __fmaf_rn(p, r, 0.5f);
  const float y = __fadd_rn(__fmaf_rn(p, __fmul_rn(r, r), r), 1.0f);
  const int ni = isnan(n) ? 0 : static_cast<int>(n);
  const float scale = __int_as_float((ni + 127) << 23);               // 2^n; n = -127 gives 0
  return ftz(__fmul_rn(y, scale));
}

// jnp.log(x) on float32 as XLA:CPU computes it.
__device__ __forceinline__ float xla_log_f32(float x) {
  x = ftz(x);
  const bool bad = !(x > 0.0f);   // x <= 0 or NaN
  const float v = x > FLT_MIN_F ? x : FLT_MIN_F;
  const int b = __float_as_int(v);
  float e = __fadd_rn(static_cast<float>((b >> 23) - 127), 1.0f);
  const float mant = __int_as_float((b & 0x807FFFFF) | 0x3F000000);   // [0.5, 1)
  const bool low = mant < bits_f(0x3F3504F3u);                        // sqrt(1/2)
  const float t = __fadd_rn(__fsub_rn(mant, 1.0f), low ? mant : 0.0f);
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float z = __fmul_rn(t, t);
  const float y = __fmul_rn(z, t);
  float a = __fmaf_rn(bits_f(0x3D9021BBu), t, bits_f(0xBDEBD1B8u));
  float c2 = __fmaf_rn(bits_f(0xBDFE5D4Fu), t, bits_f(0x3E11E9BFu));
  float c3 = __fmaf_rn(bits_f(0x3E4CCEACu), t, bits_f(0xBE7FFFFCu));
  a = __fmaf_rn(a, t, bits_f(0x3DEF251Au));
  c2 = __fmaf_rn(c2, t, bits_f(0xBE2AAE50u));
  c3 = __fmaf_rn(c3, t, bits_f(0x3EAAAAAAu));
  float q = __fmaf_rn(__fmaf_rn(a, y, c2), y, c3);
  q = __fmaf_rn(q, y, __fmul_rn(e, bits_f(0xB95E8083u)));            // + e ln2 (lo)
  float r = __fadd_rn(__fmaf_rn(-z, 0.5f, t), q);
  r = __fmaf_rn(e, bits_f(0x3F318000u), r);                           // + e ln2 (hi)
  if (bad) r = __uint_as_float(0xFFFFFFFFu);   // XLA ORs its invalid mask in
  if (x == 0.0f) r = -INFINITY;
  if (x == INFINITY) r = INFINITY;
  return r;
}

}  // namespace xla_math
