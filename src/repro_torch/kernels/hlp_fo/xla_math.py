"""XLA:CPU's float32 ``exp`` and ``log``, rounding for rounding, in torch.

The reference's ``jnp.exp`` / ``jnp.log`` are not libm's: XLA:CPU emits
each as a Cephes-style polynomial in float32 ``fmul`` / ``fadd``, and its
LLVM backend contracts a multiply and the add that takes its product into
one fused multiply-add (the instructions carry no ``contract`` flag; the
x86 object code holds ``vfmadd``).  Its runtime also runs the program with
denormals flushed: a denormal input reads as zero (``jnp.log(1e-40)`` is
-inf) and a denormal result is zero (``jnp.exp(-87.5)`` is 0).  The two
functions here follow that program (jax 0.9.0, read from
``XLA_FLAGS=--xla_dump_to``), one rounding for each of its instructions, so
that the first-order LP's choice entry takes the reference's
transcendentals (ROADMAP C6).  ``csrc/xla_math.cuh`` is the same pair as
CUDA device functions.

exp: clamp x to [-87.8, 88.8], n = floor(x log2 e + 0.5) clamped to
[-127, 127], a two-constant Cody-Waite reduction r = x - n C1 - n C2, a
degree-5 Horner polynomial and r + r² p(r) + 1, scaled by 2^n built in the
exponent field (n = -127 gives 0).

log: x raised to ``FLT_MIN``, split into a mantissa in [0.5, 1) and an
exponent, the mantissa folded above √½, then Cephes ``logf``'s degree-8
polynomial in three Horner chains (Estrin-style), and e ln 2 in two parts;
0 gives -inf, +inf gives +inf, a negative input or NaN gives the NaN
whose bits are all set.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["FLT_MIN", "fma", "ftz", "xla_exp_f32", "xla_log_f32"]


def _f(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


FLT_MIN = _f(0x00800000)
#: the NaN log gives (all bits set), as XLA ORs its invalid mask into the bits
LOG_NAN = _f(0xFFFFFFFF)
#: exp's constants, as float32 bit patterns
EXP_LO, EXP_HI = _f(0xC2AF999A), _f(0x42B1999A)          # -87.8, 88.8
LOG2E = _f(0x3FB8AA3B)
LN2_HI, LN2_LO = _f(0x3F318000), _f(0xB95E8083)          # 0.693359375, ...
EXP_P = tuple(map(_f, (0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1,
                       0x3E2AAAAA, 0x3F000000)))
#: log's constants: √½ and the three chains' coefficients
SQRT_HALF = _f(0x3F3504F3)
LOG_A = tuple(map(_f, (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A)))
LOG_B = tuple(map(_f, (0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50)))
LOG_C = tuple(map(_f, (0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)))


def fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The product of two float32 values is exact in float64 (24 + 24 bits);
    the float64 sum with ``c`` may round, and a second rounding to float32
    could then land on the wrong side of a float32 midpoint.  So the sum is
    rounded to odd first (an inexact float64 sum moves to the neighbour
    whose last bit is 1, found from TwoSum's exact error): a value rounded
    to odd at 53 bits rounds to 24 bits exactly as the exact value does
    (Boldo and Melquiond, 2008)."""
    p = a.double() * b.double()
    c = torch.as_tensor(c, dtype=torch.float32).double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    up = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf)
                         .to(s.dtype))
    s = torch.where((err != 0) & even & torch.isfinite(s), up, s)
    return s.float()


def ftz(v: torch.Tensor) -> torch.Tensor:
    """A denormal float32 flushed to zero of its sign, as XLA:CPU's
    runtime flushes every operand and result (DAZ and FTZ)."""
    return torch.where(v.abs() < FLT_MIN, v * 0.0, v)


def _f32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"XLA's float32 twins take float32; got {x.dtype}")
    return x


def xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` on float32 as XLA:CPU computes it, bit for bit."""
    x = ftz(_f32(x))
    x = torch.where(x < EXP_LO, EXP_LO, x)          # NaN passes
    x = torch.where(x > EXP_HI, EXP_HI, x)
    n = torch.floor(fma(x, torch.full_like(x, LOG2E), 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    r = fma(-n, torch.full_like(x, LN2_HI), x)
    r = fma(-n, torch.full_like(x, LN2_LO), r)
    p = torch.full_like(x, EXP_P[0])
    for k in EXP_P[1:]:
        p = fma(p, r, k)
    y = fma(p, r * r, r) + 1.0
    scale = ((torch.nan_to_num(n).to(torch.int32) + 127) << 23).view(
        torch.float32)
    return ftz(y * scale)


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` on float32 as XLA:CPU computes it, bit for bit."""
    x = ftz(_f32(x))
    bad = ~(x > 0)                                   # x <= 0 or NaN
    v = torch.where(x > FLT_MIN, x, FLT_MIN)
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    mant = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    low = mant < SQRT_HALF
    t = (mant - 1.0) + torch.where(low, mant, 0.0)
    e = e - torch.where(low, 1.0, 0.0)
    z = t * t
    y = z * t
    a, b, c = (torch.full_like(t, k[0]) for k in (LOG_A, LOG_B, LOG_C))
    for i in (1, 2):
        a, b, c = fma(a, t, LOG_A[i]), fma(b, t, LOG_B[i]), fma(c, t, LOG_C[i])
    q = fma(fma(a, y, b), y, c)
    q = fma(q, y, e * LN2_LO)
    r = fma(-z, torch.full_like(t, 0.5), t) + q
    r = fma(e, torch.full_like(t, LN2_HI), r)
    r = torch.where(bad, LOG_NAN, r)
    r = torch.where(x == 0, -torch.inf, r)
    return torch.where(x == torch.inf, torch.inf, r)
