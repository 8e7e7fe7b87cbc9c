"""Double-float ("df64") arithmetic: ~2x f32 precision from f32 words.

The reference validates its solvers to 1e-12 relative residual in f64 C++
(reference scripts/evaluate_reference_solver.py:15-47).  To reach the same
depth while the cycles run in f32 we represent a value as an unevaluated
sum ``hi + lo`` of two f32 words (|lo| <= ulp(hi)/2), giving ~48 bits of significand — enough to
*measure* residuals at 1e-12 relative while the multigrid correction solve
stays in fast native f32 (compiler/refine.py iterative refinement).

Algorithms: Knuth two-sum, Dekker/Veltkamp split + two-product (no FMA
dependency — XLA does not guarantee fused multiplies), Bailey double-float
add/mul.  All ops are elementwise jnp expressions: they jit, vmap, and run
on any device with no special-casing.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

#: Veltkamp split constant for f32 (2^12 + 1): splits a 24-bit significand
#: into two 12-bit halves whose products are exact in f32.
_SPLIT = 4097.0


def two_sum(a, b):
    """Exact addition: s + err == a + b with s = fl(a+b)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Exact addition assuming |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Exact multiplication: p + err == a * b with p = fl(a*b)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


DF = Tuple[jnp.ndarray, jnp.ndarray]


def df_zero_like(x) -> DF:
    z = jnp.zeros_like(x)
    return z, z


def df_from(x) -> DF:
    return x, jnp.zeros_like(x)


def df_add(a: DF, b: DF) -> DF:
    """Double-float + double-float (Bailey's accurate variant)."""
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return fast_two_sum(s, e)


def df_neg(a: DF) -> DF:
    return -a[0], -a[1]

def df_sub(a: DF, b: DF) -> DF:
    return df_add(a, df_neg(b))


def df_mul_f32(a: DF, c) -> DF:
    """Double-float * f32 scalar/array."""
    p, e = two_prod(a[0], c)
    e = e + a[1] * c
    return fast_two_sum(p, e)


def df_mul(a: DF, b: DF) -> DF:
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return fast_two_sum(p, e)


def df_sum(a: DF) -> DF:
    """Sum all elements of a df64 array into a df64 scalar (pairwise via
    jnp.sum on each word would lose the compensation, so accumulate the
    words' sums with two_sum and fold the f32 reduction errors into lo;
    adequate for norm measurement at 1e-14 relative)."""
    # compensated reduction: sort-free Neumaier over a flattened array
    # would be O(n) sequential; instead sum hi and lo separately in f64-ish
    # chunks: jnp.sum promotes pairwise, keeping error ~sqrt(n) ulp of the
    # TOTAL, which the lo-word absorbs at the 2^-24 level.
    hs = jnp.sum(a[0])
    ls = jnp.sum(a[1])
    return fast_two_sum(hs, ls)


def df_norm2_sq(a: DF) -> DF:
    """Squared 2-norm of a df64 array as a df64 scalar."""
    sq_hi, sq_lo = df_mul(a, a)
    return df_sum((sq_hi, sq_lo))


def df_to_float(a: DF):
    """Collapse to the nearest representable f32 (for device-side use)."""
    return a[0] + a[1]


# -- transcendental: df64 exp -----------------------------------------------
# f32 exp has ~1 ulp (6e-8) relative error — far above the df64 target.
# Standard range reduction: x = k*ln2 + r with |r| <= ln2/2, exp(r) by a
# 13-term Taylor series evaluated in df Horner form (max truncation
# 0.347^13/13! ~ 2e-16), then an exact 2^k scale.  Nonlinear residuals
# (FAS gamma*exp(u)*u) need this to measure 1e-10 on hardware.

import math as _math

import numpy as np

_LN2 = 0.6931471805599453
_LN2_HI = np.float32(_LN2)
_LN2_LO = np.float32(_LN2 - float(_LN2_HI))
_INV_LN2 = np.float32(1.0 / _LN2)

#: df-split Taylor coefficients 1/13!, 1/12!, ..., 1/1!, 1/0! (Horner order)
_EXP_COEFFS = []
for _n in range(13, -1, -1):
    _c = 1.0 / _math.factorial(_n)
    _EXP_COEFFS.append((np.float32(_c), np.float32(_c - float(np.float32(_c)))))


def df_exp(a: DF) -> DF:
    """exp of a df64 value, ~1e-15 relative error for |a| < 80."""
    k = jnp.round(a[0] * _INV_LN2)
    kln2 = df_mul_f32((jnp.full_like(a[0], _LN2_HI),
                       jnp.full_like(a[0], _LN2_LO)), k)
    r = df_sub(a, kln2)
    # Horner over df coefficients 1/13!, ..., 1/1!, 1
    acc = (jnp.full_like(a[0], _EXP_COEFFS[0][0]),
           jnp.full_like(a[0], _EXP_COEFFS[0][1]))
    for chi, clo in _EXP_COEFFS[1:]:
        acc = df_mul(acc, r)
        acc = df_add(acc, (jnp.full_like(a[0], chi),
                           jnp.full_like(a[0], clo)))
    s = jnp.exp2(k)          # exact power of two
    return acc[0] * s, acc[1] * s
