"""Deep-convergence solves with f32 cycles: double-float iterative
refinement around the native multigrid cycle.

The reference validates solvers to 1e-12 (linear) / 1e-10 (FAS) relative
residual in f64 generated C++ (reference
scripts/evaluate_reference_solver.py:15-47, FAS_2D_Basic knowledge file).
An f32 V-cycle stalls at ~1e-6/1e-7 relative — the evaluator
extrapolates below that via log(eps)/log(rho)
(evaluation/evaluator.py).  This module closes the loop ON HARDWARE:

* the *solution* is carried as a double-float pair ``u = u_hi + u_lo``
  (ops/df64: ~48-bit significand, pure f32 arithmetic);
* each outer step measures the df64 residual ``r = b - A u`` exactly
  enough to see 1e-14, then solves the *correction* equation
  ``A e = hi(r)`` with a handful of native f32 V-cycles;
* ``u += e`` in df64.  Classic mixed-precision iterative refinement:
  every outer step multiplies the residual by the f32 cycle's reduction
  until the df64 precision floor (~1e-13 relative) is reached.

Supports the scalar constant-stencil problems (Poisson-like) and the FAS
nonlinear operator A(u) = L u + gamma * exp(u) * u, where the correction
solve linearizes around the current iterate (one outer Newton step per
refinement pass).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..ir import base, system
from ..ops import df64
from ..stencils.constant import Stencil
from .lower import LoweredCycle


def _constant_scalar_stencil(lowered: LoweredCycle) -> Stencil:
    op = lowered.operator
    entries = op.entries if isinstance(op, system.Operator) else [[op]]
    if len(entries) != 1 or len(entries[0]) != 1:
        raise NotImplementedError(
            "df64 refinement supports single-field problems")
    st = entries[0][0].generate_stencil()
    if st is None or not hasattr(st, "entries"):
        raise NotImplementedError("operator has no constant stencil")
    return st


def _df_scalar(v: float, like):
    """An f64 scalar as a broadcast df64 pair."""
    hi = np.float32(v)
    lo = np.float32(float(v) - float(hi))
    return (jnp.full_like(like, hi), jnp.full_like(like, lo))


def _df_coefficients(stencil: Stencil):
    """Each f64 stencil value as a (hi, lo) pair of f32 words, so
    non-f32-representable coefficients keep their full precision."""
    out = []
    for offset, value in stencil.entries:
        v = float(value)
        hi = np.float32(v)
        lo = np.float32(v - float(hi))
        out.append((tuple(offset), float(hi), float(lo)))
    return out


def apply_constant_df(stencil_df, radius, u_df, shape):
    """(A u) in df64 for a constant stencil, Dirichlet halo (mirrors
    ops/apply.apply_constant's padding semantics word-by-word)."""
    pad = [(r, r) for r in radius]
    hp = jnp.pad(u_df[0], pad)
    lp = jnp.pad(u_df[1], pad)
    acc = None
    for offset, chi, clo in stencil_df:
        index = tuple(slice(r + o, r + o + n)
                      for r, o, n in zip(radius, offset, shape))
        term = df64.df_mul((hp[index], lp[index]),
                           (jnp.float32(chi), jnp.float32(clo)))
        acc = term if acc is None else df64.df_add(acc, term)
    return acc


def scalar_residual_df_fn(stencil: Stencil, nl=None):
    """Jitted ``(u_hi, u_lo, b) -> (r_hi, r_lo)``: the TRUE residual
    ``b - A u`` of a scalar constant-stencil operator (optionally plus the
    FAS exp-nonlinearity ``gamma * exp(u) * u``) in compensated df64
    arithmetic.  The measurement backbone of deep-convergence protocols on
    the f32-only chip (reference residual parsing:
    exastencils_FAS.py:370-394)."""
    st_df = _df_coefficients(stencil)
    radius = stencil.max_offsets

    @jax.jit
    def residual_df(uh, ul, b):
        shape = b.shape
        au = apply_constant_df(st_df, radius, (uh, ul), shape)
        if nl is not None:
            # g(u) = gamma * exp(u) * u entirely in df64 — the f32 exp's
            # ~1 ulp error (6e-8 relative) would floor the residual at
            # ~1e-6 absolute, above the 1e-10 target (df64.df_exp: range
            # reduction + df Taylor, ~1e-15 relative)
            e_df = df64.df_exp((uh, ul))
            gdf = df64.df_mul(df64.df_mul(e_df, (uh, ul)),
                              _df_scalar(nl.gamma, uh))
            au = df64.df_add(au, gdf)
        r = df64.df_sub(df64.df_from(b), au)
        return r[0], r[1]

    return residual_df


@dataclass
class RefineResult:
    solution_hi: object
    solution_lo: object
    residuals: List[float]        # f64 residual 2-norms per outer step
    outer_iterations: int
    converged: bool


def make_refined_solver(lowered: LoweredCycle, *,
                        inner_cycles: int = 10,
                        max_outer: int = 8,
                        target_reduction: float = 1e-12,
                        nonlinear: Optional[base.Operator] = None,
                        correction_lowered: Optional[LoweredCycle] = None,
                        richardson_iterations: int = 4,
                        omegas=None,
                        inner_dtype=None) -> Callable:
    """Build ``solve(b) -> RefineResult`` reaching ``target_reduction``
    relative residual (measured in f64 on host from the df64 words).

    ``nonlinear``: the FAS problem's operator carrying ``nonlinear_term``.
    When given, the df64 residual is ``b - L u - g(u)`` with ``g``
    evaluated in df64-corrected form, and each outer step is a true
    Newton step: the Jacobian system ``(L + g'(u)) e = r`` is solved by
    preconditioned Richardson iteration with ``correction_lowered`` as
    the preconditioner (required in this mode).  For the contraction to
    be fast the preconditioner cycle should target the SHIFTED linear
    operator ``L + g'(u*) I`` around a reference state — e.g.
    ``gallery.ShiftedOperatorGenerator(linear_gen, gamma)`` on the same
    hierarchy; an unshifted L-cycle stalls when g'/lambda_min(L) ~ 1
    (the FAS_2D_Basic case: gamma = 20 vs 2 pi^2).  The variable diagonal
    g'(u) is applied exactly in the Richardson matvec, so the outer
    iteration converges quadratically instead of stalling on the
    defect-correction mismatch.

    ``inner_dtype``: run the correction V-cycles in a lower precision
    (e.g. ``jnp.bfloat16``) — the mixed-precision-multigrid recipe: the
    correction equation tolerates low precision because refinement only
    needs each outer step to shrink the error by a constant factor.  A
    bf16 cycle moves half the HBM bytes of an f32 cycle, and since the
    per-step reduction floors at ~eps(inner_dtype), pair it with a small
    ``inner_cycles`` (rho^m < eps is wasted work: m ~ 2-3 for bf16 at
    rho ~ 0.05).  The residual is always measured in df64, so the outer
    loop is exact regardless of the inner precision.
    """
    st = _constant_scalar_stencil(lowered)
    radius = st.max_offsets
    st_df = _df_coefficients(st)
    if omegas is None:
        omegas = jnp.asarray(lowered.default_omegas, dtype=jnp.float32)

    nl = None
    if nonlinear is not None:
        from .lower import _nonlinear_of
        found = _nonlinear_of(nonlinear)
        if found is None:
            raise ValueError(
                f"{nonlinear} carries no nonlinear protocol "
                "(nonlinear_term/nonlinear_derivative on its generator)")
        nl = found[0]   # the generator carrying the nonlinear callables
        if correction_lowered is None:
            raise ValueError(
                "nonlinear refinement requires correction_lowered (a cycle "
                "for the SHIFTED linear part, see docstring)")
    g = nl.nonlinear_term if nl is not None else None
    residual_df = scalar_residual_df_fn(st, nl)

    if g is None:
        @jax.jit
        def correct(uh, ul, rh):
            """m V-cycles on A e = r from zero start, u += e in df64."""
            r_in = rh if inner_dtype is None else rh.astype(inner_dtype)
            e0 = (jnp.zeros_like(r_in),)

            def body(e, _):
                out = lowered.step(e, (r_in,), omegas)
                # coarse-tail ops may promote to f32 (their coefficients
                # are f32 and the arrays are small); keep the CARRY — the
                # fine-grid state whose HBM traffic dominates — in
                # inner_dtype so the fine-level kernels stay low precision
                return tuple(x.astype(r_in.dtype) for x in out), None

            (e,), _ = lax.scan(body, e0, None, length=inner_cycles)
            if inner_dtype is not None:
                e = e.astype(rh.dtype)
            new_hi, new_lo = df64.df_add((uh, ul), df64.df_from(e))
            return new_hi, new_lo
    else:
        from ..ops.apply import apply_constant
        dg = nl.nonlinear_derivative
        c_omegas = jnp.asarray(correction_lowered.default_omegas,
                               dtype=jnp.float32)

        @jax.jit
        def correct(uh, ul, rh):
            """Newton step: preconditioned Richardson on
            (L + g'(u)) e = r; u += e in df64."""
            c = dg(uh)

            def B(v):
                return apply_constant(st, v) + c * v

            def M(v):
                # preconditioner may run low precision; the Richardson
                # matvec B stays f32 so the outer correction is exact
                v_in = v if inner_dtype is None else v.astype(inner_dtype)
                e0 = (jnp.zeros_like(v_in),)

                def body(e, _):
                    out = correction_lowered.step(e, (v_in,), c_omegas)
                    return tuple(x.astype(v_in.dtype) for x in out), None

                (e,), _ = lax.scan(body, e0, None, length=inner_cycles)
                return e if inner_dtype is None else e.astype(v.dtype)

            x = M(rh)

            def body(x, _):
                return x + M(rh - B(x)), None

            x, _ = lax.scan(body, x, None, length=richardson_iterations - 1)
            new_hi, new_lo = df64.df_add((uh, ul), df64.df_from(x))
            return new_hi, new_lo

    @jax.jit
    def outer_step(uh, ul, b):
        """ONE device program per outer iteration: df64 residual, its
        squared norm (device-side compensated reduction, df64.df_norm2_sq
        — only two scalars cross the host link, not two full grids), and
        the correction.  The returned norm is the residual BEFORE the
        correction; the host decides convergence from it and simply
        discards the last correction's state if already converged.

        The residual is scaled by its max abs before squaring: per-element
        squares in the f32 hi word would overflow to inf for |r| >~ 1.8e19
        and denormalize below ~1e-19, so unscaled df_norm2_sq would
        mis-detect convergence on very large- or small-scaled problems."""
        rh, rl = residual_df(uh, ul, b)
        s = jnp.max(jnp.abs(rh))
        s_safe = jnp.where(s > 0, s, 1.0)
        n2h, n2l = df64.df_norm2_sq((rh / s_safe, rl / s_safe))
        nh, nl = correct(uh, ul, rh)
        return nh, nl, n2h, n2l, s_safe

    def solve(b, u0=None) -> RefineResult:
        uh = jnp.zeros_like(b) if u0 is None else jnp.asarray(u0)
        ul = jnp.zeros_like(b)
        hist: List[float] = []
        b64 = np.asarray(jax.device_get(b), dtype=np.float64)
        bnorm = float(np.linalg.norm(b64))
        converged = False
        outer = 0
        for outer in range(1, max_outer + 1):
            nh, nl, n2h, n2l, s = outer_step(uh, ul, b)
            rnorm = float(s) * float(np.sqrt(float(n2h) + float(n2l)))
            hist.append(rnorm)
            if rnorm <= target_reduction * bnorm:
                converged = True
                break
            uh, ul = nh, nl
        else:
            # max_outer corrections applied; measure the last one's
            # residual so a solve that reaches the target on the final
            # correction reports converged=True
            _, _, n2h, n2l, s = outer_step(uh, ul, b)
            rnorm = float(s) * float(np.sqrt(float(n2h) + float(n2l)))
            hist.append(rnorm)
            converged = rnorm <= target_reduction * bnorm
        return RefineResult(uh, ul, hist, outer, converged)

    return solve
