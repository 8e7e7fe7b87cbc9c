"""df64-refined outer Krylov for split-complex systems with f32 solves.

The reference's Helmholtz protocol runs PreconditionedBiCGStab to 1e-7
relative residual in f64 C++ (reference
example_problems/Helmholtz/2D_FD_Helmholtz_fromL3.exa3:144-201, target
:192).  On the f32 device the BiCGStab recurrence residual drifts from
the true residual at ~1e-5 relative on this indefinite operator
(measured), so a single f32 solve cannot certify
1e-7.  This module closes that gap with classic mixed-precision
iterative refinement around the UNCHANGED f32 inner solver
(ops/solvers.preconditioned_bicgstab_split):

* the solution accumulates as a double-float pair (ops/df64);
* after each inner solve the TRUE residual ``b - A x`` is evaluated in
  compensated df64 arithmetic (the subtraction cancellation is exactly
  where f32 loses the signal), giving ~1e-13 measurement floor;
* the next inner solve runs on the residual equation ``A e = r``.

The operator class supported is what the split-complex Helmholtz
produces: an FxF block system whose entries are constant stencils plus
constant-per-row center deltas (the Robin boundary fold,
problems/helmholtz.py HelmholtzOperatorGenerator).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ir import system
from ..ops import df64
from .refine import apply_constant_df
from .lower import _stencil_field_of


def _entry_df_parts(entry):
    """Decompose one block entry into (stencil_df, radius, row_fixups):
    the constant interior stencil as (offset, hi, lo) coefficient words
    plus per-row center-delta fixups [(row, hi, lo)].  Raises when the
    entry is outside the constant+row-delta class."""
    st = entry.generate_stencil()
    sf = _stencil_field_of(entry)
    stencil_df = []
    for offset, value in st.entries:
        v = float(value)
        if v == 0.0:
            continue
        hi = np.float32(v)
        stencil_df.append((tuple(offset), float(hi),
                           float(np.float32(v - float(hi)))))
    radius = st.max_offsets
    fixups: List[Tuple[int, float, float]] = []
    if sf is not None:
        base_vals = {tuple(o): float(v) for o, v in st.entries}
        for off, f in zip(sf.offsets, sf.fields):
            f = np.asarray(f, dtype=np.float64)
            delta = f - base_vals.get(tuple(off), 0.0)
            rows = np.nonzero(np.any(delta != 0.0, axis=tuple(
                range(1, delta.ndim))))[0]
            if rows.size == 0:
                continue
            if tuple(off) != (0,) * delta.ndim:
                raise NotImplementedError(
                    "df64 split residual: only center-offset row deltas "
                    f"supported (got delta at offset {off})")
            for r in rows:
                row = delta[int(r)]
                if np.ptp(row) != 0.0:
                    raise NotImplementedError(
                        "df64 split residual: per-row delta must be "
                        "constant along the row")
                d = float(row.flat[0])
                hi = np.float32(d)
                fixups.append((int(r), float(hi),
                               float(np.float32(d - float(hi)))))
    return stencil_df, radius, fixups


def split_system_residual_df(op: system.Operator) -> Callable:
    """``residual_df(u_hi, u_lo, b) -> (r_hi, r_lo)`` over field tuples
    for an FxF block system of constant+row-delta entries, entirely in
    df64 (compensated) arithmetic."""
    F = len(op.entries)
    parts = [[_entry_df_parts(e) for e in row] for row in op.entries]

    def residual_df(u_hi, u_lo, b):
        r_hi, r_lo = [], []
        for i in range(F):
            acc = df64.df_from(b[i])
            for j in range(F):
                stencil_df, radius, fixups = parts[i][j]
                if stencil_df:
                    au = apply_constant_df(stencil_df, radius,
                                           (u_hi[j], u_lo[j]), b[i].shape)
                else:
                    au = df64.df_zero_like(b[i])
                for row, dhi, dlo in fixups:
                    t = df64.df_mul((u_hi[j][row], u_lo[j][row]),
                                    (jnp.float32(dhi), jnp.float32(dlo)))
                    srow = df64.df_add((au[0][row], au[1][row]), t)
                    au = (au[0].at[row].set(srow[0]),
                          au[1].at[row].set(srow[1]))
                acc = df64.df_sub(acc, au)
            r_hi.append(acc[0])
            r_lo.append(acc[1])
        return tuple(r_hi), tuple(r_lo)

    return residual_df


def _df_norm(r_hi, r_lo) -> float:
    """Host f64 2-norm of a df64 field tuple (scaled compensated device
    reduction as compiler/refine.outer_step: only scalars cross the
    link)."""
    total = 0.0
    for h, l in zip(r_hi, r_lo):
        s = jnp.max(jnp.abs(h))
        s_safe = jnp.where(s > 0, s, 1.0)
        n2h, n2l = df64.df_norm2_sq((h / s_safe, l / s_safe))
        total += float(s_safe) ** 2 * (float(n2h) + float(n2l))
    return float(np.sqrt(total))


def reliable_bicgstab_split(matvec: Callable, precond: Callable,
                            residual_df: Callable, b, *,
                            tol: float = 1e-7, maxiter: int = 10000,
                            segment: int = 40, verbose: bool = False):
    """Right-preconditioned split-complex BiCGStab with df64 solution
    accumulation and periodic RESIDUAL REPLACEMENT (van der Vorst & Ye
    reliable-update strategy): one continuous Krylov process — unlike
    iterative-refinement restarts, which repeat the indefinite-Helmholtz
    plateau phase on every restart (measured: restarting costs ~2.3x the
    f64 iteration count; replacement stays within ~10%).

    Every ``segment`` iterations the recurrence residual r is replaced by
    the TRUE df64 residual ``b - A x`` (x carried as a double-float
    pair), resetting the f32 recurrence drift (~1e-5 relative) before it floors the attainable accuracy; r_hat / p / the
    recurrence scalars carry over untouched, and the very next iteration
    recomputes ``rho = <r_hat, r>`` from the replaced r, so the Krylov
    space survives.

    Returns ``(x_hi, x_lo, total_iterations, outer_history)``;
    ``outer_history`` holds the df64 TRUE relative residual at each
    replacement point."""
    from ..ops.solvers import (_cdot_split, _cmul_s, _cdiv_s, _caxpy_split,
                               _zeros_like, norm)

    zero_b = tuple(jnp.zeros_like(f) for f in b)
    one = jnp.asarray(1.0, jax.tree_util.tree_leaves(b)[0].dtype)
    zero = jnp.zeros_like(one)

    @jax.jit
    def measure(x_hi, x_lo, bt):
        """TRUE df64 residual + its norm in ONE device program (the
        eager per-op form dispatches and compiles every tiny op
        separately)."""
        r_hi, r_lo = residual_df(x_hi, x_lo, bt)
        total = jnp.float32(0.0)
        for h, l in zip(r_hi, r_lo):
            s = jnp.max(jnp.abs(h))
            ss = jnp.where(s > 0, s, 1.0)
            n2h, n2l = df64.df_norm2_sq((h / ss, l / ss))
            total = total + ss * ss * (n2h + n2l)
        return r_hi, jnp.sqrt(total)

    _, bnorm_s = measure(zero_b, zero_b, tuple(b))
    # norm of b: residual of x = 0 IS b
    bnorm = float(bnorm_s)

    @jax.jit
    def run_segment(x_hi, x_lo, r, r_hat, v, p, rho, alpha, omega,
                    limit_res):
        """Up to ``segment`` BiCGStab iterations; stops early when the
        recurrence residual falls under ``limit_res``."""

        def cond(state):
            k_in = state[-2]
            res = state[-1]
            return jnp.logical_and(k_in < segment, res > limit_res)

        def body(state):
            (x_hi, x_lo, r, v, p, rho, alpha, omega, k_in, _) = state
            rho_new = _cdot_split(r_hat, r)
            beta = _cmul_s(_cdiv_s(rho_new, rho), _cdiv_s(alpha, omega))
            neg_omega = (-omega[0], -omega[1])
            p = _caxpy_split(beta, _caxpy_split(neg_omega, v, p), r)
            y = precond(p)
            v = matvec(y)
            alpha = _cdiv_s(rho_new, _cdot_split(r_hat, v))
            neg_alpha = (-alpha[0], -alpha[1])
            s = _caxpy_split(neg_alpha, v, r)
            z = precond(s)
            t = matvec(z)
            tt = _cdot_split(t, t)
            omega_new = _cdiv_s(_cdot_split(t, s), tt)
            # solution increment alpha*y + omega*z, accumulated in df64
            inc = _caxpy_split(omega_new, z,
                               _caxpy_split(alpha, y, _zeros_like(r)))
            acc = [df64.df_add((h, l), df64.df_from(i))
                   for h, l, i in zip(x_hi, x_lo, inc)]
            x_hi = tuple(a[0] for a in acc)
            x_lo = tuple(a[1] for a in acc)
            neg_omega_new = (-omega_new[0], -omega_new[1])
            r = _caxpy_split(neg_omega_new, t, s)
            res = norm(r)
            return (x_hi, x_lo, r, v, p, rho_new, alpha, omega_new,
                    k_in + 1, res)

        st = (x_hi, x_lo, r, v, p, rho, alpha, omega, 0, norm(r))
        st = jax.lax.while_loop(cond, body, st)
        return st

    x_hi = zero_b
    x_lo = zero_b
    r = tuple(b)
    r_hat = tuple(b)
    v = zero_b
    p = zero_b
    rho = alpha = omega = (one, zero)
    limit = jnp.float32(tol * bnorm)
    total_k = 0
    history = []
    rel = 1.0
    #: long f32 runs (thousands of iterations at high k) degrade the
    #: Krylov BASIS itself — residual replacement cannot fix that.  On
    #: stall/divergence, roll back to the best df64 iterate and RESTART
    #: the Krylov process from its true residual (refinement hybrid):
    #: the accumulated solution is preserved, only the Krylov state is
    #: rebuilt.  Observed on device at k=160/320 (stall at ~4e-5, then
    #: breakdown to NaN) — the restarts carry the solve to 1e-7.
    best = (x_hi, x_lo, tuple(b), 1.0)
    stall = 0
    restarts = 0
    max_restarts = 40
    while total_k < maxiter:
        (x_hi, x_lo, r, v, p, rho, alpha, omega, k_in, res) = run_segment(
            x_hi, x_lo, r, r_hat, v, p, rho, alpha, omega, limit)
        total_k += int(k_in)
        r_hi, rnorm = measure(x_hi, x_lo, tuple(b))
        rel = float(rnorm) / bnorm
        history.append(rel)
        if verbose:
            print(f"[reliable-bicgstab] k={total_k} true rel={rel:.3e} "
                  f"recurrence={float(res) / bnorm:.3e}", flush=True)
        if rel <= tol:
            break
        # "stall" = NO improvement at all across several replacements —
        # slow geometric convergence (rho^segment close to 1 at doubled
        # k) must NOT trigger restarts, or the Krylov space never builds
        if np.isfinite(rel) and rel < 0.995 * best[3]:
            best = (x_hi, x_lo, r_hi, rel)
            stall = 0
        else:
            stall += 1
        # restart ONLY in the small-residual regime (the f32 wall) or on
        # breakdown: indefinite-Helmholtz BiCGStab has long NATURAL
        # plateaus early on that a restart would reset forever
        if not np.isfinite(rel) or rel > 50 * best[3] or \
                (stall >= 5 and best[3] < 1e-3):
            if restarts >= max_restarts:
                break
            restarts += 1
            x_hi, x_lo, r_hi, _ = best
            r = r_hi
            r_hat = r_hi               # fresh shadow residual
            v = zero_b
            p = zero_b
            rho = alpha = omega = (one, zero)
            stall = 0
            if verbose:
                print(f"[reliable-bicgstab] restart {restarts} from "
                      f"rel={best[3]:.3e}", flush=True)
            continue
        r = r_hi                       # residual replacement
        if int(k_in) < segment:
            # the recurrence claimed convergence below ``limit`` but the
            # true residual disagrees: tighten the recurrence target
            limit = limit * jnp.float32(0.25)
    return x_hi, x_lo, total_k, history


def refined_bicgstab_split(matvec: Callable, precond: Callable,
                           residual_df: Callable, b, *,
                           tol: float = 1e-7, maxiter: int = 10000,
                           inner_tol: float = 1e-4, max_outer: int = 8,
                           verbose: bool = False):
    """Right-preconditioned split-complex BiCGStab to TRUE relative
    residual ``tol``, via df64 iterative refinement (module docstring).

    Returns ``(x_hi, x_lo, total_iterations, outer_history)`` where
    ``outer_history`` is the list of df64-measured relative residuals
    after each inner solve.  ``total_iterations`` counts INNER BiCGStab
    iterations across all restarts — the number comparable to the
    reference's iteration count."""
    from ..ops.solvers import preconditioned_bicgstab_split

    # jit once over (rhs, tol) with maxiter static: tol enters the while
    # condition as a traced scalar, so restarts reuse one compilation
    solve_inner = jax.jit(
        lambda rhs, itol: preconditioned_bicgstab_split(
            matvec, precond, rhs, tol=itol, maxiter=maxiter,
            history_size=0)[:2])
    residual_jit = jax.jit(residual_df)

    x_hi = tuple(jnp.zeros_like(f) for f in b)
    x_lo = tuple(jnp.zeros_like(f) for f in b)
    bnorm = _df_norm(tuple(b), tuple(jnp.zeros_like(f) for f in b))
    rel = 1.0
    r_cur = tuple(b)
    total_k = 0
    history = []
    for outer in range(max_outer):
        if rel <= tol or total_k >= maxiter:
            break
        # aim the inner solve at the remaining reduction, floored by what
        # f32 can certify; x0.1 safety so one restart is usually enough
        itol = max(0.1 * tol / rel, inner_tol * 0.1)
        itol = min(itol, inner_tol)
        e, k = solve_inner(r_cur, jnp.float32(itol))
        total_k += int(k)
        x_hi, x_lo = tuple(zip(*[
            df64.df_add((h, l), df64.df_from(ei))
            for h, l, ei in zip(x_hi, x_lo, e)]))
        r_hi, r_lo = residual_jit(x_hi, x_lo, tuple(b))
        rel = _df_norm(r_hi, r_lo) / bnorm
        history.append(rel)
        if verbose:
            print(f"[refined-bicgstab] outer {outer + 1}: inner {int(k)} "
                  f"iterations, true rel residual {rel:.3e} "
                  f"(total {total_k})", flush=True)
        r_cur = r_hi
    return x_hi, x_lo, total_k, history


# -- full-df64-recurrence BiCGStab ------------------------------------------
#
# At k=320 the f32 Krylov BASIS degenerates before 1e-7 (rho=0.995 needs
# thousands of iterations; residual replacement cannot fix basis error).  Here the prescribed experiment: carry the
# RECURRENCE VECTORS x, r, r_hat, v, p, every dot product and every
# recurrence scalar as df64 (double-float) words, with the matvec in
# compensated df64 (apply_constant_df) — only the V-cycle preconditioner
# stays f32 (a preconditioner need only be a fixed approximate inverse;
# its f32 rounding perturbs the effective operator at ~1e-7 relative).
# The reference bar is the all-f64 C++ protocol
# (Helmholtz/2D_FD_Helmholtz_fromL3.exa3:144-201, cap :192).


def _df_div(a, b):
    """df64 / df64 (two Newton-like correction terms, ~2 ulp)."""
    q1 = a[0] / b[0]
    r = df64.df_sub(a, df64.df_mul_f32(b, q1))
    q2 = r[0] / b[0]
    r2 = df64.df_sub(r, df64.df_mul_f32(b, q2))
    q3 = r2[0] / b[0]
    q = df64.two_sum(q1, q2)
    return df64.fast_two_sum(q[0], q[1] + q3)


def _cdf(re, im):
    return (re, im)


def _cdf_mul(a, b):
    return (df64.df_sub(df64.df_mul(a[0], b[0]), df64.df_mul(a[1], b[1])),
            df64.df_add(df64.df_mul(a[0], b[1]), df64.df_mul(a[1], b[0])))


def _cdf_div(a, b):
    d = df64.df_add(df64.df_mul(b[0], b[0]), df64.df_mul(b[1], b[1]))
    # breakdown guard (mirrors ops/solvers._cdiv_s): a zero denominator
    # must not poison the state with NaN — the host loop restarts instead
    d = (jnp.where(d[0] == 0, jnp.float32(1.0), d[0]),
         jnp.where(d[0] == 0, jnp.float32(0.0), d[1]))
    re = _df_div(df64.df_add(df64.df_mul(a[0], b[0]),
                             df64.df_mul(a[1], b[1])), d)
    im = _df_div(df64.df_sub(df64.df_mul(a[1], b[0]),
                             df64.df_mul(a[0], b[1])), d)
    return (re, im)


def _cdf_neg(a):
    return (df64.df_neg(a[0]), df64.df_neg(a[1]))


def _vdf_zero(b):
    return (tuple(jnp.zeros_like(f) for f in b),
            tuple(jnp.zeros_like(f) for f in b))


def _vdf_from(fields):
    return (tuple(fields), tuple(jnp.zeros_like(f) for f in fields))


def _vdf_halves(v):
    """Split a df64 split-complex vector into per-field (re, im) df64
    halves: returns (re_fields, im_fields) each as lists of DF pairs."""
    hi, lo = v
    h = len(hi) // 2
    re = [(hi[i], lo[i]) for i in range(h)]
    im = [(hi[h + i], lo[h + i]) for i in range(h)]
    return re, im


def _vdf_join(re, im):
    hi = tuple(f[0] for f in re) + tuple(f[0] for f in im)
    lo = tuple(f[1] for f in re) + tuple(f[1] for f in im)
    return (hi, lo)


def _df_dot_field(a, b):
    return df64.df_sum(df64.df_mul(a, b))


def _cdot_df(a, b):
    """Complex <a, b> (conjugating a) over df64 split vectors; df64
    complex scalar result."""
    ar, ai = _vdf_halves(a)
    br, bi = _vdf_halves(b)
    re = (jnp.float32(0.0), jnp.float32(0.0))
    im = (jnp.float32(0.0), jnp.float32(0.0))
    for k in range(len(ar)):
        re = df64.df_add(re, df64.df_add(_df_dot_field(ar[k], br[k]),
                                         _df_dot_field(ai[k], bi[k])))
        im = df64.df_add(im, df64.df_sub(_df_dot_field(ar[k], bi[k]),
                                         _df_dot_field(ai[k], br[k])))
    return _cdf(re, im)


def _caxpy_df(alpha, x, y):
    """y + alpha * x with df64 complex scalar alpha over df64 vectors."""
    ar, ai = alpha
    xr, xi = _vdf_halves(x)
    yr, yi = _vdf_halves(y)
    re, im = [], []
    for k in range(len(xr)):
        re.append(df64.df_add(yr[k],
                              df64.df_sub(df64.df_mul(ar, xr[k]),
                                          df64.df_mul(ai, xi[k]))))
        im.append(df64.df_add(yi[k],
                              df64.df_add(df64.df_mul(ar, xi[k]),
                                          df64.df_mul(ai, xr[k]))))
    return _vdf_join(re, im)


def _vdf_norm2(a):
    hi, lo = a
    total = (jnp.float32(0.0), jnp.float32(0.0))
    for h, l in zip(hi, lo):
        total = df64.df_add(total, df64.df_norm2_sq((h, l)))
    return total


def split_system_matvec_df(op: system.Operator) -> Callable:
    """``matvec_df(u) -> A u`` over df64 field-tuple vectors for the same
    constant+row-delta block-system class as split_system_residual_df."""
    F = len(op.entries)
    parts = [[_entry_df_parts(e) for e in row] for row in op.entries]

    def matvec_df(u):
        u_hi, u_lo = u
        out_hi, out_lo = [], []
        for i in range(F):
            acc = df64.df_zero_like(u_hi[i])
            for j in range(F):
                stencil_df, radius, fixups = parts[i][j]
                if stencil_df:
                    au = apply_constant_df(stencil_df, radius,
                                           (u_hi[j], u_lo[j]),
                                           u_hi[j].shape)
                else:
                    au = df64.df_zero_like(u_hi[i])
                for row, dhi, dlo in fixups:
                    t = df64.df_mul((u_hi[j][row], u_lo[j][row]),
                                    (jnp.float32(dhi), jnp.float32(dlo)))
                    srow = df64.df_add((au[0][row], au[1][row]), t)
                    au = (au[0].at[row].set(srow[0]),
                          au[1].at[row].set(srow[1]))
                acc = df64.df_add(acc, au)
            out_hi.append(acc[0])
            out_lo.append(acc[1])
        return (tuple(out_hi), tuple(out_lo))

    return matvec_df


def df64_basis_bicgstab_split(matvec_df: Callable, precond: Callable,
                              residual_df: Callable, b, *,
                              tol: float = 1e-7, maxiter: int = 10000,
                              segment: int = 100, verbose: bool = False):
    """Right-preconditioned split-complex BiCGStab with the ENTIRE Krylov
    recurrence in df64 (vectors, dots, scalars, matvec); the V-cycle
    preconditioner is applied in f32 to the hi words.  Returns
    ``(x_hi, x_lo, total_iterations, history)``."""
    one = (jnp.float32(1.0), jnp.float32(0.0))
    zero_s = (jnp.float32(0.0), jnp.float32(0.0))
    cone = _cdf(one, zero_s)

    @jax.jit
    def measure(x_hi, x_lo, bt):
        r_hi, r_lo = residual_df(x_hi, x_lo, bt)
        n2 = _vdf_norm2((r_hi, r_lo))
        return (r_hi, r_lo), jnp.sqrt(n2[0] + n2[1])

    zero_fields = tuple(jnp.zeros_like(f) for f in b)
    _, bnorm_s = measure(zero_fields, zero_fields, tuple(b))
    bnorm = float(bnorm_s)

    def seg_body(state):
        (x, r, v, p, rho, alpha, omega, r_hat, k_in, _) = state
        rho_new = _cdot_df(r_hat, r)
        beta = _cdf_mul(_cdf_div(rho_new, rho), _cdf_div(alpha, omega))
        p = _caxpy_df(beta, _caxpy_df(_cdf_neg(omega), v, p), r)
        y = _vdf_from(precond(p[0]))
        v = matvec_df(y)
        alpha = _cdf_div(rho_new, _cdot_df(r_hat, v))
        s = _caxpy_df(_cdf_neg(alpha), v, r)
        z = _vdf_from(precond(s[0]))
        t = matvec_df(z)
        omega_new = _cdf_div(_cdot_df(t, s), _cdot_df(t, t))
        x = _caxpy_df(omega_new, z, _caxpy_df(alpha, y, x))
        r = _caxpy_df(_cdf_neg(omega_new), t, s)
        n2 = _vdf_norm2(r)
        return (x, r, v, p, rho_new, alpha, omega_new, r_hat, k_in + 1,
                jnp.sqrt(n2[0] + n2[1]))

    @jax.jit
    def run_segment(x, r, v, p, rho, alpha, omega, r_hat, limit_res):
        def cond(state):
            return jnp.logical_and(state[-2] < segment,
                                   state[-1] > limit_res)
        n2 = _vdf_norm2(r)
        st = (x, r, v, p, rho, alpha, omega, r_hat, 0,
              jnp.sqrt(n2[0] + n2[1]))
        return jax.lax.while_loop(cond, seg_body, st)

    limit = jnp.float32(tol * bnorm)

    x = _vdf_zero(b)
    r = _vdf_from(b)
    r_hat = _vdf_from(b)
    v = _vdf_zero(b)
    p = _vdf_zero(b)
    rho = alpha = omega = cone
    total_k = 0
    history = []
    rel = 1.0
    # reliable updates ON TOP of the df64 basis: the df64 recurrence
    # still accumulates x-r drift proportional to eps_df64 (~3.6e-15)
    # times the indefinite-Helmholtz intermediate spikes — measured wall
    # 1.08e-6 at k=80 (f64's wall sits ~32x lower, which is why the
    # reference converges).  Replacing r with the compensated true df64
    # residual every segment resets the drift; the df64 BASIS (the round-4
    # f32 wall) stays intact.
    best = (x, _vdf_from(b), 1.0)
    restarts = 0
    while total_k < maxiter:
        (x, r, v, p, rho, alpha, omega, r_hat, k_in, res) = run_segment(
            x, r, v, p, rho, alpha, omega, r_hat, limit)
        total_k += int(k_in)
        r_true, rnorm = measure(x[0], x[1], tuple(b))
        rel = float(rnorm) / bnorm
        history.append(rel)
        if verbose:
            print(f"[df64-bicgstab] k={total_k} true rel={rel:.3e} "
                  f"recurrence={float(res) / bnorm:.3e}", flush=True)
        if rel <= tol:
            break
        if np.isfinite(rel) and rel < best[2]:
            best = (x, r_true, rel)
        if not np.isfinite(rel) or rel > 50 * best[2]:
            # Krylov breakdown: roll back to the best iterate and rebuild
            # the process from its true residual (the accumulated df64
            # solution survives; only the Krylov state is reset)
            if restarts >= 40:
                break
            restarts += 1
            x, r, _ = best
            r_hat = r
            v = _vdf_zero(b)
            p = _vdf_zero(b)
            rho = alpha = omega = cone
            if verbose:
                print(f"[df64-bicgstab] restart {restarts} from "
                      f"rel={best[2]:.3e}", flush=True)
            continue
        r = r_true                     # residual replacement
        if int(k_in) < segment and float(res) <= float(limit):
            # recurrence under target but true residual above: tighten
            limit = limit * jnp.float32(0.25)
    return x[0], x[1], total_k, history
