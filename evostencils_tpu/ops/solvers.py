"""Matrix-free Krylov solvers over pytrees of field arrays.

All solvers are jittable: fixed-iteration variants use ``lax.fori_loop``
(for use *inside* compiled cycles, e.g. Krylov smoothers), tolerance
variants use ``lax.while_loop``.  They replace the CG/BiCGStab/MinRes
solver bodies ExaStencils generates as C++ (reference
code_generation/exastencils.py:1025-1101 extracts those bodies; here they
are native JAX).

The operand is any pytree of arrays (a tuple of per-field grids).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax


def _dot(a, b):
    """Inner product <a, b> over a pytree; conjugates a for complex dtypes."""
    leaves_a = jax.tree_util.tree_leaves(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    return sum(jnp.vdot(x, y) for x, y in zip(leaves_a, leaves_b))


def _axpy(alpha, x, y):
    return jax.tree_util.tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def _scale(alpha, x):
    return jax.tree_util.tree_map(lambda xi: alpha * xi, x)


def _sub(x, y):
    return jax.tree_util.tree_map(lambda a, b: a - b, x, y)


def _add(x, y):
    return jax.tree_util.tree_map(lambda a, b: a + b, x, y)


def _zeros_like(x):
    return jax.tree_util.tree_map(jnp.zeros_like, x)


def norm(x):
    return jnp.sqrt(jnp.real(_dot(x, x)))


def cg(matvec: Callable, b, x0=None, *, tol: float = 1e-12, maxiter: int = 1000):
    """Conjugate gradients to relative tolerance ``tol`` (matches the
    reference solver config `generate solver ... cgs cg` with 1e-12/1000,
    example_problems/Poisson/2D_FD_Poisson_fromL2.exa3:1-14)."""
    x = _zeros_like(b) if x0 is None else x0
    r = _sub(b, matvec(x)) if x0 is not None else b
    p = r
    rs = _dot(r, r)
    bs = jnp.real(_dot(b, b))
    threshold = tol * tol * bs

    def cond(state):
        _, _, _, rs, k = state
        return jnp.logical_and(jnp.real(rs) > threshold, k < maxiter)

    def body(state):
        x, r, p, rs, k = state
        ap = matvec(p)
        alpha = rs / _dot(p, ap)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, ap, r)
        rs_new = _dot(r, r)
        beta = rs_new / rs
        p = _axpy(beta, p, r)
        return x, r, p, rs_new, k + 1

    x, r, p, rs, k = lax.while_loop(cond, body, (x, r, p, rs, 0))
    return x


def cg_fixed(matvec: Callable, b, iterations: int, x0=None):
    """CG with a fixed iteration count (Krylov smoother inside a cycle)."""
    x = _zeros_like(b) if x0 is None else x0
    r = b if x0 is None else _sub(b, matvec(x))
    p = r
    rs = _dot(r, r)

    def body(_, state):
        x, r, p, rs = state
        ap = matvec(p)
        denom = _dot(p, ap)
        alpha = jnp.where(denom == 0, 0.0, rs / denom)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, ap, r)
        rs_new = _dot(r, r)
        beta = jnp.where(rs == 0, 0.0, rs_new / rs)
        p = _axpy(beta, p, r)
        return x, r, p, rs_new

    x, _, _, _ = lax.fori_loop(0, iterations, body, (x, r, p, rs))
    return x


def bicgstab_fixed(matvec: Callable, b, iterations: int, x0=None):
    """BiCGStab with fixed iteration count (non-symmetric / complex ops)."""
    x = _zeros_like(b) if x0 is None else x0
    r = b if x0 is None else _sub(b, matvec(x))
    r_hat = r
    p = r
    rho = _dot(r_hat, r)

    def body(_, state):
        x, r, p, rho = state
        v = matvec(p)
        denom = _dot(r_hat, v)
        alpha = jnp.where(denom == 0, 0.0, rho / denom)
        s = _axpy(-alpha, v, r)
        t = matvec(s)
        tt = _dot(t, t)
        omega = jnp.where(tt == 0, 0.0, _dot(t, s) / tt)
        x = _axpy(alpha, p, _axpy(omega, s, x))
        r = _axpy(-omega, t, s)
        rho_new = _dot(r_hat, r)
        beta = jnp.where(rho * omega == 0, 0.0, (rho_new / rho) * (alpha / omega))
        p = _axpy(beta, _axpy(-omega, v, p), r)
        return x, r, p, rho_new

    x, _, _, _ = lax.fori_loop(0, iterations, body, (x, r, p, rho))
    return x


def conjugate_residual_fixed(matvec: Callable, b, iterations: int, x0=None):
    """Conjugate Residual method, fixed iterations (symmetric indefinite)."""
    x = _zeros_like(b) if x0 is None else x0
    r = b if x0 is None else _sub(b, matvec(x))
    p = r
    ar = matvec(r)
    ap = ar

    def body(_, state):
        x, r, p, ar, ap = state
        rar = _dot(r, ar)
        denom = _dot(ap, ap)
        alpha = jnp.where(denom == 0, 0.0, rar / denom)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, ap, r)
        ar_new = matvec(r)
        rar_new = _dot(r, ar_new)
        beta = jnp.where(rar == 0, 0.0, rar_new / rar)
        p = _axpy(beta, p, r)
        ap = _axpy(beta, ap, ar_new)
        return x, r, p, ar_new, ap

    x, _, _, _, _ = lax.fori_loop(0, iterations, body, (x, r, p, ar, ap))
    return x


def minres_fixed(matvec: Callable, b, iterations: int, x0=None):
    """MINRES (Paige & Saunders: Lanczos tridiagonalization + Givens QR),
    fixed iteration count.  Unlike conjugate residuals, the short
    recurrence stays stable on symmetric INDEFINITE operators — the case
    the reference's MinRes coarse solver exists for
    (ir/krylov_subspace.py:40-41, Helmholtz-type operators).

    All rotation scalars are kept real (Hermitian operators have real
    Lanczos alpha/beta); breakdown (beta == 0, exact solve reached) is
    guarded by freezing the iteration."""
    x = _zeros_like(b) if x0 is None else x0
    r = b if x0 is None else _sub(b, matvec(x))
    beta1 = norm(r)
    safe_beta1 = jnp.where(beta1 == 0, 1.0, beta1)
    v = _scale(1.0 / safe_beta1, r)
    v_old = _zeros_like(b)
    w0 = _zeros_like(b)
    w1 = _zeros_like(b)
    real_dt = jnp.real(beta1).dtype
    eta = jnp.asarray(beta1, real_dt)
    gamma0 = gamma1 = jnp.asarray(1.0, real_dt)
    sigma0 = sigma1 = jnp.asarray(0.0, real_dt)
    beta = jnp.asarray(0.0, real_dt)

    def body(_, state):
        x, v, v_old, w0, w1, eta, gamma0, gamma1, sigma0, sigma1, beta = state
        av = matvec(v)
        alpha = jnp.real(_dot(v, av))        # Hermitian => real
        w = _axpy(-alpha, v, av)
        w = _axpy(-beta, v_old, w)
        beta_new = norm(w)
        # Givens QR of the tridiagonal column
        delta = gamma1 * alpha - gamma0 * sigma1 * beta
        rho1 = jnp.sqrt(delta * delta + beta_new * beta_new)
        rho2 = sigma1 * alpha + gamma0 * gamma1 * beta
        rho3 = sigma0 * beta
        live = rho1 > 0                       # breakdown: solution reached
        rho1_s = jnp.where(live, rho1, 1.0)
        gamma_new = jnp.where(live, delta / rho1_s, 1.0)
        sigma_new = jnp.where(live, beta_new / rho1_s, 0.0)
        w_new = _axpy(-rho3, w0, _axpy(-rho2, w1, v))
        w_new = _scale(jnp.where(live, 1.0 / rho1_s, 0.0), w_new)
        x = _axpy(gamma_new * eta, w_new, x)
        eta = -sigma_new * eta
        beta_s = jnp.where(beta_new == 0, 1.0, beta_new)
        v_next = _scale(1.0 / beta_s, w)
        return (x, v_next, v, w1, w_new, eta,
                gamma1, gamma_new, sigma1, sigma_new, beta_new)

    state = (x, v, v_old, w0, w1, eta, gamma0, gamma1, sigma0, sigma1, beta)
    state = lax.fori_loop(0, iterations, body, state)
    return state[0]


def preconditioned_bicgstab(matvec: Callable, precond: Callable, b,
                            *, tol: float = 1e-7, maxiter: int = 10000,
                            history_size: int = 0):
    """Right-preconditioned BiCGStab (reference Helmholtz solver:
    example_problems/Helmholtz/2D_FD_Helmholtz_fromL3.exa3:144-201 —
    ``gen_mgCycle()`` with zero initial guess is the preconditioner).

    Returns ``(x, iterations, residual_history)``; the history has
    ``history_size + 1`` slots (0 disables recording beyond r0/final).
    """
    x = _zeros_like(b)
    r = b
    r_hat = r
    leaves = jax.tree_util.tree_leaves(r)
    one = jnp.asarray(1.0, leaves[0].dtype)
    rho = alpha = omega = one
    v = _zeros_like(b)
    p = _zeros_like(b)
    r0_norm = norm(r)
    hsize = max(history_size, 1)
    hist = jnp.zeros((hsize + 1,), dtype=jnp.real(r0_norm).dtype)
    hist = hist.at[0].set(r0_norm)

    def cond(state):
        _, _, _, _, _, _, _, k, res, _ = state
        return jnp.logical_and(k < maxiter, res > tol * r0_norm)

    def body(state):
        x, r, v, p, rho, alpha, omega, k, _, hist = state
        rho_new = _dot(r_hat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = _axpy(beta, _axpy(-omega, v, p), r)
        y = precond(p)
        v = matvec(y)
        alpha = rho_new / _dot(r_hat, v)
        h = _axpy(alpha, y, x)
        s = _axpy(-alpha, v, r)
        z = precond(s)
        t = matvec(z)
        omega_new = _dot(t, s) / _dot(t, t)
        x = _axpy(omega_new, z, h)
        r = _axpy(-omega_new, t, s)
        res = norm(r)
        hist = jax.lax.cond(
            k + 1 <= hsize,
            lambda h_: h_.at[jnp.minimum(k + 1, hsize)].set(res),
            lambda h_: h_, hist)
        return x, r, v, p, rho_new, alpha, omega_new, k + 1, res, hist

    state = (x, r, v, p, rho, alpha, omega, 0, r0_norm, hist)
    x, r, v, p, rho, alpha, omega, k, res, hist = lax.while_loop(
        cond, body, state)
    return x, k, hist


FIXED_KRYLOV = {
    "CG": cg_fixed,
    "BiCGStab": bicgstab_fixed,
    "MinRes": minres_fixed,
    "ConjugateResidual": conjugate_residual_fixed,
}


# ---------------------------------------------------------------------------
# Split-complex Krylov: complex vectors as (re, im) real field pairs
# ---------------------------------------------------------------------------
# The fields tuple carries F complex vectors as 2F real arrays
# [re_0..re_{F-1}, im_0..im_{F-1}] and complex scalars as (re, im) pairs,
# so the whole compiled program is real-typed — the split-complex form of
# the Helmholtz outer solver.  Algebraically IDENTICAL to
# preconditioned_bicgstab on the corresponding complex vectors.

def _csplit(fields):
    h = len(fields) // 2
    return fields[:h], fields[h:]


def _cjoin(re, im):
    return tuple(re) + tuple(im)


def _cdot_split(a, b):
    """Complex <a, b> (conjugating a) on split fields; returns (re, im)."""
    ar, ai = _csplit(a)
    br, bi = _csplit(b)
    re = _dot(ar, br) + _dot(ai, bi)
    im = _dot(ar, bi) - _dot(ai, br)
    return re, im


def _cmul_s(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cdiv_s(a, b):
    d = b[0] * b[0] + b[1] * b[1]
    d = jnp.where(d == 0, 1.0, d)
    return ((a[0] * b[0] + a[1] * b[1]) / d,
            (a[1] * b[0] - a[0] * b[1]) / d)


def _caxpy_split(alpha, x, y):
    """y + alpha * x with complex scalar pair ``alpha`` on split fields."""
    xr, xi = _csplit(x)
    yr, yi = _csplit(y)
    ar, ai = alpha
    re = tuple(r + ar * vr - ai * vi for r, vr, vi in zip(yr, xr, xi))
    im = tuple(r + ar * vi + ai * vr for r, vr, vi in zip(yi, xr, xi))
    return _cjoin(re, im)


def preconditioned_bicgstab_split(matvec: Callable, precond: Callable, b,
                                  *, tol: float = 1e-7,
                                  maxiter: int = 10000,
                                  history_size: int = 0):
    """Right-preconditioned BiCGStab on split-complex fields (see module
    note above); mirrors :func:`preconditioned_bicgstab` exactly, with
    every complex scalar carried as a (re, im) pair."""
    x = _zeros_like(b)
    r = b
    r_hat = r
    one = jnp.asarray(1.0, jax.tree_util.tree_leaves(b)[0].dtype)
    zero = jnp.zeros_like(one)
    rho = alpha = omega = (one, zero)
    v = _zeros_like(b)
    p = _zeros_like(b)
    r0_norm = norm(r)
    hsize = max(history_size, 1)
    hist = jnp.zeros((hsize + 1,), dtype=r0_norm.dtype)
    hist = hist.at[0].set(r0_norm)

    def cond(state):
        _, _, _, _, _, _, _, k, res, _ = state
        return jnp.logical_and(k < maxiter, res > tol * r0_norm)

    def body(state):
        x, r, v, p, rho, alpha, omega, k, _, hist = state
        rho_new = _cdot_split(r_hat, r)
        beta = _cmul_s(_cdiv_s(rho_new, rho), _cdiv_s(alpha, omega))
        neg_omega = (-omega[0], -omega[1])
        p = _caxpy_split(beta, _caxpy_split(neg_omega, v, p), r)
        y = precond(p)
        v = matvec(y)
        alpha = _cdiv_s(rho_new, _cdot_split(r_hat, v))
        h = _caxpy_split(alpha, y, x)
        neg_alpha = (-alpha[0], -alpha[1])
        s = _caxpy_split(neg_alpha, v, r)
        z = precond(s)
        t = matvec(z)
        tt = _cdot_split(t, t)
        omega_new = _cdiv_s(_cdot_split(t, s), tt)
        x = _caxpy_split(omega_new, z, h)
        neg_omega_new = (-omega_new[0], -omega_new[1])
        r = _caxpy_split(neg_omega_new, t, s)
        res = norm(r)
        hist = jax.lax.cond(
            k + 1 <= hsize,
            lambda h_: h_.at[jnp.minimum(k + 1, hsize)].set(res),
            lambda h_: h_, hist)
        return x, r, v, p, rho_new, alpha, omega_new, k + 1, res, hist

    state = (x, r, v, p, rho, alpha, omega, 0, r0_norm, hist)
    x, r, v, p, rho, alpha, omega, k, res, hist = lax.while_loop(
        cond, body, state)
    return x, k, hist
