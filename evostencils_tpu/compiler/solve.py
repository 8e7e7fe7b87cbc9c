"""Iterative solve driver + measurement protocol.

Mirrors the reference's evaluation protocol (reference
code_generation/exastencils.py:539-584): run the compiled cycle until the
residual is reduced by ``target_reduction`` or ``max_iterations`` is hit,
record per-iteration residual norms, report

* time to solution (wall clock of the compiled run),
* asymptotic convergence factor (geometric mean of per-iteration ratios),
* iteration count (infinity fitness when the limit is hit).

The whole solve is one jitted ``lax.while_loop`` — no host round-trips per
iteration.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .lower import LoweredCycle, _Lowering


def residual_norm_fn(operator):
    def res_norm(u_fields, b_fields):
        low = _Lowering(None, None, None)
        low.dtype = u_fields[0].dtype
        ax = low.apply_operator(operator, tuple(u_fields))
        sq = sum(jnp.sum(jnp.abs(b - a) ** 2) for b, a in zip(b_fields, ax))
        return jnp.sqrt(sq)
    return res_norm


def make_solver(lowered: LoweredCycle, max_iterations: int = 100,
                target_reduction: float = 1e-12):
    """Build a jitted function
    ``run(u0, b, omegas) -> (u, iterations, residual_history)``.

    ``residual_history[k]`` is the residual norm after k iterations
    (history[0] = initial residual); entries past the stopping iteration
    hold their last value.
    """
    res_norm = residual_norm_fn(lowered.operator)

    def run(u_fields, b_fields, omegas):
        r0 = res_norm(u_fields, b_fields)
        history = jnp.zeros((max_iterations + 1,), dtype=r0.dtype)
        history = history.at[0].set(r0)

        def cond(state):
            _, k, r, _ = state
            return jnp.logical_and(k < max_iterations,
                                   r > target_reduction * r0)

        def body(state):
            u, k, _, hist = state
            u = lowered.step(u, b_fields, omegas)
            r = res_norm(u, b_fields)
            hist = hist.at[k + 1].set(r)
            return u, k + 1, r, hist

        u, k, r, history = lax.while_loop(cond, body, (u_fields, 0, r0, history))
        return u, k, history

    return jax.jit(run)


def make_cycle_loop(lowered: LoweredCycle, n_cycles: int):
    """Build a jitted ``run(u0, b, omegas) -> u`` applying ``n_cycles``
    full cycles (no convergence checks — production solve loops and the
    throughput benchmark)."""

    def run(u_fields, b_fields, omegas):
        def body(u, _):
            out = lowered.step(u, b_fields, omegas)
            # keep the carry in the caller's dtype: low-precision (bf16)
            # states would otherwise be promoted to f32 by the coarse
            # tail's f32 coefficients and break the scan's type invariant
            return tuple(o.astype(f.dtype) for o, f in zip(out, u_fields)), \
                None
        u, _ = lax.scan(body, u_fields, None, length=n_cycles)
        return u

    return jax.jit(run)


@dataclass
class SolveResult:
    solve_time_ms: float        # mean wall time over samples (compiled)
    convergence_factor: float   # geometric mean residual ratio
    iterations: int             # inf-like (max_iterations) when not converged
    converged: bool
    residuals: np.ndarray       # residual history [0..iterations]
    solution: tuple


def measure_solve(lowered: LoweredCycle, b_fields, u0_fields=None,
                  omegas=None, *, max_iterations: int = 100,
                  target_reduction: float = 1e-12,
                  samples: int = 3) -> SolveResult:
    """Run the solver ``samples`` times and report the reference metrics
    (exastencils.py:417-443 runs the binary 3x and averages)."""
    if u0_fields is None:
        u0_fields = tuple(jnp.zeros(tuple(g.size), dtype=jnp.asarray(b).dtype)
                          for g, b in zip(lowered.grids, b_fields))
    if omegas is None:
        omegas = jnp.asarray(lowered.default_omegas)
    run = make_solver(lowered, max_iterations, target_reduction)
    # warm-up compile
    u, k, hist = run(u0_fields, b_fields, omegas)
    jax.block_until_ready(u)
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        u, k, hist = run(u0_fields, b_fields, omegas)
        jax.block_until_ready(u)
        times.append((time.perf_counter() - t0) * 1e3)
    k = int(k)
    hist = np.asarray(hist)
    converged = k < max_iterations or (
        k == max_iterations and hist[k] <= target_reduction * hist[0])
    if k > 0 and hist[0] > 0 and hist[k] > 0:
        rho = float((hist[k] / hist[0]) ** (1.0 / k))
    else:
        rho = 0.0 if k == 0 else float("inf")
    return SolveResult(
        solve_time_ms=float(np.mean(times)),
        convergence_factor=rho,
        iterations=k,
        converged=bool(converged),
        residuals=hist[:k + 1],
        solution=u,
    )
