"""CMA-ES tuning of restriction/prolongation stencil weights.

Counterpart of the reference's transfer-operator weight
optimization (reference optimization/intergrid_transfer.py:10-144).  The
reference generates one parametrized C++ solver, then *recompiles the C++
for every CMA candidate* and measures the convergence factor.  Here the
transfer weights are traced jit arguments of a two-grid coarse-grid
correction (ops/transfer_weights.py), the objective compiles exactly once,
and each CMA generation is evaluated as ONE vmapped device call.

Objective (matching the reference protocol): asymptotic convergence factor
of the two-grid CGC cycle ``u <- u + P A_c^{-1} R (b - A u)`` measured over
``measure_iterations`` sweeps (reference generate_coarse_grid_correction:
intergrid_transfer.py:68-84 — pure CGC, smoothing commented out there;
``smoothing_steps`` adds damped-Jacobi pre/post smoothing for a
smoother-aware objective).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..ir import base, system
from ..stencils.constant import Stencil
from ..ops import apply as ops_apply
from ..ops.transfer_weights import restrict_weighted, prolong_weighted
from .cma import CMAES


@dataclass
class TransferOptimizationResult:
    restriction: system.Restriction
    prolongation: system.Prolongation
    weights: np.ndarray
    convergence_factor: float
    #: same objective with full-weighting / multilinear transfers
    default_convergence_factor: float = np.inf
    history: List[dict] = field(default_factory=list)


def _weights_to_stencil(w: np.ndarray, operator_range: int,
                        dimension: int) -> Stencil:
    shape = (2 * operator_range + 1,) * dimension
    box = np.asarray(w, dtype=np.float64).reshape(shape)
    entries = []
    for index in np.ndindex(shape):
        offset = tuple(i - operator_range for i in index)
        entries.append((offset, float(box[index])))
    return Stencil(entries)


def optimize(problem, generations: int = 20, *,
             operator_range: int = 1,
             smoothing_steps: int = 0,
             smoothing_omega: float = 0.8,
             measure_iterations: int = 10,
             lambda_: Optional[int] = None,
             seed: int = 0,
             dtype=np.float64,
             centroid: str = "default",
             verbose: bool = False) -> TransferOptimizationResult:
    """Tune transfer weights of the finest two-grid hierarchy of ``problem``.

    Scalar problems only (the reference tuner also builds per-field scalar
    transfer stencils; block systems reuse the tuned scalar stencil on the
    diagonal).  Returns tuned system-level Restriction/Prolongation IR nodes
    ready to be used in level contexts.
    """
    fine = problem.level_contexts[0]
    if len(fine.grid) != 1:
        raise NotImplementedError("transfer tuning supports scalar problems")
    grid = fine.grid[0]
    dimension = grid.dimension
    width = 2 * operator_range + 1
    kernel_size = width ** dimension
    n_weights = 2 * kernel_size  # restriction + prolongation

    A_entry = fine.operator.entries[0][0]
    A_st = A_entry.generate_stencil()
    _gen = getattr(A_entry, "stencil_generator", None)
    A_sf = (_gen.generate_stencil_field(A_entry.grid)
            if _gen is not None and hasattr(_gen, "generate_stencil_field")
            else None)
    fine_shape = tuple(grid.size)
    coarse_shape = tuple((n - 1) // 2 for n in fine_shape)
    if len(problem.level_contexts) > 1:
        coarse_op_entry = problem.level_contexts[1].operator.entries[0][0]
    else:
        coarse_op_entry = problem.coarsest_operator.entries[0][0]
    from ..grids import Grid
    coarse_grid = coarse_op_entry.grid if hasattr(coarse_op_entry, "grid") \
        else Grid(coarse_shape, tuple(2 * s for s in grid.spacing),
                  grid.level - 1)
    _cgen = getattr(coarse_op_entry, "stencil_generator", None)
    if _cgen is not None and hasattr(_cgen, "generate_stencil_field"):
        Ac = _cgen.generate_stencil_field(coarse_grid).dense_matrix()
    else:
        Ac = ops_apply.dense_matrix(coarse_op_entry.generate_stencil(),
                                    coarse_grid)
    Ac_inv = jnp.asarray(np.linalg.inv(Ac), dtype=dtype)
    if A_sf is not None:
        diag = jnp.asarray(np.asarray(A_sf.diagonal_field()), dtype=dtype)
    else:
        diag = dict(A_st.entries).get((0,) * dimension)

    def cgc_rho(weights_flat):
        wr = weights_flat[:kernel_size].reshape((width,) * dimension)
        wp = weights_flat[kernel_size:].reshape((width,) * dimension)

        def apply_A(u):
            if A_sf is not None:
                return A_sf.apply(u)
            return ops_apply.apply_constant(A_st, u)

        def smooth(u, b, steps):
            for _ in range(steps):
                u = u + (smoothing_omega / diag) * (b - apply_A(u))
            return u

        def cycle(u, b):
            u = smooth(u, b, smoothing_steps)
            r = b - apply_A(u)
            rc = restrict_weighted(r, wr)
            ec = (Ac_inv @ rc.reshape(-1)).reshape(coarse_shape)
            u = u + prolong_weighted(ec, wp, fine_shape)
            return smooth(u, b, smoothing_steps)

        # worst-case-ish initial error: random field fixed across candidates
        key = jax.random.PRNGKey(seed)
        e0 = jax.random.normal(key, fine_shape, dtype=dtype)
        b = jnp.zeros(fine_shape, dtype=dtype)
        r0 = jnp.linalg.norm(apply_A(e0).reshape(-1))

        def body(u, _):
            return cycle(u, b), None
        u, _ = jax.lax.scan(body, e0, None, length=measure_iterations)
        rk = jnp.linalg.norm(apply_A(u).reshape(-1))
        rho = (rk / r0) ** (1.0 / measure_iterations)
        return jnp.where(jnp.isfinite(rho), rho, jnp.asarray(1e100, dtype))

    batched = jax.jit(jax.vmap(cgc_rho))

    def _embed(kernel_1d_outer):
        box = np.zeros((width,) * dimension)
        c = operator_range
        inner = tuple(slice(c - 1, c + 2) for _ in range(dimension))
        box[inner] = kernel_1d_outer
        return box.ravel()

    fw = np.array([0.25, 0.5, 0.25])
    bl = np.array([0.5, 1.0, 0.5])
    default_w = np.concatenate([
        _embed(np.multiply.outer(*([fw] * dimension)) if dimension > 1
               else fw),
        _embed(np.multiply.outer(*([bl] * dimension)) if dimension > 1
               else bl)])
    default_f = float(batched(jnp.asarray(default_w[None], dtype=dtype))[0])

    # centroid at the textbook transfers, sigma sized to explore around
    # them: CMA then strictly refines the default (the reference instead
    # spreads uniform mass — intergrid_transfer.py:127 — and must first
    # rediscover the textbook weights)
    if centroid == "default":
        es = CMAES(default_w, sigma=0.1, lambda_=lambda_, seed=seed)
    else:
        center = 2.0 / n_weights * 2
        es = CMAES([center] * n_weights, sigma=center / 2, lambda_=lambda_,
                   seed=seed)
    history = []
    best_w, best_f = default_w, default_f
    for gen in range(generations):
        pop = es.ask()
        fits = np.asarray(batched(jnp.asarray(pop, dtype=dtype)))
        es.tell(pop, fits)
        i = int(np.argmin(fits))
        if fits[i] < best_f:
            best_f, best_w = float(fits[i]), pop[i].copy()
        record = {"gen": gen, "min": float(fits.min()),
                  "avg": float(fits.mean()), "sigma": es.sigma}
        history.append(record)
        if verbose:
            print(f"[cma] gen {gen}: min={record['min']:.4f} "
                  f"avg={record['avg']:.4f} sigma={es.sigma:.3g}",
                  file=sys.stderr)

    r_st = _weights_to_stencil(best_w[:kernel_size], operator_range,
                               dimension)
    p_st = _weights_to_stencil(best_w[kernel_size:], operator_range,
                               dimension)
    restriction = system.Restriction("tuned_R", [
        base.Restriction("tuned_R", grid, coarse_grid,
                         base.ConstantStencilGenerator(r_st))])
    prolongation = system.Prolongation("tuned_P", [
        base.Prolongation("tuned_P", grid, coarse_grid,
                          base.ConstantStencilGenerator(p_st))])
    return TransferOptimizationResult(restriction, prolongation, best_w,
                                      best_f, default_f, history)
