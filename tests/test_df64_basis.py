"""Full-df64-recurrence split BiCGStab: the
Krylov basis, dots, scalars and matvec carried as double-float words
reach TRUE 1e-7 on f32 arithmetic where the f32-basis recurrence walls
(reference bar: the all-f64 C++ protocol,
Helmholtz/2D_FD_Helmholtz_fromL3.exa3:144-201)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from evostencils_tpu.problems.helmholtz import helmholtz_2d_split
from evostencils_tpu.compiler.cycles import v_cycle
from evostencils_tpu.compiler.lower import lower_cycle
from evostencils_tpu.compiler.refine_split import (
    split_system_residual_df, split_system_matvec_df,
    df64_basis_bicgstab_split, _vdf_from)
from evostencils_tpu.ir import partitioning as part
from evostencils_tpu.ir import smoother


def test_matvec_df_matches_residual_df():
    p = helmholtz_2d_split(max_level=5, min_level=3, k=40.0)
    p.dtype = np.float32
    op = p.outer_solver.operator
    rng = np.random.default_rng(3)
    u = tuple(jnp.asarray(rng.standard_normal((31, 31)), jnp.float32)
              for _ in range(len(op.entries)))
    b = tuple(jnp.asarray(rng.standard_normal((31, 31)), jnp.float32)
              for _ in range(len(op.entries)))
    au_hi, au_lo = split_system_matvec_df(op)(_vdf_from(u))
    r_hi, r_lo = split_system_residual_df(op)(u, tuple(
        jnp.zeros_like(f) for f in u), b)
    # residual(u, b) == b - A u, compared in f64 on the host
    for bb, ah, al, rh, rl in zip(b, au_hi, au_lo, r_hi, r_lo):
        lhs = np.asarray(bb, np.float64) - (
            np.asarray(ah, np.float64) + np.asarray(al, np.float64))
        rhs = np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
        scale = np.abs(lhs).max() + 1.0
        np.testing.assert_allclose(lhs / scale, rhs / scale, atol=1e-12)


@pytest.mark.slow
def test_df64_basis_reaches_true_1em7():
    p = helmholtz_2d_split(max_level=6, min_level=3, k=40.0)
    p.dtype = np.float32
    cyc = v_cycle(p.level_contexts, p.rhs_entity, pre_smoothing=2,
                  post_smoothing=1, omega=0.6, partitioning=part.RedBlack,
                  smoother_factory=smoother.generate_collective_jacobi,
                  coarse_operator=p.coarsest_operator)
    low = lower_cycle(cyc, p.approximation, p.rhs_entity)
    om = jnp.asarray(low.default_omegas, jnp.float32)
    b = p.rhs_builder(np.float32)

    def precond(fields):
        zero = tuple(jnp.zeros_like(f) for f in fields)
        return low.step(zero, fields, om)

    matvec_df = split_system_matvec_df(p.outer_solver.operator)
    residual_df = split_system_residual_df(p.outer_solver.operator)
    x_hi, x_lo, k, hist = df64_basis_bicgstab_split(
        matvec_df, precond, residual_df, b, tol=1e-7, maxiter=600,
        segment=50)
    assert hist[-1] <= 1.1e-7
    assert k < 600
