"""Residual + restriction, prolongation + correction and whole V-cycles of
the generic lowering (compiler/lower.py) against the numpy float64
reference, over odd, even and non-square grids in 2D and 3D."""

import numpy as np
import jax.numpy as jnp
import pytest

from evostencils_tpu.compiler.cycles import v_cycle
from evostencils_tpu.compiler.lower import _Lowering, lower_cycle
from evostencils_tpu.grids import Grid
from evostencils_tpu.ir import base
from evostencils_tpu.ir import partitioning as part
from evostencils_tpu.problems.poisson import poisson_2d, poisson_3d
from evostencils_tpu.stencils import gallery

from . import numpy_reference as ref

SHAPES = [(513, 511), (511, 513), (521, 300), (255, 255), (129, 140),
          (31, 31, 31), (33, 17, 21)]


def _grids(shape):
    fine = Grid(shape, (1.0,) * len(shape), 1)
    coarse = Grid(tuple((n - 1) // 2 for n in shape), (2.0,) * len(shape), 0)
    return fine, coarse


def _laplace_gen(dim):
    return gallery.Poisson2D() if dim == 2 else gallery.Poisson3D()


def _evaluate(expr, approx, rhs, u, b, omegas=()):
    low = _Lowering(approx, rhs, jnp.asarray(omegas, jnp.float64))
    low.bind((jnp.asarray(u),), (jnp.asarray(b),))
    return np.asarray(low.eval_function(expr)[0])


@pytest.mark.parametrize("shape", SHAPES)
def test_residual_restriction(shape):
    dim = len(shape)
    fine, coarse = _grids(shape)
    A = base.Operator("A", fine, _laplace_gen(dim))
    R = base.Restriction("R", fine, coarse,
                         gallery.FullWeightingRestrictionGenerator((2,) * dim))
    u_e, b_e = base.Approximation("u", fine), base.RightHandSide("f", fine)
    rng = np.random.default_rng(7)
    u, b = rng.standard_normal(shape), rng.standard_normal(shape)
    got = _evaluate(base.Multiplication(R, base.Residual(A, u_e, b_e)),
                    u_e, b_e, u, b)
    st = {tuple(o): v for o, v in _laplace_gen(dim).generate_stencil(
        fine).entries}
    want = ref.restrict(b - ref.apply(st, u))
    assert got.shape == coarse.size
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
def test_prolongation_correction(shape):
    """u + omega * P e as the tail of a coarse-grid-correction cycle, with
    the coarse correction e = R r bound through the lowering."""
    dim = len(shape)
    fine, coarse = _grids(shape)
    A = base.Operator("A", fine, _laplace_gen(dim))
    R = base.Restriction("R", fine, coarse,
                         gallery.FullWeightingRestrictionGenerator((2,) * dim))
    P = base.Prolongation("P", fine, coarse,
                          gallery.MultilinearInterpolationGenerator((2,) * dim))
    u_e, b_e = base.Approximation("u", fine), base.RightHandSide("f", fine)
    e = base.Multiplication(R, base.Residual(A, u_e, b_e))
    cycle = base.Cycle(u_e, b_e, base.Multiplication(P, e),
                       relaxation_factor=0.9)
    cycle.global_id = 0
    rng = np.random.default_rng(8)
    u, b = rng.standard_normal(shape), rng.standard_normal(shape)
    got = _evaluate(cycle, u_e, b_e, u, b, [0.9])
    st = {tuple(o): v for o, v in _laplace_gen(dim).generate_stencil(
        fine).entries}
    want = u + 0.9 * ref.prolong(ref.restrict(b - ref.apply(st, u)), shape)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("partitioning", ["rbgs", "jacobi"])
@pytest.mark.parametrize("levels", [(6, 3), (7, 4), (8, 5), (4, 2), (5, 2)])
def test_v_cycle(levels, partitioning):
    """Two V(2,1) cycles of the Poisson problems (2D for max level >= 6,
    3D below) from a random start."""
    max_level, min_level = levels
    problem = (poisson_2d if max_level >= 6 else poisson_3d)(
        max_level=max_level, min_level=min_level)
    red_black = partitioning == "rbgs"
    omega = 1.15 if red_black else 0.8
    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=2, post_smoothing=1, omega=omega,
                    partitioning=part.RedBlack if red_black else part.Single,
                    coarse_operator=problem.coarsest_operator)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    b = np.asarray(problem.build_rhs()[0])
    u0 = np.random.default_rng(9).standard_normal(b.shape)
    got = (jnp.asarray(u0),)
    want = u0
    for _ in range(2):
        got = lowered.step(got, (jnp.asarray(b),),
                           jnp.asarray(lowered.default_omegas))
        want = ref.poisson_v_cycle(want, b, max_level, min_level, pre=2,
                                   post=1, omega=omega, red_black=red_black)
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(np.asarray(got[0]), want, rtol=0,
                               atol=1e-10 * scale)
