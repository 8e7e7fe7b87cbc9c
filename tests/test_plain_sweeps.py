"""Smoother sweeps of the generic lowering (compiler/lower.py) against the
numpy float64 reference: red-black Gauss-Seidel and damped Jacobi in 2D
and 3D over odd, even and non-square grids and 1-3 sweeps, with constant,
variable, complex and 2x2-system coefficients."""

import numpy as np
import jax.numpy as jnp
import pytest

from evostencils_tpu.compiler.cycles import LevelContext, smooth
from evostencils_tpu.compiler.lower import _stencil_field_of, lower_cycle
from evostencils_tpu.grids import Grid
from evostencils_tpu.ir import base, smoother, system
from evostencils_tpu.ir import partitioning as part
from evostencils_tpu.problems.elasticity import _EntryGenerator
from evostencils_tpu.stencils import gallery

from . import numpy_reference as ref

PARTITIONINGS = {"rbgs": part.RedBlack, "jacobi": part.Single}


def _run_sweeps(entries, grid, u, b, omega, partitioning, sweeps,
                smoother_factory=smoother.generate_collective_jacobi):
    """``sweeps`` smoother cycles of the FxF operator ``entries`` (rows of
    base operators) lowered through lower_cycle and run once."""
    F = len(entries)
    op = system.Operator("A", entries)
    approx = system.Approximation(
        "u", [base.Approximation(f"u{i}", grid) for i in range(F)])
    rhs = system.RightHandSide(
        "f", [base.RightHandSide(f"f{i}", grid) for i in range(F)])
    level = LevelContext(operator=op, restriction=None, prolongation=None,
                         approximation=approx, grid=[grid] * F)
    state = (approx, rhs)
    for _ in range(sweeps):
        state = smooth(state, level, omega, PARTITIONINGS[partitioning],
                       smoother_factory)
    lowered = lower_cycle(state[0], approx, rhs)
    out = lowered.step(tuple(jnp.asarray(x) for x in u),
                       tuple(jnp.asarray(x) for x in b),
                       jnp.asarray(lowered.default_omegas))
    return tuple(np.asarray(x) for x in out)


def _data(shape, seed, dtype=np.float64, fields=1):
    rng = np.random.default_rng(seed)
    draw = (lambda: rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) \
        if np.issubdtype(dtype, np.complexfloating) \
        else (lambda: rng.standard_normal(shape))
    return (tuple(draw().astype(dtype) for _ in range(fields)),
            tuple(draw().astype(dtype) for _ in range(fields)))


def _stencil_dict(st):
    return {tuple(o): v for o, v in st.entries}


SHAPES_2D = [(257, 255), (129, 130), (96, 140), (256, 128), (300, 200),
             (255, 255), (129, 140)]


@pytest.mark.parametrize("partitioning", ["rbgs", "jacobi"])
@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES_2D)
def test_constant_sweeps_2d(shape, sweeps, partitioning):
    grid = Grid(shape, (1.0, 1.0), 0)
    gen = gallery.Poisson2D()
    u, b = _data(shape, 1)
    omega = 1.15 if partitioning == "rbgs" else 0.8
    (got,) = _run_sweeps([[base.Operator("A", grid, gen)]], grid, u, b,
                         omega, partitioning, sweeps)
    want = ref.scalar_smooth(u[0], b[0],
                             _stencil_dict(gen.generate_stencil(grid)),
                             omega, partitioning == "rbgs", sweeps)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("partitioning", ["rbgs", "jacobi"])
@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("shape", [(17, 16, 33), (31, 31, 31), (16, 24, 20),
                                   (33, 17, 9)])
def test_constant_sweeps_3d(shape, sweeps, partitioning):
    grid = Grid(shape, (1.0, 0.5, 2.0), 0)
    gen = gallery.Poisson3D()
    u, b = _data(shape, 2)
    omega = 1.15 if partitioning == "rbgs" else 0.8
    (got,) = _run_sweeps([[base.Operator("A", grid, gen)]], grid, u, b,
                         omega, partitioning, sweeps)
    want = ref.scalar_smooth(u[0], b[0],
                             _stencil_dict(gen.generate_stencil(grid)),
                             omega, partitioning == "rbgs", sweeps)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("partitioning", ["rbgs", "jacobi"])
@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("shape", [(129, 130), (96, 140), (255, 255)])
def test_variable_coefficient_sweeps(shape, sweeps, partitioning):
    grid = Grid(shape, tuple(1.0 / (n + 1) for n in shape), 0)
    op = base.Operator("A", grid, gallery.Poisson2DVariableCoefficients())
    sf = _stencil_field_of(op)
    u, b = _data(shape, 3)
    omega = 1.15 if partitioning == "rbgs" else 0.8
    (got,) = _run_sweeps([[op]], grid, u, b, omega, partitioning, sweeps)
    coeffs = {tuple(o): np.asarray(f) for o, f in zip(sf.offsets, sf.fields)}
    want = ref.scalar_smooth(u[0], b[0], coeffs, omega,
                             partitioning == "rbgs", sweeps)
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("partitioning", ["rbgs", "jacobi"])
@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("shape", [(129, 130), (96, 140), (127, 127)])
def test_complex_sweeps(shape, sweeps, partitioning):
    """Shifted-Laplace Helmholtz operator: complex constant 5-point."""
    grid = Grid(shape, (1.0, 1.0), 0)
    gen = gallery.Helmholtz2D(0.5, 0.5j)
    u, b = _data(shape, 4, np.complex128)
    omega = 0.6 if partitioning == "rbgs" else 0.5
    (got,) = _run_sweeps([[base.Operator("A", grid, gen)]], grid, u, b,
                         omega, partitioning, sweeps)
    want = ref.scalar_smooth(u[0], b[0],
                             _stencil_dict(gen.generate_stencil(grid)),
                             omega, partitioning == "rbgs", sweeps)
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("point_solve", ["collective", "decoupled"])
@pytest.mark.parametrize("partitioning", ["rbgs", "jacobi"])
@pytest.mark.parametrize("shape", [(63, 63), (64, 40), (33, 50)])
def test_system_sweeps(shape, partitioning, point_solve):
    """2x2 linear-elasticity block system with collective (point 2x2
    solve) or decoupled (per-field diagonal) smoothing."""
    grid = Grid(shape, (1.0, 1.0), 0)
    entries = [[base.Operator(f"A{i}{j}", grid, _EntryGenerator((i, j)))
                for j in range(2)] for i in range(2)]
    factory = (smoother.generate_collective_jacobi
               if point_solve == "collective"
               else smoother.generate_decoupled_jacobi)
    u, b = _data(shape, 5, fields=2)
    omega = 1.25 if partitioning == "rbgs" else 0.7
    got = _run_sweeps(entries, grid, u, b, omega, partitioning, 2, factory)
    blocks = [[_stencil_dict(_EntryGenerator((i, j)).generate_stencil(grid))
               for j in range(2)] for i in range(2)]
    centers = [[blocks[i][j].get((0, 0), 0.0) for j in range(2)]
               for i in range(2)]
    want = u
    for _ in range(2):
        want = ref.smooth(want, b,
                          lambda v: ref.system_residual(blocks, v, b),
                          ref.system_point_solve(
                              centers, point_solve == "collective"),
                          omega, partitioning == "rbgs")
    scale = max(np.max(np.abs(w)) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * scale)
