"""Split-complex Helmholtz smoothing with the Robin fold: the 2x2 block
operator's center coefficients differ from the interior on the first and
last interior row (problems/helmholtz.py HelmholtzOperatorGenerator,
reference Helmholtz/2D_FD_Helmholtz_fromL3.exa4:24-40).  The generic
lowering applies those rows as scalar-plus-row fixups
(ops/apply.almost_uniform_desc); its sweeps must match the numpy float64
reference that applies the full coefficient fields."""

import numpy as np
import jax.numpy as jnp
import pytest

from evostencils_tpu.compiler.cycles import smooth
from evostencils_tpu.compiler.lower import _stencil_field_of, lower_cycle
from evostencils_tpu.ir import partitioning as part
from evostencils_tpu.ops.apply import almost_uniform_desc
from evostencils_tpu.problems.helmholtz import helmholtz_2d_split

from . import numpy_reference as ref


def _fields(op):
    """Per-entry ``{offset: coefficient field}`` of the block operator."""
    out = []
    for row in op.entries:
        out.append([])
        for e in row:
            sf = _stencil_field_of(e)
            out[-1].append({tuple(o): np.asarray(f)
                            for o, f in zip(sf.offsets, sf.fields)})
    return out


def test_robin_rows_are_exceptions():
    problem = helmholtz_2d_split(max_level=6, min_level=3)
    blocks = _fields(problem.level_contexts[0].operator)
    n = problem.finest_grid[0].size[0]
    for row in blocks:
        for entry in row:
            desc = almost_uniform_desc(entry[(0, 0)])
            assert desc is not None and desc[0] == "rows"
            assert [i for i, _ in desc[2]] == [0, n - 1]


@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("partitioning", ["rbgs", "jacobi"])
@pytest.mark.parametrize("level", [5, 6, 7])
def test_split_helmholtz_sweeps(level, partitioning, sweeps):
    problem = helmholtz_2d_split(max_level=level, min_level=3)
    ctx = problem.level_contexts[0]
    red_black = partitioning == "rbgs"
    omega = 0.6
    state = (problem.approximation, problem.rhs_entity)
    for _ in range(sweeps):
        state = smooth(state, ctx, omega,
                       part.RedBlack if red_black else part.Single)
    lowered = lower_cycle(state[0], problem.approximation,
                          problem.rhs_entity)
    shape = tuple(problem.finest_grid[0].size)
    rng = np.random.default_rng(level)
    u = tuple(rng.standard_normal(shape) for _ in range(2))
    b = tuple(rng.standard_normal(shape) for _ in range(2))
    got = lowered.step(tuple(jnp.asarray(x) for x in u),
                       tuple(jnp.asarray(x) for x in b),
                       jnp.asarray(lowered.default_omegas))

    blocks = _fields(ctx.operator)
    centers = [[blocks[i][j][(0, 0)] for j in range(2)] for i in range(2)]
    want = u
    for _ in range(sweeps):
        want = ref.smooth(want, b,
                          lambda v: ref.system_residual(blocks, v, b),
                          ref.system_point_solve(centers, True), omega,
                          red_black)
    scale = max(np.max(np.abs(w)) for w in want)
    for g, w in zip(got, want):
        g = np.asarray(g)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * scale)
        # the folded rows themselves
        np.testing.assert_allclose(g[[0, -1]], w[[0, -1]], rtol=0,
                                   atol=1e-12 * scale)
