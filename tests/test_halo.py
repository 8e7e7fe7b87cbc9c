"""shard_map/ppermute halo-exchange pipeline vs single-device semantics.

Runs on the 8-device CPU mesh from conftest — the same mechanism the
driver's dryrun uses — and checks the sharded sweeps are numerically
identical to the XLA reference path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from evostencils_tpu.config import config
from evostencils_tpu.parallel.mesh import make_mesh
from evostencils_tpu.parallel import halo
from evostencils_tpu.problems.poisson import poisson_2d
from evostencils_tpu.compiler.cycles import v_cycle
from evostencils_tpu.compiler.lower import lower_cycle
from evostencils_tpu.compiler.solve import make_solver
from evostencils_tpu.ir import partitioning as part


@pytest.fixture
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(jax.devices()[:8], mesh_shape=(4, 2),
                     axis_names=("x", "y"))


def _five_point(st):
    from evostencils_tpu.ops.stencil_values import five_point_values
    return five_point_values(st)


def test_sharded_sweep_matches_reference(mesh):
    problem = poisson_2d(max_level=6, min_level=5)
    st = problem.level_contexts[0].operator.entries[0][0].generate_stencil()
    vals = _five_point(st)
    rng = np.random.default_rng(0)
    n = 2 ** 6 - 1
    u = jnp.asarray(rng.standard_normal((n, n)))
    b = jnp.asarray(rng.standard_normal((n, n)))
    om = jnp.asarray(1.15, u.dtype)
    dinv = 1.0 / vals[0]

    # reference: masked half-sweeps on one device (same math as the
    # lowered RB path)
    def ref_half(u, parity):
        up = jnp.pad(u, 1)
        au = sum(v * up[1 + o0:1 + o0 + n, 1 + o1:1 + o1 + n]
                 for v, (o0, o1) in zip(
                     vals, [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]))
        ii = jnp.arange(n)
        mask = ((ii[:, None] + ii[None, :]) % 2) == parity
        return u + jnp.where(mask, om * dinv * (b - au), 0.0)

    want = ref_half(ref_half(u, 0), 1)
    got = halo.sweep(mesh, u, b, om, vals, dinv, red_black=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-13, atol=1e-13)

    want_j = u + om * dinv * (b - sum(
        v * jnp.pad(u, 1)[1 + o0:1 + o0 + n, 1 + o1:1 + o1 + n]
        for v, (o0, o1) in zip(
            vals, [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)])))
    got_j = halo.sweep(mesh, u, b, om, vals, dinv, red_black=False)
    np.testing.assert_allclose(np.asarray(got_j), np.asarray(want_j),
                               rtol=1e-13, atol=1e-13)


def test_vcycle_with_halo_pipeline_matches_and_converges(mesh):
    problem = poisson_2d(max_level=7, min_level=4)

    def build():
        cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                        pre_smoothing=2, post_smoothing=1, omega=1.15,
                        partitioning=part.RedBlack,
                        coarse_operator=problem.coarsest_operator)
        return lower_cycle(cycle, problem.approximation, problem.rhs_entity)

    b = problem.build_rhs()
    u0 = tuple(jnp.zeros_like(x) for x in b)

    lowered_ref = build()
    om = jnp.asarray(lowered_ref.default_omegas)
    ref = lowered_ref.step(u0, b, om)

    config.shard_map_mesh = mesh
    try:
        lowered_sh = build()
        got = lowered_sh.step(u0, b, om)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                                   rtol=1e-12, atol=1e-12)
        run = make_solver(lowered_sh, max_iterations=60,
                          target_reduction=1e-12)
        u, k, hist = run(u0, b, om)
        hist = np.asarray(hist)
        k = int(k)
        assert hist[k] / hist[0] <= 1e-12
    finally:
        config.shard_map_mesh = None


def test_small_levels_fall_back_to_replicated(mesh):
    # a 15x15 grid shards to <16 local rows on a 4x2 mesh -> replicated path
    u = jnp.zeros((15, 15))
    assert not halo.supports(mesh, u)
    n = 2 ** 7 - 1
    assert halo.supports(mesh, jnp.zeros((n, n)))


def test_sharded_3d_sweep_matches_reference(mesh):
    """3D 7-point sweeps shard the first two grid axes over the mesh
    (last axis local) and must match the single-device masked math."""
    from evostencils_tpu.problems.poisson import poisson_3d
    from evostencils_tpu.ops.stencil_values import seven_point_values

    problem = poisson_3d(max_level=5, min_level=2)
    st = problem.level_contexts[0].operator.entries[0][0].generate_stencil()
    vals = seven_point_values(st)
    rng = np.random.default_rng(5)
    n = 2 ** 5 - 1
    u = jnp.asarray(rng.standard_normal((n, n, n)))
    b = jnp.asarray(rng.standard_normal((n, n, n)))
    om = jnp.asarray(1.0, u.dtype)
    dinv = 1.0 / vals[0]
    offs = [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
            (0, 0, -1), (0, 0, 1)]

    def ref_au(u):
        up = jnp.pad(u, 1)
        return sum(v * up[1 + o0:1 + o0 + n, 1 + o1:1 + o1 + n,
                          1 + o2:1 + o2 + n]
                   for v, (o0, o1, o2) in zip(vals, offs))

    def ref_half(u, parity):
        # red = even node parity: interior (i,j,k) is node (i+1,j+1,k+1)
        ii = jnp.arange(n)
        mask = ((ii[:, None, None] + ii[None, :, None]
                 + ii[None, None, :] + 1) % 2) == parity
        return u + jnp.where(mask, om * dinv * (b - ref_au(u)), 0.0)

    want = ref_half(ref_half(u, 0), 1)
    got = halo.sweep(mesh, u, b, om, vals, dinv, red_black=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-13, atol=1e-13)

    want_j = u + om * dinv * (b - ref_au(u))
    got_j = halo.sweep(mesh, u, b, om, vals, dinv, red_black=False)
    np.testing.assert_allclose(np.asarray(got_j), np.asarray(want_j),
                               rtol=1e-13, atol=1e-13)


def test_3d_vcycle_with_halo_pipeline_matches(mesh):
    from evostencils_tpu.problems.poisson import poisson_3d

    problem = poisson_3d(max_level=5, min_level=2)

    def build():
        cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                        pre_smoothing=2, post_smoothing=1, omega=1.0,
                        partitioning=part.RedBlack,
                        coarse_operator=problem.coarsest_operator)
        return lower_cycle(cycle, problem.approximation, problem.rhs_entity)

    b = problem.build_rhs()
    u0 = tuple(jnp.zeros_like(x) for x in b)
    lowered_ref = build()
    om = jnp.asarray(lowered_ref.default_omegas)
    ref = lowered_ref.step(u0, b, om)

    old_min = config.shard_min_local_size
    config.shard_map_mesh = mesh
    config.shard_min_local_size = 7  # 31/4 rows local on the 4x2 mesh
    try:
        lowered_sh = build()
        got = lowered_sh.step(u0, b, om)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                                   rtol=1e-12, atol=1e-12)
    finally:
        config.shard_map_mesh = None
        config.shard_min_local_size = old_min


def test_sharded_complex_sweep_matches_reference(mesh):
    """Complex constant-star sweeps (Helmholtz shifted-Laplace smoother)
    through the same halo pipeline — collectives carry complex."""
    vals = (4.0 - 0.5j, -1.0 + 0.02j, -1.0 + 0.02j, -1.0 - 0.01j,
            -1.0 - 0.01j)
    rng = np.random.default_rng(7)
    n = 2 ** 6 - 1
    u = jnp.asarray(rng.standard_normal((n, n))
                    + 1j * rng.standard_normal((n, n)))
    b = jnp.asarray(rng.standard_normal((n, n))
                    + 1j * rng.standard_normal((n, n)))
    om = 0.6
    dinv = 1.0 / vals[0]

    def ref_half(u, parity):
        up = jnp.pad(u, 1)
        au = sum(v * up[1 + o0:1 + o0 + n, 1 + o1:1 + o1 + n]
                 for v, (o0, o1) in zip(
                     vals, [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]))
        ii = jnp.arange(n)
        mask = ((ii[:, None] + ii[None, :]) % 2) == parity
        return u + jnp.where(mask, om * dinv * (b - au), 0.0)

    want = ref_half(ref_half(u, 0), 1)
    got = halo.sweep(mesh, u, b, om, vals, dinv, red_black=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


def test_sharded_var_sweep_matches_reference(mesh):
    """Variable-coefficient sweeps: the coefficient stack shards like u
    and each device reads only its local coefficients."""
    rng = np.random.default_rng(8)
    n = 2 ** 6 - 1
    stack = np.zeros((5, n, n))
    stack[0] = 4.0 + rng.uniform(0, 1, (n, n))          # center
    for k in range(1, 5):
        stack[k] = -1.0 + 0.2 * rng.uniform(-1, 1, (n, n))
    stack_j = jnp.asarray(stack)
    u = jnp.asarray(rng.standard_normal((n, n)))
    b = jnp.asarray(rng.standard_normal((n, n)))
    om = jnp.asarray(0.9, u.dtype)

    def ref_half(u, parity):
        up = jnp.pad(u, 1)
        au = sum(stack_j[k] * up[1 + o0:1 + o0 + n, 1 + o1:1 + o1 + n]
                 for k, (o0, o1) in enumerate(
                     [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]))
        ii = jnp.arange(n)
        mask = ((ii[:, None] + ii[None, :]) % 2) == parity
        return u + jnp.where(mask, om * (b - au) / stack_j[0], 0.0)

    want = ref_half(ref_half(u, 0), 1)
    got = halo.sweep_var(mesh, u, b, om, stack_j, red_black=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)

    want_j = u + om * (b - sum(
        stack_j[k] * jnp.pad(u, 1)[1 + o0:1 + o0 + n, 1 + o1:1 + o1 + n]
        for k, (o0, o1) in enumerate(
            [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]))) / stack_j[0]
    got_j = halo.sweep_var(mesh, u, b, om, stack_j, red_black=False)
    np.testing.assert_allclose(np.asarray(got_j), np.asarray(want_j),
                               rtol=1e-12, atol=1e-12)


def test_sharded_sys_sweep_matches_reference(mesh):
    """Coupled FxF 9-point sweeps (elasticity): corner couplings need the
    two-phase ghost-ring exchange."""
    from evostencils_tpu.ops.stencil_values import NINE_OFFSETS
    rng = np.random.default_rng(9)
    n = 2 ** 6 - 1
    # 2x2 system with full 9-point entries, diagonally dominant centers
    coeffs = []
    for i in range(2):
        row = []
        for j in range(2):
            c = rng.uniform(-0.3, 0.3, 9)
            c[0] = 8.0 if i == j else 0.5
            row.append(tuple(float(v) for v in c))
        coeffs.append(tuple(row))
    coeffs = tuple(coeffs)
    centers = np.array([[coeffs[i][j][0] for j in range(2)]
                        for i in range(2)])
    minv = np.linalg.inv(centers)
    fields = tuple(jnp.asarray(rng.standard_normal((n, n)))
                   for _ in range(2))
    bs = tuple(jnp.asarray(rng.standard_normal((n, n))) for _ in range(2))
    om = jnp.asarray(0.8)

    def ref_half(fs, parity):
        rs = []
        for i in range(2):
            au = 0.0
            for j in range(2):
                up = jnp.pad(fs[j], 1)
                au = au + sum(
                    v * up[1 + o0:1 + o0 + n, 1 + o1:1 + o1 + n]
                    for v, (o0, o1) in zip(coeffs[i][j], NINE_OFFSETS))
            rs.append(bs[i] - au)
        ii = jnp.arange(n)
        mask = ((ii[:, None] + ii[None, :]) % 2) == parity
        out = []
        for i in range(2):
            upd = om * sum(minv[i][j] * rs[j] for j in range(2))
            out.append(fs[i] + jnp.where(mask, upd, 0.0))
        return tuple(out)

    want = ref_half(ref_half(fields, 0), 1)
    got = halo.sweep_sys(mesh, fields, bs, om, coeffs, minv,
                         red_black=True)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-12, atol=1e-12)


def test_var_vcycle_with_halo_pipeline_matches(mesh):
    """Variable-coefficient V-cycle: mesh lowering must equal replicated."""
    from evostencils_tpu.problems.poisson import poisson_2d_variable
    problem = poisson_2d_variable(max_level=7, min_level=4)

    def build():
        cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                        pre_smoothing=2, post_smoothing=1, omega=1.0,
                        partitioning=part.RedBlack,
                        coarse_operator=problem.coarsest_operator)
        return lower_cycle(cycle, problem.approximation, problem.rhs_entity)

    b = problem.build_rhs()
    u0 = tuple(jnp.zeros_like(x) for x in b)
    lowered_ref = build()
    om = jnp.asarray(lowered_ref.default_omegas)
    ref = lowered_ref.step(u0, b, om)

    config.shard_map_mesh = mesh
    try:
        lowered_sh = build()
        got = lowered_sh.step(u0, b, om)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                                   rtol=1e-12, atol=1e-12)
    finally:
        config.shard_map_mesh = None


def test_elasticity_vcycle_with_halo_pipeline_matches(mesh):
    """System (elasticity) V-cycle: mesh lowering must equal replicated."""
    from evostencils_tpu.problems.elasticity import linear_elasticity_2d
    from evostencils_tpu.ir import smoother

    problem = linear_elasticity_2d(max_level=7, min_level=5)

    def build():
        cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                        pre_smoothing=2, post_smoothing=1, omega=0.8,
                        partitioning=part.RedBlack,
                        smoother_factory=smoother.generate_collective_jacobi,
                        coarse_operator=problem.coarsest_operator)
        return lower_cycle(cycle, problem.approximation, problem.rhs_entity)

    b = problem.build_rhs()
    u0 = tuple(jnp.zeros_like(x) for x in b)
    lowered_ref = build()
    om = jnp.asarray(lowered_ref.default_omegas)
    ref = lowered_ref.step(u0, b, om)

    config.shard_map_mesh = mesh
    try:
        lowered_sh = build()
        got = lowered_sh.step(u0, b, om)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                       rtol=1e-12, atol=1e-12)
    finally:
        config.shard_map_mesh = None
