"""Banded (strided-slice) axis transfers vs the dense axis-matrix forms.

The radius-1 three-tap banded forms (ops/apply.axis_restrict_3tap /
axis_prolong_3tap) must reproduce the `_restriction_axis_matrix` /
`_prolongation_axis_matrix` contractions exactly — they replace an
O(nc*nf)-FLOP contraction per axis with strided slices at fine levels.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from evostencils_tpu.ops import apply as ops


def _rand(shape, complex_=False, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
    return jnp.asarray(x)


@pytest.mark.parametrize("axis,shape", [
    (0, (13,)), (0, (9, 17)), (1, (9, 17)), (0, (7, 9, 5)),
    (1, (7, 9, 5)), (2, (7, 9, 5)),
])
@pytest.mark.parametrize("weights", [
    (0.25, 0.5, 0.25), (0.3, 1.0, -0.2), (0.25 + 0.1j, 0.5, 0.25),
    (0.0, 1.0, 0.0),
])
def test_axis_restrict_3tap_matches_matrix(axis, shape, weights):
    u = _rand(shape, complex_=any(isinstance(w, complex) for w in weights))
    nf = shape[axis]
    nc = (nf - 1) // 2
    M = ops._restriction_axis_matrix(list(weights), 1, nf, nc)
    expected = np.moveaxis(
        np.tensordot(M, np.asarray(u), axes=(1, axis)), 0, axis)
    got = np.asarray(ops.axis_restrict_3tap(u, axis, weights))
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("axis,shape", [
    (0, (6,)), (0, (4, 8)), (1, (4, 8)), (0, (3, 4, 2)),
    (1, (3, 4, 2)), (2, (3, 4, 2)),
])
@pytest.mark.parametrize("weights", [
    (0.5, 1.0, 0.5), (0.4, 0.9, -0.3), (0.5, 1.0 + 0.2j, 0.5),
])
def test_axis_prolong_3tap_matches_matrix(axis, shape, weights):
    u = _rand(shape, complex_=any(isinstance(w, complex) for w in weights))
    nc = shape[axis]
    nf = 2 * nc + 1
    M = ops._prolongation_axis_matrix(list(weights), 1, nf, nc)
    expected = np.moveaxis(
        np.tensordot(M, np.asarray(u), axes=(1, axis)), 0, axis)
    got = np.asarray(ops.axis_prolong_3tap(u, axis, weights, nf))
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-14)


def test_restrict_prolong_roundtrip_unchanged():
    """Full-weighting restrict and bilinear prolong through the public
    restrict/prolong entry points still match their dense matrices after
    any backend switch (reference stencils/gallery.py:188-219 operators)."""
    from evostencils_tpu.stencils import gallery
    from evostencils_tpu.grids import Grid
    lvl = 4
    n = 2 ** lvl - 1
    g = Grid(size=(n, n), spacing=(1 / 2 ** lvl,) * 2, level=lvl)
    coarse = Grid(size=((n - 1) // 2,) * 2, spacing=(2 / 2 ** lvl,) * 2,
                  level=lvl - 1)
    R = gallery.FullWeightingRestrictionGenerator((2, 2)).generate_stencil(g)
    P = gallery.MultilinearInterpolationGenerator((2, 2)).generate_stencil(g)
    u = _rand((n, n), seed=3)
    rc = np.asarray(ops.restrict(R, u))
    MR = ops.dense_restriction_matrix(R, g, coarse)
    np.testing.assert_allclose(
        rc.reshape(-1), MR @ np.asarray(u).reshape(-1), rtol=1e-12,
        atol=1e-13)
    if P is not None:
        e = _rand(((n - 1) // 2,) * 2, seed=4)
        pf = np.asarray(ops.prolong(P, e, (n, n)))
        MP = ops.dense_prolongation_matrix(P, g, coarse)
        np.testing.assert_allclose(
            pf.reshape(-1), MP @ np.asarray(e).reshape(-1), rtol=1e-12,
            atol=1e-13)
