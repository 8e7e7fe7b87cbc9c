"""Plain numpy float64 reference of the multigrid building blocks.

Written from the definitions (zero Dirichlet ring outside the interior
grid, node-parity red-black colouring with interior index i at node i+1,
full-weighting restriction = weighting stencil then injection at odd fine
nodes, interpolation = embedding at odd fine nodes then the interpolation
stencil), independently of the JAX lowering the tests check against it.
"""

import itertools

import numpy as np


def apply(stencil, u):
    """Apply ``{offset: coefficient}`` (each coefficient a scalar or an
    array of u's shape) with zero values outside the grid."""
    up = np.pad(u, 1)
    out = np.zeros(u.shape, dtype=np.result_type(
        u.dtype, *[np.asarray(c).dtype for c in stencil.values()]))
    for off, c in stencil.items():
        sl = tuple(slice(1 + o, 1 + o + n) for o, n in zip(off, u.shape))
        out = out + np.asarray(c) * up[sl]
    return out


def red_mask(shape):
    """True on red points: node-index sum (interior index + 1 per axis)
    even."""
    idx = sum(np.indices(shape)) + len(shape)
    return idx % 2 == 0


def smooth(u, b, residual, point_solve, omega, red_black):
    """One damped point-Jacobi sweep (``red_black=False``) or red-then-black
    sweep over fields ``u`` (tuple): ``residual(u) -> tuple`` and
    ``point_solve(r) -> tuple`` (the inverse of the smoother's diagonal)."""
    masks = ([red_mask(u[0].shape), ~red_mask(u[0].shape)] if red_black
             else [np.ones(u[0].shape, bool)])
    for mask in masks:
        c = point_solve(residual(u))
        u = tuple(ui + omega * np.where(mask, ci, 0) for ui, ci in zip(u, c))
    return u


def scalar_smooth(u, b, stencil, omega, red_black, sweeps=1):
    """Point smoother of a scalar stencil (constant or field coefficients)."""
    center = stencil[(0,) * u.ndim]
    (out,) = (u,)
    for _ in range(sweeps):
        (out,) = smooth((out,), (b,),
                        lambda v: (b - apply(stencil, v[0]),),
                        lambda r: (r[0] / center,), omega, red_black)
    return out


def system_residual(blocks, u, b):
    """b - A u for an FxF block operator of ``{offset: coeff}`` entries."""
    F = len(blocks)
    return tuple(b[i] - sum(apply(blocks[i][j], u[j]) for j in range(F))
                 for i in range(F))


def system_point_solve(centers, collective):
    """Pointwise inverse of the FxF center-coefficient matrix
    (``collective``) or of its diagonal.  ``centers[i][j]`` are scalars or
    arrays of the grid's shape."""
    F = len(centers)

    def solve(r):
        shape = r[0].shape
        C = np.empty(shape + (F, F), dtype=np.result_type(
            *[np.asarray(c).dtype for row in centers for c in row]))
        for i, j in itertools.product(range(F), range(F)):
            C[..., i, j] = centers[i][j] if collective or i == j else 0.0
        x = np.linalg.solve(C, np.stack(r, axis=-1)[..., None])[..., 0]
        return tuple(x[..., i] for i in range(F))
    return solve


def tensor(weights, dim):
    """d-fold tensor product of a centered 1D weight list as a stencil."""
    out = {}
    r = len(weights) // 2
    for idx in itertools.product(range(len(weights)), repeat=dim):
        out[tuple(i - r for i in idx)] = float(np.prod([weights[i]
                                                         for i in idx]))
    return out


FULL_WEIGHTING = (0.25, 0.5, 0.25)
INTERPOLATION = (0.5, 1.0, 0.5)


def restrict(u):
    """Full weighting, then injection at odd fine nodes."""
    w = apply(tensor(FULL_WEIGHTING, u.ndim), u)
    return w[tuple(slice(1, 2 * ((n - 1) // 2), 2) for n in u.shape)]


def prolong(e, fine_shape):
    """Embed at odd fine nodes, then apply the interpolation stencil."""
    fine = np.zeros(fine_shape, dtype=e.dtype)
    fine[tuple(slice(1, 2 * n, 2) for n in e.shape)] = e
    return apply(tensor(INTERPOLATION, e.ndim), fine)


def laplacian(dim, h):
    """The (2d+1)-point FD Laplacian on a grid of spacing h."""
    st = {(0,) * dim: 2.0 * dim / h ** 2}
    for k in range(dim):
        for s in (-1, 1):
            off = [0] * dim
            off[k] = s
            st[tuple(off)] = -1.0 / h ** 2
    return st


def dense(stencil, shape):
    """Dense matrix of a constant stencil on the interior grid."""
    n = int(np.prod(shape))
    A = np.zeros((n, n))
    for idx in np.ndindex(*shape):
        row = np.ravel_multi_index(idx, shape)
        for off, c in stencil.items():
            j = tuple(i + o for i, o in zip(idx, off))
            if all(0 <= a < m for a, m in zip(j, shape)):
                A[row, np.ravel_multi_index(j, shape)] += c
    return A


def poisson_v_cycle(u, b, level, min_level, *, pre, post, omega, red_black):
    """One V(pre, post) cycle of the FD Laplacian on the unit box at
    ``level`` (2**level - 1 interior nodes per axis), exact solve on the
    grid of ``min_level``."""
    dim = u.ndim
    st = laplacian(dim, 1.0 / 2 ** level)
    u = scalar_smooth(u, b, st, omega, red_black, pre)
    rc = restrict(b - apply(st, u))
    if level - 1 == min_level:
        shape = rc.shape
        e = np.linalg.solve(dense(laplacian(dim, 1.0 / 2 ** min_level),
                                  shape), rc.ravel()).reshape(shape)
    else:
        e = poisson_v_cycle(np.zeros_like(rc), rc, level - 1, min_level,
                            pre=pre, post=post, omega=omega,
                            red_black=red_black)
    u = u + prolong(e, u.shape)
    return scalar_smooth(u, b, st, omega, red_black, post)
