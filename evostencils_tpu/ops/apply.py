"""Stencil application kernels (pure JAX/XLA path).

Fields live on the *interior* of the grid (shape == grid.size); the implicit
Dirichlet-0 boundary ring is materialized via zero padding inside the kernel.
A constant-stencil application lowers to a handful of static slices of one
padded array plus fused multiply-adds — XLA fuses this into a single
memory-bound sweep.  Variable and
periodic coefficients become elementwise multiplies with materialized
coefficient fields, fused into the same sweep.

Lattice convention: the periodic-coefficient lattice coordinate of interior
point ``i`` (0-based, per axis) is ``(i + origin) % period`` with
``origin = 1`` — interior point 0 is grid node 1, so parity matches the
reference's node-index red-black coloring ``(i0 + i1) % 2``
(reference code_generation/exastencils.py:659-682).

Replaces the stencil loops ExaStencils generates as C++/OpenMP
(reference README.md:21-32).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..stencils import constant, periodic
from ..stencils.constant import Stencil
from ..stencils.periodic import PeriodicStencil

#: Lattice origin: interior index 0 is global node index 1 on every axis.
LATTICE_ORIGIN = 1


def result_dtype(stencil_values, u_dtype):
    vals = np.asarray(list(stencil_values))
    if np.iscomplexobj(vals):
        return jnp.promote_types(u_dtype, np.complex64)
    return u_dtype


def _shifted(u_padded, offset: Tuple[int, ...], radius: Tuple[int, ...],
             shape: Tuple[int, ...]):
    """Static slice of the padded array corresponding to u(x + offset)."""
    index = tuple(slice(r + o, r + o + n) for r, o, n in zip(radius, offset, shape))
    return u_padded[index]


def apply_constant(stencil: Stencil, u, bc: str = "dirichlet"):
    """(S u)(x) = sum_k v_k * u(x + o_k), zero outside the grid (dirichlet)
    or wrapped (periodic)."""
    if stencil.number_of_entries == 0:
        return jnp.zeros_like(u)
    radius = stencil.max_offsets
    dtype = result_dtype((v for _, v in stencil.entries), u.dtype)
    u = u.astype(dtype)
    if bc == "dirichlet":
        up = jnp.pad(u, [(r, r) for r in radius])
        acc = None
        for offset, value in stencil.entries:
            term = jnp.asarray(value, dtype) * _shifted(up, offset, radius, u.shape)
            acc = term if acc is None else acc + term
        return acc
    elif bc == "periodic":
        acc = None
        for offset, value in stencil.entries:
            term = jnp.asarray(value, dtype) * jnp.roll(u, tuple(-o for o in offset),
                                                        axis=tuple(range(u.ndim)))
            acc = term if acc is None else acc + term
        return acc
    raise ValueError(f"unknown bc {bc!r}")


def periodic_coefficient_fields(ps: PeriodicStencil, shape: Tuple[int, ...]):
    """Materialize per-offset coefficient fields of a periodic stencil.

    Returns ``[(offset, ndarray_of_shape)]`` where the ndarray holds the
    coefficient of that offset at every interior point (0 where the lattice
    point has no such entry).  Computed in numpy at trace time.
    """
    offsets = sorted({o for s in ps.constant_entries() for o, _ in s.entries})
    any_complex = any(np.iscomplexobj(np.asarray(v))
                      or isinstance(v, complex)
                      for s in ps.constant_entries() for _, v in s.entries)
    dtype = np.complex128 if any_complex else np.float64
    period = ps.period
    out = []
    for offset in offsets:
        lattice = np.zeros(period, dtype=dtype)
        for idx in np.ndindex(*period):
            s = ps.stencils[idx]
            if s is not None:
                lattice[idx] = s.value_at(offset, 0)
        out.append((offset, lattice))
    return out


def materialize_coefficient_field(lattice: np.ndarray, shape: Tuple[int, ...],
                                  dtype):
    """Tile a small period lattice out to the grid *on device* so only the
    lattice (not an O(grid) constant) is embedded in the program.

    field[i] = lattice[(i + LATTICE_ORIGIN) % period].
    """
    period = lattice.shape
    shifted = np.roll(lattice,
                      shift=tuple(-(LATTICE_ORIGIN % p) for p in period),
                      axis=tuple(range(lattice.ndim)))
    reps = tuple(-(-n // p) for n, p in zip(shape, period))
    tiled = jnp.tile(jnp.asarray(shifted, dtype), reps)
    return tiled[tuple(slice(0, n) for n in shape)]


def apply_periodic(ps: PeriodicStencil, u, bc: str = "dirichlet"):
    """Apply a periodic stencil: coefficients vary over the period lattice."""
    if ps.is_constant:
        return apply_constant(ps.to_constant(), u, bc)
    coeff_fields = periodic_coefficient_fields(ps, u.shape)
    if not coeff_fields:
        return jnp.zeros_like(u)
    dtype = result_dtype((c.reshape(-1)[0] for _, c in coeff_fields), u.dtype)
    for _, c in coeff_fields:
        if np.iscomplexobj(c):
            dtype = jnp.promote_types(dtype, jnp.complex64)
    u = u.astype(dtype)
    radius = tuple(max(abs(o[k]) for o, _ in coeff_fields)
                   for k in range(u.ndim))
    if bc == "dirichlet":
        up = jnp.pad(u, [(r, r) for r in radius])
        acc = None
        for offset, lattice in coeff_fields:
            coeff = materialize_coefficient_field(lattice, u.shape, dtype)
            term = coeff * _shifted(up, offset, radius, u.shape)
            acc = term if acc is None else acc + term
        return acc
    elif bc == "periodic":
        acc = None
        for offset, lattice in coeff_fields:
            coeff = materialize_coefficient_field(lattice, u.shape, dtype)
            term = coeff * jnp.roll(
                u, tuple(-o for o in offset), axis=tuple(range(u.ndim)))
            acc = term if acc is None else acc + term
        return acc
    raise ValueError(f"unknown bc {bc!r}")


def apply_stencil(stencil, u, bc: str = "dirichlet"):
    """Dispatch on constant vs periodic stencil."""
    if isinstance(stencil, Stencil):
        return apply_constant(stencil, u, bc)
    if isinstance(stencil, PeriodicStencil):
        return apply_periodic(stencil, u, bc)
    raise TypeError(f"not a stencil: {type(stencil)}")


def almost_uniform_desc(f, max_rows: int = 4):
    """Structure descriptor of a numpy coefficient array:

    * ``("const", c)`` — the array is the constant ``c``;
    * ``("rows", c, [(i, row - c), ...])`` — constant except on at most
      ``max_rows`` axis-0 rows;
    * ``None`` — genuinely varying.

    Boundary-folded operators (Robin columns, split-complex Helmholtz)
    produce coefficient and point-inverse arrays that are constant except
    on the first/last interior row — applying them as a scalar plus a
    couple of O(n) row fixups instead of streaming a full array removes
    the dominant coefficient HBM traffic."""
    if not (isinstance(f, np.ndarray) and f.size and f.ndim >= 1):
        return None
    c = f.flat[0]
    # probe the middle row too: for the fold pattern f.flat[0] sits ON an
    # exceptional row
    mid = np.atleast_1d(f[tuple([f.shape[0] // 2]
                               + [slice(None)] * (f.ndim - 1))])
    if mid.size and np.all(mid == mid.flat[0]):
        c = mid.flat[0]
    neq = f != c
    if not neq.any():
        return ("const", np.asarray(c).item())
    exc = np.unique(np.nonzero(neq)[0])
    if len(exc) <= max_rows:
        return ("rows", np.asarray(c).item(),
                [(int(i), np.asarray(f[int(i)] - c)) for i in exc])
    return None


def almost_uniform_mul(desc, arr, x, dtype):
    """``arr * x`` exploiting an `almost_uniform_desc` descriptor:
    returns (bulk_term, [(row_index, row_term)]) where the row terms must
    be ADDED at their rows after summation (callers accumulate all bulk
    terms first, then apply the O(n) fixups)."""
    if desc is not None and desc[0] == "const":
        return jnp.asarray(desc[1], dtype) * x, []
    if desc is not None and desc[0] == "rows":
        bulk = jnp.asarray(desc[1], dtype) * x
        return bulk, [(i, jnp.asarray(row, dtype) * x[i])
                      for i, row in desc[2]]
    return jnp.asarray(arr, dtype) * x, []


class StencilField:
    """Variable-coefficient stencil: one coefficient field per offset.

    ``fields[k]`` has the grid's interior shape and holds the coefficient of
    ``offsets[k]`` at each point.  This is the executable form of
    variable-coefficient operators (reference gallery.py:93-185 freezes them
    at a sample position instead)."""

    __slots__ = ("offsets", "fields", "_uniform")

    def __init__(self, offsets: Sequence[Tuple[int, ...]], fields):
        self.offsets = tuple(tuple(o) for o in offsets)
        self.fields = list(fields)
        self._uniform = None

    def _uniform_values(self):
        """Per-offset `almost_uniform_desc`, computed once (trace-time
        numpy work).  Most "variable-coefficient" operators in practice
        vary in few offsets and few positions (the Robin boundary fold
        touches only the diagonal, and only the first/last interior
        column): applying uniform offsets as scalars and near-uniform
        ones as scalar + cheap row updates avoids streaming a full
        coefficient array per offset — on the 2047² split-complex
        Helmholtz every block's 5 coefficient arrays reduce this way."""
        if self._uniform is None:
            self._uniform = [almost_uniform_desc(f) for f in self.fields]
        return self._uniform

    @property
    def dimension(self):
        return len(self.offsets[0])

    def apply(self, u, bc: str = "dirichlet"):
        radius = tuple(max(abs(o[k]) for o in self.offsets)
                       for k in range(u.ndim))
        # same rule as result_dtype(): the grid dtype governs precision
        # (coefficients cast down to it); complex coefficients widen kind
        # only.  Promoting to the coefficients' storage precision would
        # leak f64 into f32 solves under x64 and break scan/while carries.
        dtype = u.dtype
        for f in self.fields:
            if np.iscomplexobj(np.asarray(f)):
                dtype = jnp.promote_types(dtype, jnp.complex64)
        u = u.astype(dtype)
        if bc != "dirichlet":
            raise NotImplementedError("StencilField supports dirichlet bc only")
        up = jnp.pad(u, [(r, r) for r in radius])
        acc = None
        row_fixups = []
        for offset, coeff, uni in zip(self.offsets, self.fields,
                                      self._uniform_values()):
            sh = _shifted(up, offset, radius, u.shape)
            term, fixes = almost_uniform_mul(uni, coeff, sh, dtype)
            row_fixups.extend(fixes)
            acc = term if acc is None else acc + term
        for i, add in row_fixups:
            acc = acc.at[i].add(add)
        return acc

    def diagonal_field(self):
        zero = (0,) * self.dimension
        for o, f in zip(self.offsets, self.fields):
            if o == zero:
                return f
        raise ValueError("stencil field has no diagonal entry")

    def dense_matrix(self) -> np.ndarray:
        """Dense matrix (Dirichlet-0 outside the grid) for tests and small
        direct solves."""
        shape = np.asarray(self.fields[0]).shape
        n = int(np.prod(shape))
        dtype = np.result_type(*[np.asarray(f).dtype for f in self.fields])
        mat = np.zeros((n, n), dtype=dtype if dtype.kind == "c" else np.float64)
        for offset, coeff in zip(self.offsets, self.fields):
            coeff = np.asarray(coeff)
            for row_idx in np.ndindex(*shape):
                col_idx = tuple(i + o for i, o in zip(row_idx, offset))
                if all(0 <= c < m for c, m in zip(col_idx, shape)):
                    mat[np.ravel_multi_index(row_idx, shape),
                        np.ravel_multi_index(col_idx, shape)] += coeff[row_idx]
        return mat


def constant_stencil_field(stencil: Stencil, shape) -> StencilField:
    """Broadcast a constant stencil into field form."""
    offsets = [o for o, _ in stencil.entries]
    fields = [np.full(shape, v) for _, v in stencil.entries]
    return StencilField(offsets, fields)


# ---------------------------------------------------------------------------
# Intergrid transfers (coarsening factor 2, vertex-centered)
# ---------------------------------------------------------------------------
# Coarse interior point i_c sits at fine interior index 2*i_c + 1.
#
# Separable radius-1 transfers (all gallery transfers are tensor products)
# run as per-axis three-tap strided slices (axis_restrict_3tap /
# axis_prolong_3tap); other separable stencils as per-axis banded
# contractions (_axis_contract); non-separable ones apply the stencil and
# subsample.

def separable_factors(stencil: Stencil):
    """Factor a stencil into per-axis 1D weight vectors, or None.

    Returns ``(vectors, radii)`` with ``stencil[o] = prod_k v_k[o_k + r_k]``.
    """
    if stencil is None or stencil.number_of_entries == 0:
        return None
    d = stencil.dimension
    radii = stencil.max_offsets
    box = np.zeros(tuple(2 * r + 1 for r in radii), dtype=np.complex128)
    for offset, value in stencil.entries:
        box[tuple(o + r for o, r in zip(offset, radii))] = value
    center = tuple(radii)
    c = box[center]
    if c == 0:
        return None
    vectors = []
    for k in range(d):
        index = list(center)
        index[k] = slice(None)
        vectors.append(box[tuple(index)].copy())
    # normalize so that prod_k v_k[r_k] == c
    scale = c ** (1.0 / d)
    for k in range(d):
        vk = vectors[k]
        if vk[radii[k]] == 0:
            return None
        vectors[k] = vk * (scale / vk[radii[k]])
    recon = vectors[0]
    for vk in vectors[1:]:
        recon = np.multiply.outer(recon, vk)
    if not np.allclose(recon, box, rtol=1e-12, atol=1e-300):
        return None
    if np.allclose(box.imag, 0):
        vectors = [v.real for v in vectors]
    return vectors, radii


_TRANSFER_MATRIX_CACHE: dict = {}


def _restriction_axis_matrix(weights, radius, n_fine, n_coarse):
    """Banded (nc x nf) matrix: row i_c samples fine nodes 2*i_c+1+o."""
    key = ("R", tuple(np.asarray(weights).tolist()), radius, n_fine, n_coarse)
    m = _TRANSFER_MATRIX_CACHE.get(key)
    if m is None:
        dtype = np.complex128 if np.iscomplexobj(np.asarray(weights)) else np.float64
        m = np.zeros((n_coarse, n_fine), dtype=dtype)
        for i in range(n_coarse):
            for k, w in enumerate(weights):
                j = 2 * i + 1 + (k - radius)
                if 0 <= j < n_fine:
                    m[i, j] += w
        _TRANSFER_MATRIX_CACHE[key] = m
    return m


def _prolongation_axis_matrix(weights, radius, n_fine, n_coarse):
    """Banded (nf x nc) matrix: column i_c scatters to fine nodes 2*i_c+1+o."""
    key = ("P", tuple(np.asarray(weights).tolist()), radius, n_fine, n_coarse)
    m = _TRANSFER_MATRIX_CACHE.get(key)
    if m is None:
        dtype = np.complex128 if np.iscomplexobj(np.asarray(weights)) else np.float64
        m = np.zeros((n_fine, n_coarse), dtype=dtype)
        for i in range(n_coarse):
            for k, w in enumerate(weights):
                j = 2 * i + 1 + (k - radius)
                if 0 <= j < n_fine:
                    m[j, i] += w
        _TRANSFER_MATRIX_CACHE[key] = m
    return m


def _axis_contract(u, matrices):
    """Apply one banded matrix per axis: out = (M_0 x M_1 x ...) u."""
    out = u
    for k, m in enumerate(matrices):
        mj = jnp.asarray(m, out.dtype) if not np.iscomplexobj(m) \
            else jnp.asarray(m, jnp.promote_types(out.dtype, jnp.complex64))
        out = out.astype(mj.dtype)
        # HIGHEST: an f32 contraction may otherwise run in TF32 (~3 decimal
        # digits) on the GPU, which would perturb every transferred residual
        out = jnp.tensordot(mj, out, axes=(1, k),
                            precision=jax.lax.Precision.HIGHEST)
        # tensordot puts the contracted axis first; rotate it back to k
        out = jnp.moveaxis(out, 0, k)
    return out


def _transfer_dtype(weights, u_dtype):
    if any(isinstance(w, complex) or np.iscomplexobj(w) for w in weights):
        return jnp.promote_types(u_dtype, jnp.complex64)
    return u_dtype


def axis_restrict_3tap(u, axis, weights):
    """Banded 2:1 restriction along one axis, radius-1 three-tap form:
    ``out[i] = w[0]*u[2i] + w[1]*u[2i+1] + w[2]*u[2i+2]`` (the
    `_restriction_axis_matrix` convention, fine j = 2i+1+o).

    Equivalent to the dense axis matmul but O(n) work per output instead
    of O(n_fine): three strided slices fused into one elementwise pass.
    """
    nf = u.shape[axis]
    nc = (nf - 1) // 2
    dtype = _transfer_dtype(weights, u.dtype)
    u = u.astype(dtype)
    out = None
    for k, w in enumerate(weights):
        if w == 0:
            continue
        sl = jax.lax.slice_in_dim(u, k, k + 2 * (nc - 1) + 1, stride=2,
                                  axis=axis)
        term = jnp.asarray(w, dtype) * sl
        out = term if out is None else out + term
    if out is None:
        shape = list(u.shape)
        shape[axis] = nc
        return jnp.zeros(shape, dtype)
    return out


def axis_prolong_3tap(u, axis, weights, n_fine):
    """Banded 1:2 prolongation along one axis, radius-1 three-tap form
    (the `_prolongation_axis_matrix` convention, fine j = 2i+1+o):
    fine odd rows ``2i+1 <- w[1]*u[i]``, fine even rows
    ``2i <- w[0]*u[i] + w[2]*u[i-1]`` — built by interleaving the even
    and odd sub-lattices instead of a dense scatter-matmul."""
    nc = u.shape[axis]
    assert n_fine == 2 * nc + 1
    dtype = _transfer_dtype(weights, u.dtype)
    u = u.astype(dtype)
    w0, w1, w2 = (jnp.asarray(w, dtype) for w in weights)
    odd = w1 * u                                       # fine 2i+1, i<nc
    u_prev = jnp.concatenate(
        [jnp.zeros_like(jax.lax.slice_in_dim(u, 0, 1, axis=axis)),
         jax.lax.slice_in_dim(u, 0, nc - 1, axis=axis)], axis=axis)
    evn = w0 * u + w2 * u_prev                         # fine 2i, i<nc
    last = w2 * jax.lax.slice_in_dim(u, nc - 1, nc, axis=axis)  # fine 2nc
    inter = jnp.stack([evn, odd], axis=axis + 1)
    shape = list(u.shape)
    shape[axis] = 2 * nc
    inter = inter.reshape(shape)
    return jnp.concatenate([inter, last], axis=axis)


def restrict(stencil: Stencil, u_fine):
    """Full restriction: weighting stencil followed by injection at odd
    fine nodes (LFA convention: injection_restriction ∘ stencil,
    reference model_based_prediction/convergence.py:160-162)."""
    nf = u_fine.shape
    nc = tuple((n - 1) // 2 for n in nf)
    if stencil is None:
        return inject(u_fine)
    fac = separable_factors(stencil)
    if fac is not None:
        vectors, radii = fac
        from ..config import config
        if config.banded_transfers and all(r == 1 for r in radii):
            out = u_fine
            for k, v in enumerate(vectors):
                out = axis_restrict_3tap(out, k, tuple(v))
            return out
        mats = [_restriction_axis_matrix(v, r, n, m)
                for v, r, n, m in zip(vectors, radii, nf, nc)]
        return _axis_contract(u_fine, mats)
    # general fallback: apply then subsample
    smoothed = apply_constant(stencil, u_fine)
    index = tuple(slice(1, None, 2) for _ in range(u_fine.ndim))
    return smoothed[index]


def inject(u_fine):
    index = tuple(slice(1, None, 2) for _ in range(u_fine.ndim))
    return u_fine[index]


def prolong(stencil: Stencil, u_coarse, fine_shape: Tuple[int, ...]):
    """Interpolation: scatter coarse values onto odd fine nodes, then apply
    the fine-grid interpolation stencil (e.g. (1/2, 1, 1/2) per axis)."""
    nc = u_coarse.shape
    if stencil is not None:
        fac = separable_factors(stencil)
        if fac is not None:
            vectors, radii = fac
            from ..config import config
            if config.banded_transfers and all(r == 1 for r in radii) \
                    and all(n == 2 * m + 1
                            for n, m in zip(fine_shape, nc)):
                out = u_coarse
                for k, v in enumerate(vectors):
                    out = axis_prolong_3tap(out, k, tuple(v), fine_shape[k])
                return out
            mats = [_prolongation_axis_matrix(v, r, n, m)
                    for v, r, n, m in zip(vectors, radii, fine_shape, nc)]
            return _axis_contract(u_coarse, mats)
    dtype = result_dtype((v for _, v in stencil.entries), u_coarse.dtype) \
        if stencil is not None else u_coarse.dtype
    embedded = jnp.zeros(fine_shape, dtype=dtype)
    index = tuple(slice(1, None, 2) for _ in range(u_coarse.ndim))
    embedded = embedded.at[index].set(u_coarse.astype(dtype))
    if stencil is None:
        return embedded
    return apply_constant(stencil, embedded)


# ---------------------------------------------------------------------------
# Dense materialization (tests + small direct solves)
# ---------------------------------------------------------------------------

def dense_matrix(stencil, grid) -> np.ndarray:
    """Dense matrix of the stencil operator on the interior grid, Dirichlet-0.

    Row/column order is C order (last axis fastest).  Supports constant and
    periodic stencils; used for unit tests and small coarse-grid factorizations.
    """
    shape = tuple(grid.size)
    n = int(np.prod(shape))
    if isinstance(stencil, Stencil):
        ps = periodic.from_constant(stencil)
    else:
        ps = stencil
    any_complex = any(isinstance(v, complex) or np.iscomplexobj(np.asarray(v))
                      for s in ps.constant_entries() for _, v in s.entries)
    dtype = np.complex128 if any_complex else np.float64
    mat = np.zeros((n, n), dtype=dtype)
    period = ps.period
    for row_idx in np.ndindex(*shape):
        lattice = tuple((i + LATTICE_ORIGIN) % p for i, p in zip(row_idx, period))
        s = ps.stencils[lattice]
        if s is None:
            continue
        row = np.ravel_multi_index(row_idx, shape)
        for offset, value in s.entries:
            col_idx = tuple(i + o for i, o in zip(row_idx, offset))
            if all(0 <= c < m for c, m in zip(col_idx, shape)):
                mat[row, np.ravel_multi_index(col_idx, shape)] += value
    return mat


def dense_restriction_matrix(stencil: Stencil, fine_grid, coarse_grid) -> np.ndarray:
    weight = dense_matrix(stencil, fine_grid)
    nf = int(np.prod(fine_grid.size))
    nc = int(np.prod(coarse_grid.size))
    sel = np.zeros((nc, nf))
    for c_idx in np.ndindex(*tuple(coarse_grid.size)):
        f_idx = tuple(2 * i + 1 for i in c_idx)
        sel[np.ravel_multi_index(c_idx, tuple(coarse_grid.size)),
            np.ravel_multi_index(f_idx, tuple(fine_grid.size))] = 1.0
    return sel @ weight


def dense_prolongation_matrix(stencil: Stencil, fine_grid, coarse_grid) -> np.ndarray:
    weight = dense_matrix(stencil, fine_grid)
    nf = int(np.prod(fine_grid.size))
    nc = int(np.prod(coarse_grid.size))
    embed = np.zeros((nf, nc))
    for c_idx in np.ndindex(*tuple(coarse_grid.size)):
        f_idx = tuple(2 * i + 1 for i in c_idx)
        embed[np.ravel_multi_index(f_idx, tuple(fine_grid.size)),
              np.ravel_multi_index(c_idx, tuple(coarse_grid.size))] = 1.0
    return weight @ embed
