"""Explicit shard_map halo-exchange smoother pipeline.

Replacement for the reference's domain-decomposed solver tier
(ExaStencils blocks/fragments with ghost-layer ``communicate`` statements,
lib/domain_onePatch.knowledge:1-8, FAS_2D_Basic_template.exa4:7-10): the
grid is block-partitioned over a 2D device mesh and each smoother sweep
exchanges a one-cell halo with its mesh neighbors via ``lax.ppermute``
over the device interconnect (NVLink between the cards of one host).  2D
grids shard both axes; 3D grids shard their first two axes (four face
halos) and keep the last, contiguous axis local.

Overlap structure: the bulk of the stencil contraction only reads the local
block, so it carries no data dependence on the ppermute results — XLA's
latency-hiding scheduler runs the halo transfers concurrently with the
interior compute, and only the edge-row/column fix-up waits on them.
Devices at the physical boundary receive zeros from the (absent) neighbor,
which is exactly the homogeneous-Dirichlet ghost convention of the
single-device path.

Used by the cycle compiler when ``config.shard_map_mesh`` is set: fine
levels whose local blocks are at least ``config.shard_min_local_size`` run
sharded; coarser levels fall back to the replicated XLA path (SURVEY.md
§7.5 per-level sharding policy).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map  # jax >= 0.8
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def _mesh_shape_2d(mesh: Mesh) -> Tuple[int, int]:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return sizes.get("x", 1), sizes.get("y", 1)


def supports(mesh: Mesh, u) -> bool:
    """Sharded sweeps need a 2D/3D grid (real or complex — XLA lowers
    complex collectives to (re, im) pairs) with mesh axes named x/y and
    a large-enough local block (coarse levels run replicated).  3D grids
    shard their first two axes over the mesh; the last, contiguous axis
    stays local."""
    from ..config import config
    if u.ndim not in (2, 3):
        return False
    if not {"x", "y"} <= set(mesh.axis_names):
        return False
    nx, ny = _mesh_shape_2d(mesh)
    n, m = u.shape[:2]
    return (n // nx >= config.shard_min_local_size
            and m // ny >= config.shard_min_local_size)


def _edge(c, idx):
    """Coefficient slice for the edge fix-up: scalars broadcast, arrays
    (variable coefficients, sharded like u) index their local edge."""
    return c[idx] if hasattr(c, "ndim") and c.ndim == 2 else c


def _half_sweep(u, b, om, *, vals, dinv, parity, n_global, local_shape,
                mesh_shape):
    """One masked damped-Jacobi half-sweep on the local block (inside
    shard_map).  parity: -1 full sweep, 0 red, 1 black (global node
    parity, matching compiler/lower.red_black_masks).  Coefficients in ``vals`` (and
    ``dinv``) may be python scalars — real or complex constant stencils —
    or local (nl, ml) blocks of sharded coefficient fields
    (variable-coefficient operators)."""
    c0, c_up, c_down, c_left, c_right = vals
    nl, ml = local_shape
    nx, ny = mesh_shape
    n, m = n_global

    # halo exchange: edge rows/cols to/from mesh neighbors (missing
    # neighbors contribute zeros == Dirichlet ghost ring)
    up_halo = lax.ppermute(u[-1:, :], "x", [(i, i + 1) for i in range(nx - 1)])
    down_halo = lax.ppermute(u[:1, :], "x", [(i + 1, i) for i in range(nx - 1)])
    left_halo = lax.ppermute(u[:, -1:], "y", [(j, j + 1) for j in range(ny - 1)])
    right_halo = lax.ppermute(u[:, :1], "y", [(j + 1, j) for j in range(ny - 1)])

    # interior contraction: local-only reads, no dependence on the halos
    zrow = jnp.zeros((1, ml), u.dtype)
    zcol = jnp.zeros((nl, 1), u.dtype)
    up = jnp.concatenate([zrow, u[:-1, :]], axis=0)      # u[r-1]
    down = jnp.concatenate([u[1:, :], zrow], axis=0)     # u[r+1]
    left = jnp.concatenate([zcol, u[:, :-1]], axis=1)    # u[:, c-1]
    right = jnp.concatenate([u[:, 1:], zcol], axis=1)    # u[:, c+1]
    au = c0 * u + c_up * up + c_down * down + c_left * left + c_right * right

    # edge fix-up (waits on the halos)
    au = au.at[0, :].add(_edge(c_up, 0) * up_halo[0, :])
    au = au.at[-1, :].add(_edge(c_down, -1) * down_halo[0, :])
    au = au.at[:, 0].add(_edge(c_left, (slice(None), 0)) * left_halo[:, 0])
    au = au.at[:, -1].add(_edge(c_right, (slice(None), -1))
                          * right_halo[:, 0])

    ix = lax.axis_index("x")
    iy = lax.axis_index("y")
    row_ids = ix * nl + lax.broadcasted_iota(jnp.int32, (nl, ml), 0)
    col_ids = iy * ml + lax.broadcasted_iota(jnp.int32, (nl, ml), 1)
    valid = (row_ids < n) & (col_ids < m)
    update = om * dinv * (b - au)
    if parity >= 0:
        update = jnp.where(((row_ids + col_ids) % 2) == parity, update, 0.0)
    return jnp.where(valid, u + update, u)


def _half_sweep_3d(u, b, om, *, vals, dinv, parity, n_global, local_shape,
                   mesh_shape):
    """One masked damped-Jacobi half-sweep of a 7-point stencil on the
    local 3D block (inside shard_map).  The first two grid axes shard
    over mesh axes x/y; the last axis is local, so only four halo faces
    exchange.  vals order matches ops/stencil_values.seven_point_values:
    (center, -x, +x, -y, +y, -z, +z)."""
    c0, cxm, cxp, cym, cyp, czm, czp = vals
    nl, ml, kl = local_shape
    nx, ny = mesh_shape
    n, m, k = n_global

    # face halos to/from mesh neighbors (missing neighbor -> zeros ==
    # homogeneous-Dirichlet ghost layer)
    xm_halo = lax.ppermute(u[-1:, :, :], "x", [(i, i + 1) for i in range(nx - 1)])
    xp_halo = lax.ppermute(u[:1, :, :], "x", [(i + 1, i) for i in range(nx - 1)])
    ym_halo = lax.ppermute(u[:, -1:, :], "y", [(j, j + 1) for j in range(ny - 1)])
    yp_halo = lax.ppermute(u[:, :1, :], "y", [(j + 1, j) for j in range(ny - 1)])

    # interior contraction (local-only reads; overlaps with the ppermutes)
    zx = jnp.zeros((1, ml, kl), u.dtype)
    zy = jnp.zeros((nl, 1, kl), u.dtype)
    zz = jnp.zeros((nl, ml, 1), u.dtype)
    au = (c0 * u
          + cxm * jnp.concatenate([zx, u[:-1]], axis=0)
          + cxp * jnp.concatenate([u[1:], zx], axis=0)
          + cym * jnp.concatenate([zy, u[:, :-1]], axis=1)
          + cyp * jnp.concatenate([u[:, 1:], zy], axis=1)
          + czm * jnp.concatenate([zz, u[:, :, :-1]], axis=2)
          + czp * jnp.concatenate([u[:, :, 1:], zz], axis=2))

    # face fix-up (waits on the halos)
    au = au.at[0, :, :].add(cxm * xm_halo[0])
    au = au.at[-1, :, :].add(cxp * xp_halo[0])
    au = au.at[:, 0, :].add(cym * ym_halo[:, 0])
    au = au.at[:, -1, :].add(cyp * yp_halo[:, 0])

    ix = lax.axis_index("x")
    iy = lax.axis_index("y")
    shape = (nl, ml, kl)
    i_ids = ix * nl + lax.broadcasted_iota(jnp.int32, shape, 0)
    j_ids = iy * ml + lax.broadcasted_iota(jnp.int32, shape, 1)
    k_ids = lax.broadcasted_iota(jnp.int32, shape, 2)
    valid = (i_ids < n) & (j_ids < m)
    update = om * dinv * (b - au)
    if parity >= 0:
        # red = even NODE parity; interior (i,j,k) is node (i+1,j+1,k+1),
        # so red interior indices have odd index sum (matches rbgs3d.py
        # and lower.red_black_masks)
        update = jnp.where(((i_ids + j_ids + k_ids + 1) % 2) == parity,
                           update, 0.0)
    return jnp.where(valid, u + update, u)


def _padded(u, nx, ny):
    n, m = u.shape[:2]
    pad = ((0, -n % nx), (0, -m % ny)) + ((0, 0),) * (u.ndim - 2)
    return jnp.pad(u, pad)


def sweep(mesh: Mesh, u, b, om, vals, dinv, *, red_black: bool):
    """Full smoother sweep (red+black halves, or one Jacobi pass) with the
    grid block-sharded over the mesh.  Accepts the unpadded (2^l - 1) grid;
    padding to mesh-divisible shape happens here and the padded ring is
    masked out inside the sweep.  2D grids use the 5-point pipeline, 3D
    grids the 7-point face-halo pipeline (last axis local)."""
    nx, ny = _mesh_shape_2d(mesh)
    n_global = u.shape
    up, bp = _padded(u, nx, ny), _padded(b, nx, ny)
    local_shape = (up.shape[0] // nx, up.shape[1] // ny) + up.shape[2:]

    half = _half_sweep if u.ndim == 2 else _half_sweep_3d
    spec = P("x", "y") if u.ndim == 2 else P("x", "y", None)
    kernel = functools.partial(
        half, vals=vals, dinv=dinv, n_global=n_global,
        local_shape=local_shape, mesh_shape=(nx, ny))

    def run(parity):
        return shard_map(
            functools.partial(kernel, parity=parity), mesh=mesh,
            in_specs=(spec, spec, P()), out_specs=spec)

    if red_black:
        up_new = run(0)(up, bp, om)
        up_new = run(1)(up_new, bp, om)
    else:
        up_new = run(-1)(up, bp, om)
    return up_new[tuple(slice(0, s) for s in n_global)]


def sweep_var(mesh: Mesh, u, b, om, stack, *, red_black: bool):
    """Variable-coefficient smoother sweep under the halo pipeline: the
    (5, n, m) coefficient stack (ops/stencil_values.five_point_stack
    order: center, -x, +x, -y, +y) shards exactly like u, so each
    device's stencil coefficients are local and only u's one-cell halo
    rides the ppermutes."""
    nx, ny = _mesh_shape_2d(mesh)
    n_global = u.shape
    up, bp = _padded(u, nx, ny), _padded(b, nx, ny)
    n, m = n_global
    cp = jnp.pad(stack, ((0, 0), (0, -n % nx), (0, -m % ny)))
    local_shape = (up.shape[0] // nx, up.shape[1] // ny)
    spec = P("x", "y")
    cspec = P(None, "x", "y")

    def kernel(u_l, b_l, c_l, om_l, *, parity):
        vals = tuple(c_l[k] for k in range(5))
        safe = jnp.where(c_l[0] != 0, c_l[0], 1.0)   # padded ring has c0=0
        dinv = jnp.where(c_l[0] != 0, 1.0 / safe, 0.0)
        return _half_sweep(u_l, b_l, om_l, vals=vals, dinv=dinv,
                           parity=parity, n_global=n_global,
                           local_shape=local_shape, mesh_shape=(nx, ny))

    def run(parity):
        return shard_map(
            functools.partial(kernel, parity=parity), mesh=mesh,
            in_specs=(spec, spec, cspec, P()), out_specs=spec)

    if red_black:
        up_new = run(0)(up, bp, cp, om)
        up_new = run(1)(up_new, bp, cp, om)
    else:
        up_new = run(-1)(up, bp, cp, om)
    return up_new[:n, :m]


def _ghost_ring(u, nx, ny):
    """Local block extended by a one-cell ghost ring, corners included:
    row halos first, then column halos OF THE EXTENDED BLOCK so the
    corner ghost arrives via the neighbor's already-placed row halo (the
    standard two-phase exchange for 9-point stencils).  Missing
    neighbors contribute zeros (homogeneous-Dirichlet ghosts)."""
    nl, ml = u.shape
    up_halo = lax.ppermute(u[-1:, :], "x", [(i, i + 1) for i in range(nx - 1)])
    down_halo = lax.ppermute(u[:1, :], "x", [(i + 1, i) for i in range(nx - 1)])
    ug = jnp.zeros((nl + 2, ml + 2), u.dtype)
    ug = ug.at[1:-1, 1:-1].set(u)
    ug = ug.at[0, 1:-1].set(up_halo[0])
    ug = ug.at[-1, 1:-1].set(down_halo[0])
    left_halo = lax.ppermute(ug[:, -2:-1], "y",
                             [(j, j + 1) for j in range(ny - 1)])
    right_halo = lax.ppermute(ug[:, 1:2], "y",
                              [(j + 1, j) for j in range(ny - 1)])
    ug = ug.at[:, :1].set(left_halo)
    ug = ug.at[:, -1:].set(right_halo)
    return ug


_NINE_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
                 (-1, -1), (-1, 1), (1, -1), (1, 1))


def _sys_half_sweep(fields, b_fields, om, *, coeffs, minv, parity, n_global,
                    local_shape, mesh_shape):
    """Coupled FxF 9-point half-sweep on ghost-ring-extended local blocks
    (corner couplings of e.g. elasticity need the two-phase exchange)."""
    F = len(fields)
    nl, ml = local_shape
    nx, ny = mesh_shape
    n, m = n_global
    ghosts = [_ghost_ring(f, nx, ny) for f in fields]

    ix = lax.axis_index("x")
    iy = lax.axis_index("y")
    row_ids = ix * nl + lax.broadcasted_iota(jnp.int32, (nl, ml), 0)
    col_ids = iy * ml + lax.broadcasted_iota(jnp.int32, (nl, ml), 1)
    valid = (row_ids < n) & (col_ids < m)

    residuals = []
    for i in range(F):
        au = None
        for j in range(F):
            c = coeffs[i][j]
            for (di, dj), cv in zip(_NINE_OFFSETS, c):
                if cv == 0.0:
                    continue
                term = cv * ghosts[j][1 + di:1 + di + nl,
                                      1 + dj:1 + dj + ml]
                au = term if au is None else au + term
        r = b_fields[i] - (au if au is not None
                           else jnp.zeros_like(b_fields[i]))
        residuals.append(r)

    out = []
    for i in range(F):
        upd = None
        for j in range(F):
            if minv[i][j] == 0.0:
                continue
            term = minv[i][j] * residuals[j]
            upd = term if upd is None else upd + term
        upd = om * (upd if upd is not None
                    else jnp.zeros_like(residuals[i]))
        if parity >= 0:
            upd = jnp.where(((row_ids + col_ids) % 2) == parity, upd, 0.0)
        out.append(jnp.where(valid, fields[i] + upd, fields[i]))
    return tuple(out)


def sweep_sys(mesh: Mesh, fields, b_fields, om, coeffs, minv, *,
              red_black: bool):
    """Coupled system smoother sweep (FxF constant 9-point entries, e.g.
    linear elasticity) under the halo pipeline.  ``coeffs[i][j]`` is the
    9-tuple of entry (i,j) in ops/stencil_values.NINE_OFFSETS order;
    ``minv`` the constant FxF point-solve matrix."""
    nx, ny = _mesh_shape_2d(mesh)
    n_global = fields[0].shape
    n, m = n_global
    fp = tuple(_padded(f, nx, ny) for f in fields)
    bp = tuple(_padded(f, nx, ny) for f in b_fields)
    local_shape = (fp[0].shape[0] // nx, fp[0].shape[1] // ny)
    F = len(fields)
    spec = P("x", "y")

    def kernel(*args, parity):
        fs, bs, om_l = args[:F], args[F:2 * F], args[2 * F]
        return _sys_half_sweep(fs, bs, om_l, coeffs=coeffs, minv=minv,
                               parity=parity, n_global=n_global,
                               local_shape=local_shape, mesh_shape=(nx, ny))

    def run(parity):
        return shard_map(
            functools.partial(kernel, parity=parity), mesh=mesh,
            in_specs=(spec,) * (2 * F) + (P(),), out_specs=(spec,) * F)

    cur = fp
    if red_black:
        cur = run(0)(*cur, *bp, om)
        cur = run(1)(*cur, *bp, om)
    else:
        cur = run(-1)(*cur, *bp, om)
    return tuple(f[:n, :m] for f in cur)
