"""Sharded execution wrappers.

Grids in this framework have odd interior sizes (2^l - 1), while explicit
XLA shardings at jit boundaries require axis sizes divisible by the mesh.
``sharded_step`` therefore exposes a padded public layout (next multiple of
the mesh axes) and crops/re-pads inside the jitted program; the SPMD
partitioner keeps all intermediates distributed and inserts the halo
exchanges for stencil shifts.

This is the GSPMD tier of the distribution design (SURVEY.md §7.5); the
explicitly overlapped shard_map/ppermute halo pipeline builds on top of it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..compiler.lower import LoweredCycle
from .mesh import grid_sharding, replicated


def _padded_shape(shape: Tuple[int, ...], mesh: Mesh, dimension: int):
    axes = list(mesh.axis_names)[:dimension]
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for k, n in enumerate(shape):
        if k < len(axes):
            m = sizes[axes[k]]
            out.append(-(-n // m) * m)
        else:
            out.append(n)
    return tuple(out)


def pad_fields(fields, mesh: Mesh, dimension: int):
    out = []
    for f in fields:
        target = _padded_shape(f.shape, mesh, dimension)
        pad = [(0, t - n) for t, n in zip(target, f.shape)]
        out.append(jnp.pad(f, pad))
    return tuple(out)


def crop_fields(fields, shapes):
    return tuple(f[tuple(slice(0, n) for n in s)]
                 for f, s in zip(fields, shapes))


def make_sharded_step(lowered: LoweredCycle, mesh: Mesh):
    """jit the cycle step with the finest grid sharded over the mesh.

    Returns ``(step, prepare)`` where ``prepare(fields)`` pads and places
    fields in the sharded layout and ``step(u_pad, b_pad, omegas)`` runs one
    cycle, keeping the padded Dirichlet ring at zero.
    """
    dimension = len(lowered.grids[0].size)
    shapes = [tuple(g.size) for g in lowered.grids]
    gshard = grid_sharding(mesh, dimension)
    rep = replicated(mesh)

    def prepare(fields):
        padded = pad_fields(tuple(jnp.asarray(f) for f in fields),
                            mesh, dimension)
        return tuple(jax.device_put(p, gshard) for p in padded)

    def step_fn(u_pad, b_pad, omegas):
        u = crop_fields(u_pad, shapes)
        b = crop_fields(b_pad, shapes)
        u_new = lowered.step(u, b, omegas)
        return pad_fields(u_new, mesh, dimension)

    n_fields = len(shapes)
    step = jax.jit(
        step_fn,
        in_shardings=((gshard,) * n_fields, (gshard,) * n_fields, rep),
        out_shardings=(gshard,) * n_fields,
    )
    return step, prepare
