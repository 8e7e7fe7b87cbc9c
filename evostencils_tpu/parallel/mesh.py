"""Device-mesh utilities: spatial grid sharding + population sharding.

Replacement for both MPI tiers of the reference
(SURVEY.md §5 'Distributed communication backend'):
* solver-level domain decomposition (ExaStencils blocks/fragments with
  ghost-layer `communicate`) becomes XLA GSPMD sharding of the grid axes —
  the partitioner inserts halo exchanges (collective-permute) for
  the shifted-slice stencil reads automatically;
* optimizer-level population parallelism (mpi4py allgather) becomes a
  batched leading axis sharded over the mesh.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices=None, mesh_shape: Optional[Tuple[int, ...]] = None,
              axis_names: Optional[Tuple[str, ...]] = None) -> Mesh:
    """Build a mesh over the given devices.

    Default: factor the device count into a near-square 2D mesh
    ('x', 'y') for 2D spatial sharding.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if mesh_shape is None:
        a = int(math.sqrt(n))
        while n % a:
            a -= 1
        mesh_shape = (n // a, a)
    if axis_names is None:
        axis_names = tuple(f"ax{i}" for i in range(len(mesh_shape)))
        if len(mesh_shape) == 2:
            axis_names = ("x", "y")
    arr = np.array(devices).reshape(mesh_shape)
    return Mesh(arr, axis_names)


def grid_sharding(mesh: Mesh, dimension: int) -> NamedSharding:
    """Shard the leading grid axes over the mesh axes (spatial DD)."""
    names = list(mesh.axis_names)[:dimension]
    spec = P(*names, *([None] * max(0, dimension - len(names))))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def population_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a leading population/batch axis over the whole mesh."""
    spec = P(tuple(mesh.axis_names))
    return NamedSharding(mesh, spec)


def shard_fields(fields, sharding: NamedSharding):
    return tuple(jax.device_put(f, sharding) for f in fields)
