"""Classification of constant stencils into fixed coefficient tuples.

The shard_map halo pipeline (parallel/halo.py) and the smoother-part
extractors of the cycle compiler (compiler/lower.py) take star and 3x3-box
operators as plain coefficient tuples in a fixed offset order.  These
helpers turn a ``stencils.constant.Stencil`` (or a variable-coefficient
``StencilField``) into that form, or return None when the stencil has any
other shape.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

#: offsets of a 5-point star, matching the value order of
#: ``five_point_values`` and ``complex_five_point_values``
FIVE_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))

#: offsets of a 7-point star, matching the value order of
#: ``seven_point_values``
SEVEN_OFFSETS = ((0, 0, 0), (-1, 0, 0), (1, 0, 0),
                 (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))

#: offset order of the 3x3-box coefficient tuples (``nine_point_coeffs``)
NINE_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
                (-1, -1), (-1, 1), (1, -1), (1, 1))


def _real_values(stencil, offsets) -> Optional[Tuple[float, ...]]:
    entries = dict(stencil.entries)
    if set(entries) - set(offsets):
        return None
    if any(isinstance(v, complex) for v in entries.values()):
        return None
    return tuple(float(entries.get(o, 0.0)) for o in offsets)


def five_point_values(stencil) -> Optional[Tuple[float, ...]]:
    """Coefficients of a real constant 5-point 2D stencil in FIVE_OFFSETS
    order, or None if the stencil has any other shape."""
    return _real_values(stencil, FIVE_OFFSETS)


def seven_point_values(stencil) -> Optional[Tuple[float, ...]]:
    """Coefficients of a real constant 7-point 3D stencil in SEVEN_OFFSETS
    order, or None for any other shape."""
    return _real_values(stencil, SEVEN_OFFSETS)


def nine_point_coeffs(stencil) -> Optional[Tuple[float, ...]]:
    """Coefficients of a real constant 2D stencil in NINE_OFFSETS order, or
    None if it reaches outside the 3x3 box or is complex."""
    return _real_values(stencil, NINE_OFFSETS)


def complex_five_point_values(stencil) -> Optional[Tuple[complex, ...]]:
    """Coefficients of a constant 5-point 2D stencil with at least one
    complex entry, in FIVE_OFFSETS order as python complex; None
    otherwise."""
    entries = dict(stencil.entries)
    if set(entries) - set(FIVE_OFFSETS):
        return None
    if not any(isinstance(v, complex) for v in entries.values()):
        return None
    return tuple(complex(entries.get(o, 0.0)) for o in FIVE_OFFSETS)


def five_point_stack(sf, dtype) -> Optional[jnp.ndarray]:
    """Stack a 2D 5-point ``StencilField`` into a (5, n, m) array in
    FIVE_OFFSETS order, or None if the field has any other shape
    (different offsets, complex coefficients, non-2D)."""
    offsets = tuple(sf.offsets)
    if set(offsets) - set(FIVE_OFFSETS) or len(offsets[0]) != 2:
        return None
    by_offset = {tuple(o): np.asarray(f) for o, f in zip(sf.offsets, sf.fields)}
    if any(np.iscomplexobj(f) for f in by_offset.values()):
        return None
    if (0, 0) not in by_offset:
        return None
    shape = by_offset[(0, 0)].shape
    planes = [by_offset.get(o, np.zeros(shape)) for o in FIVE_OFFSETS]
    return jnp.asarray(np.stack(planes), dtype=dtype)
