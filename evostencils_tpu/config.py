"""Global framework configuration (single typed config layer replacing the
reference's knowledge/settings/platform file rewriting — SURVEY.md §5)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

#: the checkout's own cache directory (listed in .gitignore); a fixed path,
#: because the path is part of the cache key
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compilation_cache_dir() -> str:
    """Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
    when the caller sets it, else the checkout's ``.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_persistent_compilation_cache() -> None:
    """Turn on XLA's persistent compile cache (idempotent).

    Every distinct evolved cycle structure is a distinct XLA program and a
    cold compile costs seconds, so the cache is the main lever on
    evolution-loop latency (SURVEY.md §7 'recompilation pressure').  This
    is the one place that sets the cache; every entry point calls it."""
    import jax
    jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


@dataclass
class Config:
    #: device mesh for the explicit shard_map/ppermute halo-exchange
    #: smoother pipeline (parallel/halo.py); None = single-device / GSPMD
    shard_map_mesh: Optional[object] = None
    #: per-axis grid size below which a level runs replicated instead of
    #: sharded under the halo pipeline
    shard_min_local_size: int = 16
    #: maximum unknowns for dense coarse-grid factorization
    direct_solve_max: int = 4096
    #: lower radius-1 separable transfers as strided-slice banded ops
    #: (ops/apply.axis_restrict_3tap / axis_prolong_3tap) instead of dense
    #: per-axis contractions
    banded_transfers: bool = True
    #: nonlinear coarsest-grid solver sweeps (reference FAS template: 200)
    nonlinear_cgs_sweeps: int = 200
    nonlinear_cgs_omega: float = 0.8


config = Config()
