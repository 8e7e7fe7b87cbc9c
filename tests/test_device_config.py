"""Device-facing configuration: peak tables by device kind, the model-based
predictor's explicit machine, the compile-cache directory rule, the
precision of the f32 contractions on the device path, and chip_smoke.py's
refusal to run without a GPU."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from evostencils_tpu import config as cfg
from evostencils_tpu.prediction.performance import (
    H100_SXM, PerformanceEvaluator, machine_for_device_kind)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_h100_device_kind_resolves():
    assert machine_for_device_kind("NVIDIA H100 80GB HBM3") is H100_SXM
    assert H100_SXM.bandwidth == 3.35e12 and H100_SXM.peak_flops == 67e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe",
                                  "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(ValueError, match="no machine model"):
        machine_for_device_kind(kind)


def test_performance_evaluator_needs_a_machine():
    with pytest.raises(TypeError):
        PerformanceEvaluator()


def test_cache_dir_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cfg.compilation_cache_dir() == str(tmp_path)
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.__setitem__(name, value))
    cfg.enable_persistent_compilation_cache()
    assert updates["jax_compilation_cache_dir"] == str(tmp_path)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert pathlib.Path(cfg.compilation_cache_dir()) == ROOT / ".jax_cache"


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a (closed) jaxpr, nested
    jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    out.extend(_dot_precisions(
                        inner if hasattr(inner, "eqns") else inner.jaxpr))
    return out


def _contraction(site):
    """(function, f32 argument) exercising one f32 contraction site."""
    x = jnp.ones((15, 15), jnp.float32)
    if site == "dense_coarse_solve":
        from evostencils_tpu.compiler.lower import _Lowering
        inv = np.eye(225)
        return (lambda f: _Lowering(None, None, None)._apply_dense(
            inv, (f,))), x
    if site == "block_smoother":
        from evostencils_tpu.ops.local_solve import get_block_solve_plan
        from evostencils_tpu.stencils import periodic
        from evostencils_tpu.stencils.constant import Stencil
        st = periodic.block_diagonal(periodic.as_periodic(Stencil(
            [((0, 0), 4.0), ((-1, 0), -1.0), ((1, 0), -1.0),
             ((0, -1), -1.0), ((0, 1), -1.0)])), (2, 2))
        plan = get_block_solve_plan([[st]], (2, 2), (15, 15))
        return (lambda f: plan.apply((f,))), x
    from evostencils_tpu.ops.apply import _axis_contract
    mats = [np.eye(15)[::2], np.eye(15)[::2]]
    return (lambda f: _axis_contract(f, mats)), x


@pytest.mark.parametrize("site", ["dense_coarse_solve", "block_smoother",
                                  "axis_transfer"])
def test_f32_contractions_request_highest(site):
    fn, x = _contraction(site)
    precisions = _dot_precisions(jax.make_jaxpr(fn)(x).jaxpr)
    assert precisions, f"no contraction traced at {site}"
    hi = jax.lax.Precision.HIGHEST
    for p in precisions:
        assert p in (hi, (hi, hi)), f"{site}: precision {p}"


def test_chip_smoke_refuses_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "GPU" in proc.stderr
