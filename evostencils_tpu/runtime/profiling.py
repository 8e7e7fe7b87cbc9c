"""Tracing / profiling utilities (SURVEY.md §5 'Tracing / profiling').

The reference instruments its generated solvers with ExaSlang
startTimer/stopTimer blocks and profiles the compiler with timeStrategies
(Helmholtz .exa4:4-18, Poisson .settings:20); its model-based path uses a
roofline as a stand-in for measurement (performance.py:36-48).  The
equivalents here:

* :func:`trace` — jax.profiler trace context (view in TensorBoard/xprof);
* :func:`compiled_cost` — XLA's own FLOP/byte estimates from the compiled
  executable;
* :func:`benchmark` — compile-excluded wall-time of a jitted callable;
* :func:`time_cycle_loop` — seconds per cycle of a chained cycle loop;
* :func:`roofline_report` — measured time vs the machine-model
  speed-of-light for a lowered cycle (per-kernel roofline);
* :func:`require_gpu` and :func:`card_description` — the device a
  measurement runs on, which must be a GPU.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass
from typing import Callable

import jax

from ..prediction.performance import MachineModel, PerformanceEvaluator


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace of the enclosed block (device + host timelines)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def compiled_cost(fn: Callable, *args) -> dict:
    """XLA cost analysis of the compiled executable: flops, bytes accessed,
    and derived arithmetic intensity."""
    compiled = jax.jit(fn).lower(*args).compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):   # some backends wrap it in a list
        cost = cost[0] if cost else {}
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    return {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": flops / bytes_accessed
        if bytes_accessed else float("inf"),
    }


def benchmark(fn: Callable, *args, iterations: int = 10,
              warmup: int = 2) -> float:
    """Mean wall time per call (seconds) of a jitted callable, compile
    excluded.  All ``iterations`` calls are enqueued back-to-back and one
    ``jax.block_until_ready`` closes the timed window, so per-call dispatch
    latency is amortized (the per-call figure is an average, not a
    median)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iterations):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iterations


def time_cycle_loop(lowered, b, omegas, *, n_cycles: int, reps: int = 3):
    """Time ``n_cycles`` chained cycles of ``lowered`` compiled as one
    program (compiler.solve.make_cycle_loop), starting from zero.

    Each repetition continues from the previous one's state, so no call
    repeats another's arguments.  Returns ``(seconds per cycle (best
    repetition), seconds of the first call (compile + one run), final
    state)``."""
    import jax.numpy as jnp
    from ..compiler.solve import make_cycle_loop
    loop = make_cycle_loop(lowered, n_cycles)
    u = tuple(jnp.zeros_like(x) for x in b)
    t0 = time.perf_counter()
    u = jax.block_until_ready(loop(u, b, omegas))
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        u = jax.block_until_ready(loop(u, b, omegas))
        times.append(time.perf_counter() - t0)
    return min(times) / n_cycles, first_s, u


def require_gpu():
    """JAX's first device, which must be a GPU: a measurement that finds
    no GPU fails instead of timing another device."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is "
                           f"{device.platform} ({device.device_kind})")
    return device


def card_description() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them; a card set below its maximum power runs slower."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


@dataclass
class RooflineReport:
    measured_s: float
    model_s: float          # machine-model speed-of-light for the cycle
    efficiency: float       # model / measured (1.0 == at the roofline)
    machine: str


def roofline_report(lowered, u, b, omegas, *,
                    machine: MachineModel,
                    expression=None, iterations: int = 10) -> RooflineReport:
    """Measured cycle time vs the analytic roofline of its expression on
    ``machine`` (for a device, ``prediction.performance.
    machine_for_device_kind(device.device_kind)``).

    ``lowered`` is a compiler.lower.LoweredCycle; ``expression`` defaults
    to the cycle it was lowered from.
    """
    expr = expression if expression is not None else lowered.expression
    model_s = PerformanceEvaluator(machine).estimate_runtime(expr)
    step = jax.jit(lowered.step)
    measured = benchmark(step, u, b, omegas, iterations=iterations)
    return RooflineReport(measured, model_s,
                          model_s / measured if measured else 0.0,
                          machine.name)
