"""Runtime profiling utilities (SURVEY.md §5 tracing/profiling)."""

import numpy as np
import jax.numpy as jnp

from evostencils_tpu.runtime.profiling import (benchmark, compiled_cost,
                                               roofline_report)
from evostencils_tpu.problems.poisson import poisson_2d
from evostencils_tpu.compiler.cycles import v_cycle
from evostencils_tpu.compiler.lower import lower_cycle
from evostencils_tpu.ir import partitioning as part
from evostencils_tpu.prediction.performance import H100_SXM


def _lowered(max_level=6, min_level=4):
    problem = poisson_2d(max_level=max_level, min_level=min_level)
    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=2, post_smoothing=1, omega=1.15,
                    partitioning=part.RedBlack,
                    coarse_operator=problem.coarsest_operator)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    b = problem.build_rhs()
    u0 = tuple(jnp.zeros_like(x) for x in b)
    om = jnp.asarray(lowered.default_omegas)
    return lowered, u0, b, om


def test_compiled_cost_reports_flops():
    lowered, u0, b, om = _lowered()
    cost = compiled_cost(lowered.step, u0, b, om)
    # one V(2,1) cycle on a 63x63 grid does at least ~10 flops/point
    assert cost["flops"] > 10 * 63 * 63
    assert cost["bytes_accessed"] > 0
    assert cost["arithmetic_intensity"] > 0


def test_benchmark_and_roofline():
    lowered, u0, b, om = _lowered()
    t = benchmark(lowered.step, u0, b, om, iterations=3, warmup=1)
    assert t > 0
    rep = roofline_report(lowered, u0, b, om, machine=H100_SXM, iterations=3)
    assert rep.measured_s > 0 and rep.model_s > 0
    assert rep.efficiency > 0
