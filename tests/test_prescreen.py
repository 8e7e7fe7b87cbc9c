"""Small-grid prescreen (optimization/prescreen.py) and the slope-fit
timing protocol (evaluation/evaluator.py round-4 hardening)."""

import random

import numpy as np
import pytest

from evostencils_tpu.problems.poisson import poisson_2d
from evostencils_tpu.grammar import gp
from evostencils_tpu.grammar.multigrid import generate_primitive_set
from evostencils_tpu.evaluation.evaluator import CycleEvaluator
from evostencils_tpu.optimization.prescreen import SmallGridPrescreen
from evostencils_tpu.optimization.program import Optimizer
from evostencils_tpu.compiler.cycles import v_cycle
from evostencils_tpu.ir import partitioning as part
from evostencils_tpu.ir import transformations


def _pset(problem):
    pset, _ = generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)
    return pset


def test_prescreen_verdicts_match_small_grid_truth():
    full = poisson_2d(max_level=7, min_level=3)
    small = poisson_2d(max_level=5, min_level=1)
    pset_full = _pset(full)
    pre = SmallGridPrescreen(small, rho_cap=0.9)
    assert pre.attach(pset_full)

    rng = random.Random(7)
    inds = [gp.genGrow(pset_full, 0, 50, rng=rng) for _ in range(12)]
    verdicts = pre.screen(inds, pset_full)
    assert len(verdicts) == len(inds)
    assert pre.screened == len(inds)
    # ground truth: evaluate the transferred trees on the small problem
    small_inds = [gp.Individual(
        [pre.pset_small.mapping[pre._rename[n.name]] for n in ind])
        for ind in inds]
    results = pre.evaluator.evaluate_population(small_inds, pre.pset_small)
    for v, res in zip(verdicts, results):
        hopeless = (res.iterations >= pre.evaluator.infinity
                    or not np.isfinite(res.convergence_factor)
                    or res.convergence_factor > 0.9)
        assert (v is not None) == hopeless
    # a known-good hand-built cycle must always survive the screen
    assert pre.rejected < len(inds)


def test_prescreen_accepts_reference_cycle_rejects_divergent():
    """The reference V(2,1) must pass; an over-relaxed divergent smoother
    must be rejected."""
    small = poisson_2d(max_level=5, min_level=1)
    pre = SmallGridPrescreen(small, rho_cap=0.9)
    ev = pre.evaluator
    good = v_cycle(small.level_contexts, small.rhs_entity,
                   pre_smoothing=2, post_smoothing=1, omega=1.15,
                   partitioning=part.RedBlack,
                   coarse_operator=small.coarsest_operator)
    transformations.assign_cycle_ids(good)
    res = ev.evaluate_expression(good, key="good")
    assert res.convergence_factor < 0.2

    bad = v_cycle(small.level_contexts, small.rhs_entity,
                  pre_smoothing=1, post_smoothing=0, omega=1.99,
                  partitioning=part.Single,
                  coarse_operator=small.coarsest_operator)
    transformations.assign_cycle_ids(bad)
    res_bad = ev.evaluate_expression(bad, key="bad")
    assert res_bad.iterations >= ev.infinity \
        or res_bad.convergence_factor > 0.9


def test_prescreen_detaches_on_incompatible_pset():
    full = poisson_2d(max_level=7, min_level=3)      # 4 levels
    small = poisson_2d(max_level=4, min_level=1)     # 3 levels: mismatch
    pset_full = _pset(full)
    pre = SmallGridPrescreen(small)
    assert not pre.attach(pset_full)
    rng = random.Random(3)
    inds = [gp.genGrow(pset_full, 0, 50, rng=rng) for _ in range(3)]
    assert pre.screen(inds, pset_full) == [None, None, None]


def test_optimizer_with_prescreen_runs_and_skips_compiles(tmp_path):
    full = poisson_2d(max_level=6, min_level=2)
    small = poisson_2d(max_level=5, min_level=1)
    pre = SmallGridPrescreen(small, rho_cap=0.9)
    evaluator = CycleEvaluator(full)
    opt = Optimizer(full, evaluator=evaluator, rng=random.Random(11),
                    prescreen=pre,
                    checkpoint_directory_path=str(tmp_path))
    result = opt.evolutionary_optimization(
        mu_=4, lambda_=4, population_initialization_factor=2,
        generations=2, verbose=False)
    assert result["best_individual"] is not None
    assert pre.screened > 0
    # every reject saved a full-size compile: the full evaluator compiled
    # strictly fewer structures than individuals were evaluated
    if pre.rejected:
        assert evaluator.compilations < opt.total_evaluations
    vals = result["best_individual"].fitness.values
    assert all(np.isfinite(v) and v < 1e50 for v in vals)


def test_slope_fit_timing_protocol():
    """The slope-fit estimator recovers a synthetic per-solve time under a
    large drifting fixed overhead."""
    rng = np.random.default_rng(0)
    t_solve = 2.1e-3
    for _ in range(20):
        overhead = 30e-3 * (1 + 0.3 * rng.random())
        per_s = {S: [overhead + S * t_solve * (1 + 0.02 * rng.random())
                     for _ in range(3)] for S in (1, 2, 4, 8)}
        est = CycleEvaluator._slope_from_series(per_s)
        assert abs(est - t_solve) / t_solve < 0.1


def test_measure_interleaved_cpu():
    prob = poisson_2d(max_level=5, min_level=1)
    ev = CycleEvaluator(prob)
    a = v_cycle(prob.level_contexts, prob.rhs_entity,
                pre_smoothing=2, post_smoothing=1, omega=1.15,
                partitioning=part.RedBlack,
                coarse_operator=prob.coarsest_operator)
    b = v_cycle(prob.level_contexts, prob.rhs_entity,
                pre_smoothing=1, post_smoothing=1, omega=0.8,
                partitioning=part.Single,
                coarse_operator=prob.coarsest_operator)
    for c in (a, b):
        transformations.assign_cycle_ids(c)
    out = ev.measure_interleaved([("a", a), ("b", b)], reps=2)
    assert len(out) == 2
    for r in out:
        assert np.isfinite(r["ms_per_iter"]) and r["ms_per_iter"] > 0
        lo, hi = r["ms_per_iter_spread"]
        assert lo <= r["ms_per_iter"] <= hi
        assert np.isfinite(r["time_to_convergence_ms"])
