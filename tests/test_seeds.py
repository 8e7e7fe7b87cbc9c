"""Seed individuals (grammar/seeds.py): the emitted V-cycle grammar
strings parse against the problem grammar and reproduce the
reference-config solver physics."""

import numpy as np
import jax

from evostencils_tpu.problems.poisson import poisson_2d
from evostencils_tpu.grammar.multigrid import generate_primitive_set
from evostencils_tpu.grammar import gp
from evostencils_tpu.grammar.seeds import v_cycle_string, _rf_index
from evostencils_tpu.ir import transformations
from evostencils_tpu.evaluation.evaluator import CycleEvaluator


def test_rf_index():
    assert _rf_index(0.1) == 0
    assert _rf_index(1.9) == 36
    assert abs(0.1 + _rf_index(1.15) * 0.05 - 1.15) < 1e-9
    assert abs(0.1 + _rf_index(0.6) * 0.05 - 0.6) < 1e-9


def test_poisson_seed_matches_reference_solver():
    p = poisson_2d(max_level=7, min_level=3)
    p.dtype = np.float64
    pset, _ = generate_primitive_set(
        p.approximation, p.rhs_entity, p.level_contexts,
        p.coarsest_operator)
    s = v_cycle_string(4, 7, smoother="collective_jacobi", omega=1.15)
    ind = gp.parse_tree(s, pset)
    expr = gp.compile_tree(ind, pset)[0]
    transformations.assign_cycle_ids(expr)
    ev = CycleEvaluator(p, dtype=np.float64)
    res = ev.evaluate_expression(expr, key="seed")
    # the reference solver block: V(2,1) RB 1.15 -> textbook rho ~ 0.02
    assert res.convergence_factor < 0.05
    assert np.isfinite(res.time_to_convergence_ms)


def test_seeded_evolution_starts_from_seed(tmp_path):
    import random
    from evostencils_tpu.optimization.program import Optimizer
    p = poisson_2d(max_level=6, min_level=2)
    opt = Optimizer(p, rng=random.Random(3),
                    checkpoint_directory_path=str(tmp_path))
    seed = v_cycle_string(4, 6, smoother="collective_jacobi", omega=1.15)
    out = opt.evolutionary_optimization(
        mu_=4, lambda_=4, population_initialization_factor=1,
        generations=1, initial_individuals=[seed], verbose=False)
    # the seed (textbook rho) must survive selection into the population
    best = min(out["populations"][0],
               key=lambda i: i.fitness.values[0])
    assert best.fitness.values[0] < 0.05
