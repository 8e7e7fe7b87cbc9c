"""Grammar + GP engine + evolutionary optimizer tests."""

import random

import numpy as np
import pytest

from evostencils_tpu.grammar import gp
from evostencils_tpu.grammar.multigrid import generate_primitive_set
from evostencils_tpu.ir import base, transformations
from evostencils_tpu.evaluation.evaluator import CycleEvaluator, structure_key
from evostencils_tpu.optimization.program import Optimizer
from evostencils_tpu.optimization import nsga
from evostencils_tpu.problems.poisson import poisson_2d


def small_problem():
    return poisson_2d(max_level=4, min_level=2)


def build_pset(problem, depth=None, **kwargs):
    return generate_primitive_set(problem.approximation, problem.rhs_entity,
                                  problem.level_contexts,
                                  problem.coarsest_operator, depth=depth,
                                  **kwargs)


class TestGPEngine:
    def test_generate_produces_valid_trees(self):
        problem = small_problem()
        pset, _ = build_pset(problem)
        rng = random.Random(42)
        for _ in range(50):
            ind = gp.genGrow(pset, 0, 50, rng=rng)
            assert len(ind) <= 150
            # tree must compile into a (cycle, rhs) state
            state = gp.compile_tree(ind, pset)
            assert isinstance(state[0], base.Cycle)

    def test_string_roundtrip(self):
        problem = small_problem()
        pset, _ = build_pset(problem)
        rng = random.Random(1)
        for _ in range(20):
            ind = gp.genGrow(pset, 0, 50, rng=rng)
            rebuilt = gp.parse_tree(str(ind), pset)
            assert str(rebuilt) == str(ind)
            assert [n.name for n in rebuilt] == [n.name for n in ind]

    def test_crossover_preserves_typing(self):
        problem = small_problem()
        pset, _ = build_pset(problem)
        rng = random.Random(7)
        for _ in range(30):
            a = gp.genGrow(pset, 2, 30, rng=rng)
            b = gp.genGrow(pset, 2, 30, rng=rng)
            c1, c2 = gp.cxOnePoint(a.clone(), b.clone(), rng=rng)
            gp.compile_tree(c1, pset)
            gp.compile_tree(c2, pset)

    def test_mutation_preserves_typing(self):
        problem = small_problem()
        pset, _ = build_pset(problem)
        rng = random.Random(3)
        for _ in range(30):
            a = gp.genGrow(pset, 2, 30, rng=rng)
            (m1,) = gp.mutNodeReplacement(a.clone(), pset, rng=rng)
            gp.compile_tree(m1, pset)
            (m2,) = gp.mutate_subtree(a.clone(), 0, 10, pset, rng=rng)
            gp.compile_tree(m2, pset)

    def test_structure_key_normalizes_relaxation(self):
        problem = small_problem()
        pset, _ = build_pset(problem)
        rng = random.Random(5)
        ind = gp.genGrow(pset, 2, 30, rng=rng)
        mutated = ind.clone()
        # replace every rf terminal by rf_0
        for i, node in enumerate(mutated):
            if node.name.startswith("rf_"):
                mutated[i] = pset.mapping["rf_0"]
        assert structure_key(ind) == structure_key(mutated)


class TestNSGA:
    def _pop(self, values):
        from evostencils_tpu.grammar.gp import Node
        from evostencils_tpu.grammar.typing import Type
        pop = []
        for i, v in enumerate(values):
            ind = gp.Individual([Node(f"t{i}", 0, Type("T"))])
            ind.fitness.values = v
            pop.append(ind)
        return pop

    def test_nondominated_sort(self):
        pop = self._pop([(1, 5), (2, 4), (3, 3), (2, 2), (5, 1), (4, 4)])
        fronts = nsga.sort_nondominated(pop)
        first = {ind.fitness.values for ind in fronts[0]}
        assert first == {(1, 5), (2, 2), (5, 1)}

    def test_selNSGA2_size_and_elites(self):
        pop = self._pop([(1, 5), (2, 4), (3, 3), (2, 2), (5, 1), (4, 4)])
        sel = nsga.selNSGA2(pop, 3)
        assert len(sel) == 3
        assert {ind.fitness.values for ind in sel} == {(1, 5), (2, 2), (5, 1)}

    def test_pareto_front_archive(self):
        pop = self._pop([(1, 5), (2, 2), (5, 1), (3, 3)])
        pf = nsga.ParetoFront()
        pf.update(pop)
        assert {ind.fitness.values for ind in pf} == {(1, 5), (2, 2), (5, 1)}

    def test_nsga3_normalization_hyperplane(self):
        """Deb & Jain 2014 normalization: ideal point + extreme-point
        hyperplane intercepts, not min/max scaling."""
        F = np.array([[1.0, 5.0], [5.0, 1.0], [3.0, 3.0]])
        Fn = nsga._nsga3_normalize(F)
        # ideal (1,1); extremes (4,0) and (0,4) -> intercepts (4,4)
        np.testing.assert_allclose(
            Fn, [[0.0, 1.0], [1.0, 0.0], [0.5, 0.5]], atol=1e-9)

    def test_nsga3_normalization_degenerate_falls_back(self):
        # all points share one objective value -> singular hyperplane;
        # must fall back to nadir scaling without blowing up
        F = np.array([[1.0, 2.0], [3.0, 2.0], [2.0, 2.0]])
        Fn = nsga._nsga3_normalize(F)
        assert np.all(np.isfinite(Fn))
        np.testing.assert_allclose(Fn[:, 0], [0.0, 1.0, 0.5], atol=1e-9)

    def test_selNSGA3_niching_on_known_front(self):
        """On a front lying exactly on the reference directions, niching
        must keep the spread representatives and drop the cluster
        duplicates."""
        spread = [(0.0, 4.0), (1.0, 3.0), (2.0, 2.0), (3.0, 1.0), (4.0, 0.0)]
        clones = [(2.05, 1.95), (1.05, 2.95), (3.05, 0.95)]
        pop = self._pop(spread + clones)
        ref = nsga.uniform_reference_points(2, 4)
        sel = nsga.selNSGA3(pop, 5, ref, rng=random.Random(0))
        assert len(sel) == 5
        assert {ind.fitness.values for ind in sel} == set(spread)


class TestEvaluator:
    def test_handbuilt_cycle_evaluates(self):
        problem = small_problem()
        pset, _ = build_pset(problem)
        evaluator = CycleEvaluator(problem)
        rng = random.Random(11)
        # find a tree that converges
        results = []
        inds = [gp.genGrow(pset, 2, 40, rng=rng) for _ in range(8)]
        out = evaluator.evaluate_population(inds, pset)
        assert len(out) == len(inds)
        finite = [r for r in out if r.iterations < 1e50]
        # at least some random cycles should converge on this small problem
        assert evaluator.compilations <= len(inds)

    def test_batched_equals_single(self):
        problem = small_problem()
        pset, _ = build_pset(problem)
        evaluator = CycleEvaluator(problem)
        rng = random.Random(13)
        ind = gp.genGrow(pset, 2, 40, rng=rng)
        batch = evaluator.evaluate_population([ind], pset)[0]
        state = gp.compile_tree(ind, pset)
        transformations.assign_cycle_ids(state[0])
        single = evaluator.evaluate_expression(state[0], key="test_single")
        assert batch.iterations == single.iterations
        if batch.iterations < 1e50:
            # vmap reorders reductions -> tiny float differences
            assert batch.convergence_factor == pytest.approx(
                single.convergence_factor, rel=1e-3)


class TestEvolution:
    def test_small_sogp_run_improves(self, tmp_path):
        problem = poisson_2d(max_level=3, min_level=2)
        opt = Optimizer(problem, rng=random.Random(0),
                        checkpoint_directory_path=str(tmp_path))
        pset, _ = build_pset(problem)
        pop, log, hof, _, _ = opt.SOGP(
            pset=pset, initial_population_size=8, generations=3, mu_=4,
            lambda_=4, min_level=2, max_level=3, verbose=False)
        assert len(hof) > 0
        best = hof[0]
        assert best.fitness.values[0] < opt.infinity

    def test_small_nsga2_run(self, tmp_path):
        problem = poisson_2d(max_level=3, min_level=2)
        opt = Optimizer(problem, rng=random.Random(1),
                        checkpoint_directory_path=str(tmp_path))
        pset, _ = build_pset(problem)
        pop, log, hof, _, _ = opt.NSGAII(
            pset=pset, initial_population_size=8, generations=3, mu_=4,
            lambda_=4, min_level=2, max_level=3, verbose=False)
        assert len(pop) == 4
        assert len(hof) >= 1

    def test_evolutionary_optimization_end_to_end(self, tmp_path):
        problem = small_problem()
        opt = Optimizer(problem, rng=random.Random(2),
                        checkpoint_directory_path=str(tmp_path))
        result = opt.evolutionary_optimization(
            mu_=4, lambda_=4, population_initialization_factor=2,
            generations=2, verbose=False)
        assert isinstance(result["best_expression"], base.Cycle)
        # the stored grammar string must re-evaluate to the same behavior
        expr, res = opt.generate_and_evaluate_program_from_grammar_representation(
            result["grammar_string"])
        assert res.convergence_factor < opt.infinity

    def test_checkpoint_roundtrip(self, tmp_path):
        import os
        from evostencils_tpu.optimization.program import (
            load_checkpoint_from_file)
        problem = small_problem()
        path = str(tmp_path)
        opt = Optimizer(problem, rng=random.Random(3),
                        checkpoint_directory_path=path)
        pset, _ = build_pset(problem)
        opt.SOGP(pset=pset, initial_population_size=4, generations=2, mu_=4,
                 lambda_=4, min_level=2, max_level=4, verbose=False)
        cp = load_checkpoint_from_file(os.path.join(path, "checkpoint.p"))
        assert cp.generation == 2
        assert len(cp.population) == 4
        # restored individuals are usable
        for ind in cp.population:
            gp.compile_tree(ind, pset)
