"""LFA convergence-prediction tests: analytic symbols and predicted-vs-
measured convergence factors (SURVEY.md §4: validate against measured rho)."""

import numpy as np
import pytest

from evostencils_tpu.compiler.cycles import v_cycle, smooth
from evostencils_tpu.compiler.lower import lower_cycle
from evostencils_tpu.compiler.solve import measure_solve
from evostencils_tpu.ir import base, partitioning as part, smoother
from evostencils_tpu.prediction.convergence import ConvergenceEvaluator
from evostencils_tpu.prediction.performance import (PerformanceEvaluator,
                                                    REFERENCE_CPU, H100_SXM)
from evostencils_tpu.problems.poisson import poisson_2d, poisson_3d


def build_cycle(problem, *, pre=1, post=1, omega=0.8,
                partitioning=part.Single,
                smoother_factory=smoother.generate_collective_jacobi):
    return v_cycle(problem.level_contexts, problem.rhs_entity,
                   pre_smoothing=pre, post_smoothing=post, omega=omega,
                   partitioning=partitioning,
                   smoother_factory=smoother_factory,
                   coarse_operator=problem.coarsest_operator)


def measured_rho(problem, cycle, max_iterations=50):
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    res = measure_solve(lowered, problem.build_rhs(),
                        max_iterations=max_iterations,
                        target_reduction=1e-10, samples=1)
    return res.convergence_factor


class TestSmootherSymbol:
    def test_jacobi_symbol_matches_analytic(self):
        # single-level smoother: E(theta) = 1 - omega*(2-cos tx - cos ty)/2
        problem = poisson_2d(max_level=5, min_level=4)
        ctx_omega = 0.8
        u, f = problem.approximation, problem.rhs_entity
        level = problem.level_contexts[0]
        state = smooth((u, f), level, ctx_omega, part.Single)
        cycle = state[0]
        ev = ConvergenceEvaluator(2, samples_per_axis=16)
        E = ev.symbol(cycle)
        assert E.shape[1] == 1  # single level -> scalar symbol per theta
        # analytic
        max_level = problem.max_level
        ctx_thetas = None
        from evostencils_tpu.prediction.convergence import _LfaContext
        from evostencils_tpu.prediction.lfa_backend import NumpyLfaBackend
        ctx = _LfaContext(2, max_level, max_level, 16, NumpyLfaBackend)
        analytic = 1 - ctx_omega * (
            4 - 2 * np.cos(ctx.thetas[:, 0]) - 2 * np.cos(ctx.thetas[:, 1])) / 4
        np.testing.assert_allclose(E[:, 0, 0].real, analytic, rtol=1e-12)
        np.testing.assert_allclose(E[:, 0, 0].imag, 0, atol=1e-12)


class TestTwoGridPrediction:
    def test_jacobi_v11_two_grid(self):
        problem = poisson_2d(max_level=6, min_level=5)
        cycle = build_cycle(problem, omega=0.8)
        ev = ConvergenceEvaluator(2, samples_per_axis=16)
        rho_lfa = ev.compute_spectral_radius(cycle)
        rho_meas = measured_rho(problem, cycle)
        # textbook two-grid Jacobi(0.8) V(1,1) on 2D Poisson: rho ~ 0.32
        assert 0.2 < rho_lfa < 0.45
        assert abs(rho_lfa - rho_meas) < 0.12

    def test_rbgs_v21_two_grid(self):
        problem = poisson_2d(max_level=6, min_level=5)
        cycle = build_cycle(problem, pre=2, post=1, omega=1.0,
                            partitioning=part.RedBlack)
        ev = ConvergenceEvaluator(2, samples_per_axis=16)
        rho_lfa = ev.compute_spectral_radius(cycle)
        rho_meas = measured_rho(problem, cycle)
        # textbook RB-GS V(2,1): rho well below 0.1
        assert rho_lfa < 0.12
        assert abs(rho_lfa - rho_meas) < 0.06

    def test_prediction_ranks_smoothers(self):
        # LFA must rank omega choices like measurement does
        problem = poisson_2d(max_level=6, min_level=5)
        ev = ConvergenceEvaluator(2, samples_per_axis=12)
        rhos = {}
        for omega in (0.5, 0.8, 1.4):
            cycle = build_cycle(problem, omega=omega)
            rhos[omega] = ev.compute_spectral_radius(cycle)
        assert rhos[0.8] < rhos[0.5]
        assert rhos[0.8] < rhos[1.4]

    def test_three_grid_prediction(self):
        problem = poisson_2d(max_level=7, min_level=5)
        cycle = build_cycle(problem, pre=2, post=1, omega=1.15,
                            partitioning=part.RedBlack)
        ev = ConvergenceEvaluator(2, samples_per_axis=8)
        rho_lfa = ev.compute_spectral_radius(cycle)
        rho_meas = measured_rho(problem, cycle)
        assert rho_lfa < 0.15
        assert abs(rho_lfa - rho_meas) < 0.08

    def test_3d_two_grid(self):
        problem = poisson_3d(max_level=4, min_level=3)
        cycle = build_cycle(problem, pre=2, post=1, omega=1.15,
                            partitioning=part.RedBlack)
        ev = ConvergenceEvaluator(3, samples_per_axis=8)
        rho_lfa = ev.compute_spectral_radius(cycle)
        assert 0.0 < rho_lfa < 0.2


class TestPerformanceModel:
    def test_runtime_positive_and_scales(self):
        small = poisson_2d(max_level=5, min_level=3)
        big = poisson_2d(max_level=7, min_level=3)
        pe = PerformanceEvaluator(REFERENCE_CPU)
        cyc_s = build_cycle(small)
        cyc_b = build_cycle(big)
        t_s = pe.estimate_runtime(cyc_s)
        t_b = pe.estimate_runtime(cyc_b)
        assert t_s > 0
        assert t_b > 10 * t_s  # 16x the points

    def test_h100_faster_than_reference_cpu(self):
        problem = poisson_2d(max_level=7, min_level=3)
        cycle = build_cycle(problem)
        t_cpu = PerformanceEvaluator(REFERENCE_CPU).estimate_runtime(cycle)
        t_gpu = PerformanceEvaluator(H100_SXM).estimate_runtime(cycle)
        assert t_gpu < t_cpu / 10


class TestModelBasedFitness:
    def test_estimate_objectives_on_random_trees(self):
        import random
        from evostencils_tpu.grammar import gp
        from evostencils_tpu.grammar.multigrid import generate_primitive_set
        from evostencils_tpu.ir import transformations
        problem = poisson_2d(max_level=5, min_level=3)
        pset, _ = generate_primitive_set(
            problem.approximation, problem.rhs_entity,
            problem.level_contexts, problem.coarsest_operator)
        ev = ConvergenceEvaluator(2, samples_per_axis=4)
        rng = random.Random(17)
        n_ok = 0
        for _ in range(10):
            ind = gp.genGrow(pset, 2, 40, rng=rng)
            state = gp.compile_tree(ind, pset)
            rho = ev.compute_spectral_radius(state[0])
            assert np.isfinite(rho)
            if 0 < rho < 1:
                n_ok += 1
        assert n_ok >= 3  # a decent share of random cycles converge


class TestModelBasedOptimizer:
    def test_model_based_evolution_runs(self, tmp_path):
        import random
        from evostencils_tpu.optimization.program import Optimizer
        from evostencils_tpu.grammar.multigrid import generate_primitive_set
        problem = poisson_2d(max_level=5, min_level=3)
        opt = Optimizer(problem, model_based_estimation=True,
                        rng=random.Random(0),
                        checkpoint_directory_path=str(tmp_path))
        pset, _ = generate_primitive_set(
            problem.approximation, problem.rhs_entity,
            problem.level_contexts, problem.coarsest_operator)
        pop, log, hof, _, _ = opt.NSGAII(
            pset=pset, initial_population_size=8, generations=2, mu_=4,
            lambda_=4, min_level=3, max_level=5, verbose=False)
        assert len(hof) >= 1
        # at least one individual has a finite predicted (rho, runtime)
        best = min(hof, key=lambda i: i.fitness.values)
        assert best.fitness.values[0] < 1e50
