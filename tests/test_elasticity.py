"""Linear elasticity block-system tests (SURVEY §2.1 system IR + coupled
smoothers; PERF.md reference targets: RB-GS omega=1.25 V(2,1) to
1e-12)."""

import numpy as np
import pytest

from evostencils_tpu.compiler.cycles import v_cycle
from evostencils_tpu.compiler.lower import lower_cycle
from evostencils_tpu.compiler.solve import measure_solve
from evostencils_tpu.ir import partitioning as part, smoother
from evostencils_tpu.prediction.convergence import ConvergenceEvaluator
from evostencils_tpu.problems.elasticity import linear_elasticity_2d


def solve_elasticity(problem, *, pre=2, post=1, omega=1.25,
                     partitioning=part.RedBlack,
                     smoother_factory=smoother.generate_collective_jacobi):
    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=pre, post_smoothing=post, omega=omega,
                    partitioning=partitioning,
                    smoother_factory=smoother_factory,
                    coarse_operator=problem.coarsest_operator)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    return cycle, measure_solve(lowered, problem.build_rhs(),
                                max_iterations=problem.max_iterations,
                                target_reduction=problem.target_reduction,
                                samples=1)


class TestElasticity:
    def test_reference_solver_converges(self):
        problem = linear_elasticity_2d(max_level=6, min_level=4)
        cycle, result = solve_elasticity(problem)
        assert result.converged
        assert result.iterations <= 30
        assert result.convergence_factor < 0.45

    def test_decoupled_vs_collective(self):
        # collective point smoothing must beat decoupled on the coupled system
        problem = linear_elasticity_2d(max_level=5, min_level=4)
        _, res_col = solve_elasticity(
            problem, smoother_factory=smoother.generate_collective_jacobi)
        problem2 = linear_elasticity_2d(max_level=5, min_level=4)
        _, res_dec = solve_elasticity(
            problem2, smoother_factory=smoother.generate_decoupled_jacobi)
        assert res_col.converged
        # decoupled may or may not converge; if it does, it is no better
        if res_dec.converged:
            assert res_col.convergence_factor <= \
                res_dec.convergence_factor + 0.05

    def test_lfa_prediction_matches_measurement(self):
        problem = linear_elasticity_2d(max_level=6, min_level=5)
        cycle, result = solve_elasticity(problem)
        ev = ConvergenceEvaluator(2, samples_per_axis=8)
        rho_lfa = ev.compute_spectral_radius(cycle)
        assert 0 < rho_lfa < 1
        assert abs(rho_lfa - result.convergence_factor) < 0.15

    def test_block_smoother_on_system(self):
        problem = linear_elasticity_2d(max_level=5, min_level=4)

        def factory(op):
            return smoother.generate_collective_block_jacobi(op,
                                                             [(2, 1), (2, 1)])

        _, result = solve_elasticity(problem, omega=0.9,
                                     partitioning=part.Single,
                                     smoother_factory=factory)
        assert result.converged

    def test_grammar_evolution_on_system(self):
        import random
        from evostencils_tpu.grammar import gp
        from evostencils_tpu.grammar.multigrid import generate_primitive_set
        from evostencils_tpu.evaluation.evaluator import CycleEvaluator
        problem = linear_elasticity_2d(max_level=5, min_level=4)
        pset, _ = generate_primitive_set(
            problem.approximation, problem.rhs_entity,
            problem.level_contexts, problem.coarsest_operator,
            maximum_local_system_size=8)
        rng = random.Random(3)
        inds = [gp.genGrow(pset, 2, 40, rng=rng) for _ in range(6)]
        evaluator = CycleEvaluator(problem)
        results = evaluator.evaluate_population(inds, pset)
        assert len(results) == 6
        # decoupled_jacobi must appear as a production for systems
        names = {n.name for n in pset.mapping.values()}
        assert any(n.startswith("decoupled_jacobi") for n in names)
