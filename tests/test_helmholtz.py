"""Helmholtz tests: complex dtype, Robin BC folding, shifted-Laplace MG
preconditioner inside BiCGStab (PERF.md reference targets)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from evostencils_tpu.compiler.cycles import v_cycle
from evostencils_tpu.compiler.lower import lower_cycle, operator_applier
from evostencils_tpu.ir import partitioning as part, smoother
from evostencils_tpu.ops.solvers import preconditioned_bicgstab
from evostencils_tpu.problems.helmholtz import (helmholtz_2d,
                                                HelmholtzOperatorGenerator)
from evostencils_tpu.grids import unit_interval_grid


class TestOperator:
    def test_robin_folding_matches_ghost_elimination(self):
        # the dense field-operator matrix must equal manual elimination of
        # the Robin ghost relation u_b = u_1 / (1 - i k h)
        g = unit_interval_grid(2, 3)
        gen = HelmholtzOperatorGenerator(10.0, 0.0)
        sf = gen.generate_stencil_field(g)
        M = sf.dense_matrix()
        st = gen.generate_stencil(g)
        from evostencils_tpu.ops.apply import dense_matrix
        M0 = dense_matrix(st, g).astype(complex)
        alpha = 1.0 / (1.0 - 1j * 10.0 * g.spacing[0])
        n = g.size[0]
        west, east = st.value_at((-1, 0)), st.value_at((1, 0))
        for j in range(n):
            r0 = np.ravel_multi_index((0, j), g.size)
            M0[r0, r0] += west * alpha
            r1 = np.ravel_multi_index((n - 1, j), g.size)
            M0[r1, r1] += east * alpha
        np.testing.assert_allclose(M, M0, rtol=1e-13)

    def test_apply_complex(self):
        problem = helmholtz_2d(max_level=4, min_level=3, k=10.0)
        mv = operator_applier(problem.outer_solver.operator)
        g = problem.finest_grid[0]
        rng = np.random.default_rng(0)
        u = jnp.asarray(rng.standard_normal(g.size)
                        + 1j * rng.standard_normal(g.size))
        (out,) = mv((u,))
        assert out.dtype == jnp.complex128
        assert np.isfinite(np.asarray(out)).all()


class TestPreconditionedSolve:
    def _solve(self, problem, omega=0.6, pre=2, post=0):
        cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                        pre_smoothing=pre, post_smoothing=post, omega=omega,
                        partitioning=part.RedBlack,
                        coarse_operator=problem.coarsest_operator)
        lowered = lower_cycle(cycle, problem.approximation,
                              problem.rhs_entity)
        b = problem.build_rhs()
        matvec = operator_applier(problem.outer_solver.operator)
        omegas = jnp.asarray(lowered.default_omegas)

        def precond(fields):
            zero = tuple(jnp.zeros_like(f) for f in fields)
            return lowered.step(zero, fields, omegas)

        x, k, hist = preconditioned_bicgstab(
            matvec, precond, b, tol=problem.outer_solver.tolerance,
            maxiter=500, history_size=500)
        return x, int(k), np.asarray(jax.device_get(hist))

    def test_bicgstab_with_mg_preconditioner_converges(self):
        # moderate k at moderate resolution (fast test); reference protocol
        # with k=80 on level 7 runs in the benchmark suite
        problem = helmholtz_2d(max_level=6, min_level=3, k=40.0)
        x, k, hist = self._solve(problem)
        assert k < 200
        assert hist[k] <= problem.outer_solver.tolerance * hist[0] * 1.01

    def test_preconditioner_helps(self):
        problem = helmholtz_2d(max_level=5, min_level=3, k=20.0)
        x, k_prec, _ = self._solve(problem)
        # identity preconditioner
        matvec = operator_applier(problem.outer_solver.operator)
        b = problem.build_rhs()
        x2, k_plain, hist = preconditioned_bicgstab(
            matvec, lambda f: f, b, tol=1e-7, maxiter=2000,
            history_size=0)
        assert k_prec < int(k_plain) / 2

    def test_evaluator_outer_path(self):
        import random
        from evostencils_tpu.grammar import gp
        from evostencils_tpu.grammar.multigrid import generate_primitive_set
        from evostencils_tpu.evaluation.evaluator import CycleEvaluator
        problem = helmholtz_2d(max_level=5, min_level=3, k=20.0)
        pset, _ = generate_primitive_set(
            problem.approximation, problem.rhs_entity,
            problem.level_contexts, problem.coarsest_operator)
        evaluator = CycleEvaluator(problem, max_iterations=300)
        rng = random.Random(5)
        inds = [gp.genGrow(pset, 2, 40, rng=rng) for _ in range(4)]
        results = evaluator.evaluate_population(inds, pset)
        assert len(results) == 4
        finite = [r for r in results if r.iterations < 1e50]
        assert len(finite) >= 1  # some evolved preconditioners work
