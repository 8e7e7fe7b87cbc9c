"""df64 arithmetic + double-float iterative refinement.

Validates the deep-convergence path (compiler/refine.py): the f32
multigrid cycle plus df64 residual/solution words must reach the
reference's 1e-12 (linear) / 1e-10 (FAS) relative-residual targets with
f32-only device arithmetic — here exercised on CPU with f32 arrays, the
dtype mix the device runs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from evostencils_tpu.compiler.lower import lower_cycle
from evostencils_tpu.compiler.cycles import v_cycle, fas_v_cycle
from evostencils_tpu.compiler.refine import (
    make_refined_solver, apply_constant_df, _df_coefficients)
from evostencils_tpu.ir import partitioning as part
from evostencils_tpu.ops import df64
from evostencils_tpu.problems.poisson import poisson_2d
from evostencils_tpu.problems.fas import fas_2d_basic


class TestDF64:
    def test_two_sum_exact(self):
        rng = np.random.default_rng(0)
        a = jnp.asarray(rng.standard_normal(1000), dtype=jnp.float32)
        b = jnp.asarray(rng.standard_normal(1000) * 1e-5, dtype=jnp.float32)
        s, e = df64.two_sum(a, b)
        exact = a.astype(np.float64) + b.astype(np.float64)
        np.testing.assert_array_equal(
            np.asarray(s, dtype=np.float64) + np.asarray(e, dtype=np.float64),
            exact)

    def test_two_prod_exact(self):
        rng = np.random.default_rng(1)
        a = jnp.asarray(rng.standard_normal(1000), dtype=jnp.float32)
        b = jnp.asarray(rng.standard_normal(1000), dtype=jnp.float32)
        p, e = df64.two_prod(a, b)
        exact = a.astype(np.float64) * b.astype(np.float64)
        np.testing.assert_array_equal(
            np.asarray(p, dtype=np.float64) + np.asarray(e, dtype=np.float64),
            exact)

    def test_df_exp_accuracy(self):
        rng = np.random.default_rng(4)
        x = rng.uniform(-5, 5, 2000)
        xh = x.astype(np.float32)
        xl = (x - xh.astype(np.float64)).astype(np.float32)
        eh, el = df64.df_exp((jnp.asarray(xh), jnp.asarray(xl)))
        got = np.asarray(eh, np.float64) + np.asarray(el, np.float64)
        want = np.exp(x)
        rel = np.abs(got - want) / want
        assert rel.max() < 1e-13      # far below f32 exp's ~6e-8

    def test_df_add_precision(self):
        # accumulate 10^4 values of wildly different magnitude: plain f32
        # loses ~1e-3 relative, df64 stays at ~1e-12
        rng = np.random.default_rng(2)
        vals = rng.standard_normal(10000) * np.logspace(-6, 6, 10000)
        acc = df64.df_from(jnp.float32(0.0))
        for chunk in vals.reshape(100, 100).sum(axis=1):  # pre-reduce in f64
            acc = df64.df_add(acc, df64.df_from(jnp.float32(chunk)))
        got = float(acc[0]) + float(acc[1])
        want = float(np.sum(vals.reshape(100, 100).sum(axis=1)
                            .astype(np.float32).astype(np.float64)))
        assert abs(got - want) <= 1e-8 * abs(want)


class TestDFStencil:
    def test_apply_matches_f64_dense(self):
        problem = poisson_2d(max_level=5, min_level=3)
        st = problem.level_contexts[0].operator.entries[0][0] \
            .generate_stencil()
        rng = np.random.default_rng(3)
        n = problem.finest_grid[0].size
        u64 = rng.standard_normal(n)
        uh = u64.astype(np.float32)
        ul = (u64 - uh.astype(np.float64)).astype(np.float32)
        out = apply_constant_df(_df_coefficients(st), st.max_offsets,
                                (jnp.asarray(uh), jnp.asarray(ul)),
                                tuple(n))
        got = np.asarray(out[0], dtype=np.float64) + \
            np.asarray(out[1], dtype=np.float64)
        # f64 reference application
        want = np.zeros(n)
        up = np.pad(u64, [(r, r) for r in st.max_offsets])
        for offset, value in st.entries:
            idx = tuple(slice(r + o, r + o + m)
                        for r, o, m in zip(st.max_offsets, offset, n))
            want += float(value) * up[idx]
        np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


class TestRefinedSolve:
    def test_poisson_to_1e12_with_f32_cycles(self):
        problem = poisson_2d(max_level=6, min_level=3)
        problem.dtype = np.float32
        cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                        pre_smoothing=2, post_smoothing=1, omega=1.15,
                        partitioning=part.RedBlack,
                        coarse_operator=problem.coarsest_operator)
        lowered = lower_cycle(cycle, problem.approximation,
                              problem.rhs_entity)
        solve = make_refined_solver(lowered, inner_cycles=10,
                                    target_reduction=1e-12)
        b = jnp.asarray(problem.build_rhs()[0], dtype=jnp.float32)
        res = solve(b)
        assert res.converged
        assert res.residuals[-1] <= 1e-12 * res.residuals[0]
        # the df64 solution matches the f64 ground truth far below f32
        import scipy.sparse  # noqa: F401  (absent: fall back to dense)
        # ground truth via f64 numpy solve of the same 5-point system
        from evostencils_tpu.ops.apply import dense_matrix
        from evostencils_tpu.stencils import periodic
        st = problem.level_contexts[0].operator.entries[0][0] \
            .generate_stencil()
        A = dense_matrix(periodic.as_periodic(st), problem.finest_grid[0])
        u_star = np.linalg.solve(A, np.asarray(b, np.float64).reshape(-1))
        got = np.asarray(res.solution_hi, np.float64).reshape(-1) + \
            np.asarray(res.solution_lo, np.float64).reshape(-1)
        rel = np.linalg.norm(got - u_star) / np.linalg.norm(u_star)
        assert rel < 1e-10

    def test_poisson_to_1e12_with_bf16_cycles(self):
        # mixed-precision multigrid: bf16 correction cycles (half the
        # memory traffic of f32) under the df64 outer loop still reach
        # 1e-12 — per-outer-step reduction floors at ~eps(bf16)=2^-8, so
        # more outer steps, each far cheaper
        problem = poisson_2d(max_level=6, min_level=3)
        problem.dtype = np.float32
        cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                        pre_smoothing=2, post_smoothing=1, omega=1.15,
                        partitioning=part.RedBlack,
                        coarse_operator=problem.coarsest_operator)
        lowered = lower_cycle(cycle, problem.approximation,
                              problem.rhs_entity)
        solve = make_refined_solver(lowered, inner_cycles=3, max_outer=16,
                                    target_reduction=1e-12,
                                    inner_dtype=jnp.bfloat16)
        b = jnp.asarray(problem.build_rhs()[0], dtype=jnp.float32)
        res = solve(b)
        assert res.converged
        assert res.residuals[-1] <= 1e-12 * res.residuals[0]
        # every outer step must contract (no stall at the bf16 floor)
        ratios = [b / a for a, b in zip(res.residuals, res.residuals[1:])]
        assert max(ratios) < 0.2

    def test_fas_to_1e10_with_f32_cycles(self):
        problem = fas_2d_basic(max_level=5, min_level=3)
        problem.dtype = np.float32
        cycle = fas_v_cycle(problem.level_contexts, problem.rhs_entity,
                            coarse_operator=problem.coarsest_operator)
        lowered = lower_cycle(cycle, problem.approximation,
                              problem.rhs_entity)
        # Newton correction: Richardson preconditioned by a V-cycle for
        # the SHIFTED linear operator L + gamma*I on the same hierarchy
        from evostencils_tpu.problems.api import scalar_hierarchy
        from evostencils_tpu.stencils import gallery
        from evostencils_tpu.ir import base, system
        gen = gallery.ShiftedOperatorGenerator(gallery.Poisson2D(), 20.0)
        ctxs, coarsest = scalar_hierarchy("Ashift", 2, 5, 3, gen)
        rhs_e = system.RightHandSide(
            "f", [base.RightHandSide("f", ctxs[0].grid[0])])
        lin_cycle = v_cycle(ctxs, rhs_e, pre_smoothing=2, post_smoothing=1,
                            omega=1.0, partitioning=part.RedBlack,
                            coarse_operator=coarsest)
        corr = lower_cycle(lin_cycle, ctxs[0].approximation, rhs_e)
        solve = make_refined_solver(
            lowered, inner_cycles=3, max_outer=8,
            target_reduction=1e-10, richardson_iterations=3,
            nonlinear=problem.level_contexts[0].operator,
            correction_lowered=corr)
        b = jnp.asarray(problem.build_rhs()[0], dtype=jnp.float32)
        res = solve(b)
        assert res.converged
        assert res.residuals[-1] <= 1e-10 * res.residuals[0]
