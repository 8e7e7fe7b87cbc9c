"""Multi-problem cycle-throughput suite on one GPU.

Measures DoF/s through full multigrid cycles for every problem family of
the reference's `example_problems/` (PERF.md reference targets): 2D/3D
Poisson, variable-coefficient Poisson, 2x2 linear elasticity, the
shifted-Laplace Helmholtz preconditioner cycle (split-complex form), and
the nonlinear FAS V-cycle.

Unlike bench.py (one JSON line) this prints a table and a JSON blob.
Each case runs K chained cycles as one program closed by
``jax.block_until_ready`` (runtime/profiling.time_cycle_loop), then solves
to a 1e-5 relative residual on the same device.  All cases run in this one
process; a run that finds no GPU fails.

    python scripts/bench_suite.py
"""

import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def case_specs():
    """(name, builder, note) per problem family; builders are lazy, so
    only the case being measured holds its problem in memory.
    ``BENCH_SUITE_SMALL`` set in the environment selects tiny sizes."""
    import os
    small = bool(os.environ.get("BENCH_SUITE_SMALL"))
    L = (lambda big, tiny: tiny if small else big)
    f32 = np.float32

    def build(problem_fn, cycle_builder, dtype):
        def make():
            from evostencils_tpu.compiler.lower import lower_cycle
            problem = problem_fn()
            problem.dtype = dtype
            cycle = cycle_builder(problem)
            low = lower_cycle(cycle, problem.approximation,
                              problem.rhs_entity)
            b = problem.build_rhs()
            n_dof = sum(int(np.prod(g.size)) for g in problem.finest_grid)
            return low, b, n_dof
        return make

    def std_v(problem, omega=1.15, partitioning=None):
        from evostencils_tpu.compiler.cycles import v_cycle
        from evostencils_tpu.ir import partitioning as part
        return v_cycle(problem.level_contexts, problem.rhs_entity,
                       pre_smoothing=2, post_smoothing=1, omega=omega,
                       partitioning=partitioning or part.RedBlack,
                       coarse_operator=problem.coarsest_operator)

    def _poisson2d():
        from evostencils_tpu.problems.poisson import poisson_2d
        return poisson_2d(max_level=L(12, 5), min_level=L(5, 3))

    def _poisson3d():
        from evostencils_tpu.problems.poisson import poisson_3d
        return poisson_3d(max_level=L(8, 4), min_level=2)

    def _poisson2d_var():
        from evostencils_tpu.problems.poisson import poisson_2d_variable
        return poisson_2d_variable(max_level=L(11, 5), min_level=L(5, 3))

    def _elasticity():
        from evostencils_tpu.problems.elasticity import linear_elasticity_2d
        return linear_elasticity_2d(max_level=L(11, 5), min_level=L(4, 3))

    def _helmholtz():
        # split-complex form: the whole program is real-typed;
        # algebraically identical to the complex cycle
        # (tests/test_split_complex.py)
        from evostencils_tpu.problems.helmholtz import helmholtz_2d_split
        return helmholtz_2d_split(max_level=L(11, 5), min_level=3)

    def _fas():
        from evostencils_tpu.problems.fas import fas_2d_basic
        return fas_2d_basic(max_level=L(10, 5), min_level=L(6, 3))

    def _jacobi_v(p):
        from evostencils_tpu.ir import partitioning as part
        return std_v(p, omega=0.8, partitioning=part.Single)

    def _fas_v(p):
        from evostencils_tpu.compiler.cycles import fas_v_cycle
        return fas_v_cycle(p.level_contexts, p.rhs_entity,
                           coarse_operator=p.coarsest_operator)

    return [
        (f"poisson2d_{2**L(12,5)-1}sq",
         build(_poisson2d, std_v, f32),
         "reference solver block, RB-GS 1.15"),
        (f"poisson3d_{2**L(8,4)-1}cube",
         build(_poisson3d, std_v, f32), "7-point, RB-GS 1.15"),
        (f"poisson2d_var_{2**L(11,5)-1}sq",
         build(_poisson2d_var, _jacobi_v, f32),
         "variable coefficients, Jacobi 0.8"),
        (f"elasticity2d_{2**L(11,5)-1}sq",
         build(_elasticity, lambda p: std_v(p, omega=1.25), f32),
         "2x2 system, collective RB 1.25"),
        (f"helmholtz2d_{2**L(11,5)-1}sq",
         build(_helmholtz, lambda p: std_v(p, omega=0.6), f32),
         "split-complex shifted-Laplace preconditioner cycle, RB 0.6"),
        (f"fas2d_{2**L(10,5)-1}sq",
         build(_fas, _fas_v, f32), "nonlinear FAS, Newton-Jacobi 0.8"),
    ]


def main():
    import math
    import jax.numpy as jnp
    from evostencils_tpu.config import enable_persistent_compilation_cache
    from evostencils_tpu.compiler.solve import make_solver
    from evostencils_tpu.runtime.profiling import (
        card_description, require_gpu, time_cycle_loop)
    enable_persistent_compilation_cache()
    dev = require_gpu()
    print(f"[suite] device: {dev.platform} {dev.device_kind}; card: "
          f"{card_description()}", file=sys.stderr)

    def converge(low, b, om, target=1e-5, max_iter=60):
        """Solve to ``target`` on the device: iterations, asymptotic rho,
        and the extrapolated iteration count to the reference's deep
        target (log(eps)/log(rho), evaluation/evaluator.py semantics)."""
        run = make_solver(low, max_iterations=max_iter,
                          target_reduction=target)
        u0 = tuple(jnp.zeros_like(x) for x in b)
        _, k, hist = run(u0, b, om)
        k = int(k)
        hist = np.asarray(hist)
        kk = max(min(k, 6), 1)
        rho = float((hist[kk] / hist[0]) ** (1.0 / kk))
        deep = (math.log(1e-12) / math.log(rho)
                if 0 < rho < 1 else float("inf"))
        return k, rho, deep

    results = {}
    for name, build_case, note in case_specs():
        low, b, n_dof = build_case()
        om = jnp.asarray(low.default_omegas, np.float32)
        t, comp, _ = time_cycle_loop(low, b, om, n_cycles=100)
        iters, rho, deep = converge(low, b, om)
        dofs = n_dof / t
        results[name] = {"cycle_ms": t * 1e3, "dof_per_s": dofs,
                         "iters_1e5": iters, "rho": rho,
                         "extrapolated_iters_1e12": deep,
                         "n_dof": n_dof, "note": note,
                         "compile_and_first_s": comp}
        print(f"{name:28s} {n_dof:>12d} DoF  {t*1e3:8.4f} ms/cycle  "
              f"{dofs:.4e} DoF/s  rho={rho:.4f} it(1e-5)={iters} "
              f"it(1e-12)~{deep:.0f}  (compile+first {comp:.1f}s)  # {note}",
              flush=True)

    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
