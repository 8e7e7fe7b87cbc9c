"""Baseline harness: measure the default (reference-config) solver
(reference scripts/evaluate_reference_solver.py:15-47 — 20 runs, average
solving time and iteration count)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("problem", nargs="?", default="poisson2d")
    parser.add_argument("--max-level", type=int, default=None)
    parser.add_argument("--min-level", type=int, default=None)
    parser.add_argument("--samples", type=int, default=20)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--f32", action="store_true")
    args = parser.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    if not args.f32:
        jax.config.update("jax_enable_x64", True)

    import numpy as np
    from optimize import get_problem
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.compiler.lower import lower_cycle
    from evostencils_tpu.compiler.solve import measure_solve
    from evostencils_tpu.ir import partitioning as part

    problem = get_problem(args.problem, args.max_level, args.min_level)
    if args.f32:
        problem.dtype = np.float32
    # reference default: V-cycle, RB-GS omega=1.15, 2 pre / 1 post, CG coarse
    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=2, post_smoothing=1, omega=1.15,
                    partitioning=part.RedBlack,
                    coarse_operator=problem.coarsest_operator)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    result = measure_solve(lowered, problem.build_rhs(),
                           max_iterations=problem.max_iterations,
                           target_reduction=problem.target_reduction,
                           samples=args.samples)
    print(f"Average solving time: {result.solve_time_ms} ms")
    print(f"Average number of iterations: {result.iterations}")
    print(f"Convergence factor: {result.convergence_factor}")


if __name__ == "__main__":
    main()
