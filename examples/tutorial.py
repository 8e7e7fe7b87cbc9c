"""Tutorial: the canonical user journey on 2D Poisson.

Mirrors the reference's notebooks/tutorial.ipynb — solve a problem with
the textbook solver, then evolve a better multigrid cycle with G3P and
compare — but with everything running through the JAX stack:
problems are plain Python objects (no ExaSlang files), cycles lower to
jitted JAX programs (no JVM / g++ round-trip), and a whole population is
measured with structure-cached, vmapped solves.

Run:  python examples/tutorial.py            (small: mu=lambda=4, 10 gens)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp


def main():
    # the reference's protocol is float64 (1e-12 targets); f32 stalls
    # near 1e-7 and would hit the iteration cap below
    jax.config.update("jax_enable_x64", True)
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    # ---------------------------------------------------------------- 1
    # Define the problem.  The reference parses ExaSlang .exa*/.knowledge
    # files back into Python (exastencils.py:93-96); here a Problem holds
    # the per-level operators/transfers directly.
    from evostencils_tpu.problems.poisson import poisson_2d
    problem = poisson_2d(max_level=7, min_level=4)
    print(f"problem: {problem.name}, levels {problem.min_level}"
          f"..{problem.max_level}, grid {problem.finest_grid[0].size}")

    # ---------------------------------------------------------------- 2
    # Baseline: the reference's default solver — V-cycle, RB-GS omega=1.15,
    # 2 pre / 1 post smoothing, exact coarse solve
    # (example_problems/Poisson/2D_FD_Poisson_fromL2.exa3:1-14).
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.compiler.lower import lower_cycle
    from evostencils_tpu.compiler.solve import make_solver
    from evostencils_tpu.ir import partitioning as part

    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=2, post_smoothing=1, omega=1.15,
                    partitioning=part.RedBlack,
                    coarse_operator=problem.coarsest_operator)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    b = problem.build_rhs()
    u0 = tuple(jnp.zeros_like(x) for x in b)
    run = make_solver(lowered, max_iterations=100, target_reduction=1e-12)
    u, k, hist = run(u0, b, jnp.asarray(lowered.default_omegas))
    k = int(k)
    hist = np.asarray(hist)
    rho = (hist[k] / hist[0]) ** (1 / k)
    print(f"reference V(2,1) RB-GS: {k} iterations, rho = {rho:.4f}")

    # ---------------------------------------------------------------- 3
    # Model-based analysis: LFA spectral radius (replaces LFA Lab) and a
    # roofline runtime estimate.
    from evostencils_tpu.prediction.convergence import ConvergenceEvaluator
    from evostencils_tpu.prediction.performance import (PerformanceEvaluator,
                                                        H100_SXM)
    ev = ConvergenceEvaluator(problem.dimension)
    print(f"LFA backend: {ev.backend_name}, "
          f"predicted rho = {ev.compute_spectral_radius(cycle):.4f}")
    perf = PerformanceEvaluator(H100_SXM)
    print(f"roofline cycle time on {perf.machine.name}: "
          f"{perf.estimate_runtime(cycle) * 1e3:.3f} ms")

    # ---------------------------------------------------------------- 4
    # Evolve cycles with grammar-guided genetic programming
    # (mu=lambda=4, 10 generations — the tutorial-sized run of the
    # reference notebook).
    from evostencils_tpu.optimization.program import Optimizer

    optimizer = Optimizer(problem, checkpoint_directory_path=os.path.join(
        os.path.dirname(__file__), "..", "evo_output", "tutorial"))
    result = optimizer.evolutionary_optimization(
        mu_=4, lambda_=4, generations=10, levels_per_run=3)
    best = result["best_individual"]
    print("best evolved grammar string:")
    print(" ", result["grammar_string"][:160], "...")
    print(f"best fitness: {best.fitness.values}")

    # ---------------------------------------------------------------- 5
    # Re-evaluate the stored individual from its grammar string — the
    # 'serve' path (reference scripts/evaluate_evolved_solver.py).
    _, res = optimizer.generate_and_evaluate_program_from_grammar_representation(
        result["grammar_string"])
    print(f"re-evaluated: rho = {res.convergence_factor:.4f}, "
          f"{res.iterations:.0f} iterations")


if __name__ == "__main__":
    main()
