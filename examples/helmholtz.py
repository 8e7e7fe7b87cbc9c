"""Helmholtz tutorial: evolving a complex shifted-Laplace MG
preconditioner inside BiCGStab.

Mirrors the reference's notebooks/helmholtz.ipynb — the indefinite 2D
Helmholtz problem (k = 80, Robin boundaries) is solved by BiCGStab to
1e-7, preconditioned by one application of an evolved multigrid cycle on
the complex-shifted operator M = -Lap - k^2(1 + 0.5i)
(example_problems/Helmholtz/2D_FD_Helmholtz_fromL3.exa3:55-212).  The
reference's `pde_parameter_values={'k': [80*2^i]}` generalization
schedule becomes robustness variants: every candidate's fitness is its
worst case over k and 2k (exastencils.py:518-532).

Run:  python examples/helmholtz.py        (small: mu=lambda=4, 5 gens)
Env:  ES_LEVELS=maxlevel  ES_GENS=n  ES_MU=n  to scale up.
"""

import os
import sys
import random

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

EVO_OUTPUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "evo_output")


def main():
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    max_level = int(os.environ.get("ES_LEVELS", 6))
    gens = int(os.environ.get("ES_GENS", 5))
    mu = int(os.environ.get("ES_MU", 4))

    # ---------------------------------------------------------------- 1
    # The problem: complex fields, indefinite A, shifted-Laplacian M as
    # the preconditioner target, BiCGStab outer solve.
    from evostencils_tpu.problems.helmholtz import helmholtz_2d, K_DEFAULT
    problem = helmholtz_2d(max_level=max_level, min_level=3)
    print(f"problem: {problem.name}, k={K_DEFAULT}, levels "
          f"{problem.min_level}..{problem.max_level}, "
          f"grid {problem.finest_grid[0].size}, outer="
          f"{problem.outer_solver.name} to {problem.outer_solver.tolerance}")

    # ---------------------------------------------------------------- 2
    # Baseline: the hand-written preconditioner of the reference — a
    # V-cycle on M with RB-GS omega=0.6 pre-smoothing
    # (2D_FD_Helmholtz_fromL3.exa3:203-212).
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu.ir import partitioning as part, transformations

    evaluator = CycleEvaluator(problem)
    baseline = v_cycle(problem.level_contexts, problem.rhs_entity,
                       pre_smoothing=2, post_smoothing=1, omega=0.6,
                       partitioning=part.RedBlack,
                       coarse_operator=problem.coarsest_operator)
    transformations.assign_cycle_ids(baseline)
    res = evaluator.evaluate_expression(baseline, key="baseline")
    print(f"baseline V(2,1) RB-GS(0.6): {res.iterations:.0f} BiCGStab "
          f"iterations, {res.time_to_convergence_ms:.1f} ms, "
          f"rho={res.convergence_factor:.3f}")

    # ---------------------------------------------------------------- 3
    # Evolve the preconditioner cycle.  Robustness: each candidate must
    # also solve the 2k variant; fitness is the worst case.
    from evostencils_tpu.optimization.program import Optimizer
    from evostencils_tpu.grammar.multigrid import generate_primitive_set

    variants = [helmholtz_2d(max_level=max_level, min_level=3,
                             k=2 * K_DEFAULT)]
    opt = Optimizer(problem, evaluator=evaluator,
                    robustness_problems=variants,
                    checkpoint_directory_path=os.path.join(
                        EVO_OUTPUT, "helmholtz"),
                    rng=random.Random(0))
    result = opt.evolutionary_optimization(
        mu_=mu, lambda_=mu, population_initialization_factor=2,
        generations=gens, verbose=True)

    best = result["best_individual"]
    print("\nbest grammar string:\n", result["grammar_string"])
    print("fitness (worst case over k, 2k):", best.fitness.values)

    # ---------------------------------------------------------------- 4
    # Re-measure the stored individual at every k of the schedule — the
    # reference's evaluate_evolved_solver protocol.
    for factor in (1, 2, 4):
        variant = helmholtz_2d(max_level=max_level, min_level=3,
                               k=factor * K_DEFAULT)
        opt_v = Optimizer(variant, checkpoint_directory_path=os.path.join(
            EVO_OUTPUT, "helmholtz_variant"))
        try:
            _, res_v = \
                opt_v.generate_and_evaluate_program_from_grammar_representation(
                    result["grammar_string"])
            msg = (f"{res_v.iterations:.0f} iterations, "
                   f"{res_v.time_to_convergence_ms:.1f} ms"
                   if res_v.iterations < opt_v.infinity else "diverged")
        except (KeyError, ValueError, SyntaxError):
            msg = "tree does not re-parse on this variant"
        print(f"k={factor * K_DEFAULT:6.0f}: {msg}")


if __name__ == "__main__":
    main()
