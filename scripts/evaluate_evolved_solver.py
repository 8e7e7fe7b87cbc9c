"""Re-measure a stored evolved solver from its grammar string
(reference scripts/evaluate_evolved_solver.py:6-53)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("grammar_file",
                        help="path to best_grammar.txt from optimize.py")
    parser.add_argument("problem", nargs="?", default="poisson2d")
    parser.add_argument("--max-level", type=int, default=None)
    parser.add_argument("--min-level", type=int, default=None)
    parser.add_argument("--samples", type=int, default=20)
    parser.add_argument("--levels-per-run", type=int, default=None,
                        help="chunk size of a multi-line (level-chunked) "
                             "grammar file; inferred from the line count "
                             "when omitted")
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
    from evostencils_tpu.optimization.program import Optimizer
    from evostencils_tpu.evaluation.evaluator import CycleEvaluator

    with open(args.grammar_file) as f:
        lines = [ln.strip() for ln in f if ln.strip()]

    problem = get_problem(args.problem, args.max_level, args.min_level)
    if args.f32:
        problem.dtype = np.float32
    optimizer = Optimizer(problem, evaluator=CycleEvaluator(problem))
    if len(lines) > 1:
        # level-chunked solver: one grammar string per chunk, finest
        # first; the composed program is measured on the finest grid
        expr, result = optimizer.evaluate_chunked_program(
            lines, levels_per_run=args.levels_per_run)
    else:
        expr, result = \
            optimizer \
            .generate_and_evaluate_program_from_grammar_representation(
                lines[0])
    print(f"Time to convergence: {result.time_to_convergence_ms} ms")
    print(f"Convergence factor: {result.convergence_factor}")
    print(f"Number of iterations: {result.iterations}")


if __name__ == "__main__":
    main()
