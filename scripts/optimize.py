"""Main CLI: evolve multigrid cycles for a problem (reference
scripts/optimize.py).

Usage:
    python scripts/optimize.py <problem> [method] [options]

    problem: poisson2d | poisson3d | poisson2d_var | elasticity2d |
             helmholtz2d | fas2d
    method:  NSGAII (default) | NSGAIII | SOGP | RandomSearch

Options:
    --mu N --lambda N --generations N --levels-per-run N
    --max-level N --min-level N
    --output DIR   (default ./evo_output)
    --cpu          force CPU backend
    --f32          evaluate in float32 (default: float64, the reference's
                   precision)
"""

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def get_problem(name, max_level=None, min_level=None):
    from evostencils_tpu.problems import poisson
    factories = {
        "poisson2d": (poisson.poisson_2d, 9, 5),
        "poisson3d": (poisson.poisson_3d, 6, 2),
        "poisson2d_var": (poisson.poisson_2d_variable, 9, 5),
    }
    try:
        from evostencils_tpu.problems import elasticity
        factories["elasticity2d"] = (elasticity.linear_elasticity_2d, 8, 4)
    except (ImportError, AttributeError):
        pass
    try:
        from evostencils_tpu.problems import helmholtz
        factories["helmholtz2d"] = (helmholtz.helmholtz_2d, 7, 3)
        # split-complex 2x2 real form: the whole program is real-typed
        # (algebraically identical — tests/test_split_complex.py)
        factories["helmholtz2d_split"] = (helmholtz.helmholtz_2d_split,
                                          7, 3)
    except (ImportError, AttributeError):
        pass
    try:
        from evostencils_tpu.problems import fas
        factories["fas2d"] = (fas.fas_2d_basic, 10, 6)
    except (ImportError, AttributeError):
        pass
    if name not in factories:
        raise SystemExit(f"unknown problem {name!r}; "
                         f"available: {sorted(factories)}")
    fn, default_max, default_min = factories[name]
    return fn(max_level=max_level or default_max,
              min_level=min_level or default_min)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("problem")
    parser.add_argument("method", nargs="?", default="NSGAII")
    parser.add_argument("--mu", type=int, default=8)
    parser.add_argument("--lambda", dest="lambda_", type=int, default=8)
    parser.add_argument("--generations", type=int, default=50)
    parser.add_argument("--levels-per-run", type=int, default=None)
    parser.add_argument("--max-level", type=int, default=None)
    parser.add_argument("--min-level", type=int, default=None)
    parser.add_argument("--output", default="./evo_output")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--f32", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--no-robustness", action="store_true",
                        help="skip the Helmholtz 2k/4k robustness variants")
    parser.add_argument("--model-based", action="store_true",
                        help="LFA + roofline fitness instead of measured "
                             "solves (reference model_based_estimation)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the checkpoint in --output")
    parser.add_argument("--islands", type=int, default=1,
                        help="population-parallel island ranks (threads "
                             "on one host; multi-host runs use "
                             "jax.distributed + JaxProcessCommunicator)")
    parser.add_argument("--generalization-interval", type=int,
                        default=10 ** 9,
                        help="generations between problem-size growth")
    args = parser.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    if not args.f32:
        jax.config.update("jax_enable_x64", True)
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()

    import random
    import numpy as np
    from evostencils_tpu.optimization.program import Optimizer
    from evostencils_tpu.evaluation.evaluator import CycleEvaluator

    os.makedirs(args.output, exist_ok=True)

    def run_rank(comm):
        """One island rank; identical seeds keep populations replicated
        while evaluation is partitioned (parallel/comm.py)."""
        problem = get_problem(args.problem, args.max_level, args.min_level)
        if args.f32:
            problem.dtype = np.float32
        evaluator = CycleEvaluator(problem)
        # Helmholtz: every candidate must also solve at 2k and 4k — the
        # reference's wavenumber-doubling robustness schedule
        # (reference scripts/optimize.py:33-37, exastencils.py:518-532)
        robustness = []
        robustness_factories = None
        if args.problem in ("helmholtz2d", "helmholtz2d_split") \
                and not args.no_robustness:
            from evostencils_tpu.problems.helmholtz import (
                helmholtz_2d, helmholtz_2d_split, K_DEFAULT)
            factory = (helmholtz_2d_split
                       if args.problem == "helmholtz2d_split"
                       else helmholtz_2d)
            robustness_factories = [
                (lambda lo, hi, kk=f * K_DEFAULT, fac=factory:
                 fac(max_level=hi, min_level=lo, k=kk))
                for f in (2, 4)]
            robustness = [
                f(args.min_level or 3, args.max_level or 7)
                for f in robustness_factories]
        optimizer = Optimizer(
            problem, evaluator=evaluator, robustness_problems=robustness,
            robustness_factories=robustness_factories,
            checkpoint_directory_path=os.path.join(args.output,
                                                   "checkpoints"),
            model_based_estimation=args.model_based,
            problem_factory=lambda lo, hi: get_problem(args.problem, hi, lo),
            rng=random.Random(args.seed), comm=comm)

        method = {"NSGAII": optimizer.NSGAII, "NSGAIII": optimizer.NSGAIII,
                  "SOGP": optimizer.SOGP}.get(args.method)
        use_random_search = args.method == "RandomSearch"
        return optimizer.evolutionary_optimization(
            mu_=args.mu, lambda_=args.lambda_, generations=args.generations,
            levels_per_run=args.levels_per_run,
            generalization_interval=args.generalization_interval,
            optimization_method=method if not use_random_search else None,
            continue_from_checkpoint=args.resume,
            use_random_search=use_random_search)

    from evostencils_tpu.parallel import comm as comms
    if args.islands > 1:
        # island ranks MUST share one seed: populations stay replicated
        # and only evaluation is partitioned (parallel/comm.py contract)
        if args.seed is None:
            args.seed = random.randrange(2 ** 63)
            print(f"[islands] generated shared seed {args.seed}")
        results = comms.run_island_threads([run_rank] * args.islands)
        result = results[0]
    else:
        result = run_rank(comms.default_communicator())

    print("\nBest individual:")
    print(result["grammar_string"])
    # one line per level chunk (finest first); single-chunk runs write one
    # line, and evaluate_evolved_solver.py recomposes multi-line files
    chunks = result.get("chunk_grammar_strings") or [result["grammar_string"]]
    with open(os.path.join(args.output, "best_grammar.txt"), "w") as f:
        f.write("\n".join(chunks) + "\n")
    with open(os.path.join(args.output, "result.p"), "wb") as f:
        pickle.dump({"grammar_string": result["grammar_string"],
                     "chunk_grammar_strings": chunks,
                     "populations": result["populations"],
                     "logbooks": result["logbooks"]}, f)
    print(f"Results written to {args.output}")


if __name__ == "__main__":
    main()
