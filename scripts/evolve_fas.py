"""First nonlinear evolution campaign: evolve FAS cycles (the reference built exastencils_FAS.py:11-447 precisely
to evaluate evolved nonlinear cycles; its hand-tuned configuration is
the damped Newton-Jacobi 0.8 FAS V(2,2), FAS_2D_Basic_template.exa4:26-34).

Protocol: 2D FAS (-Lap u + 20 e^u u = f) at 1023^2, levels 6->10,
mu=lambda=8, NSGA-II selection, fitness = (rho, ms/cycle) measured on
the host CPU in f64 (nonlinear convergence physics is precision-bound —
the reference's own protocol is f64 C++; device timing of the winner is
a separate measurement).  Seeded with the hand-tuned FAS V(2,2) via
grammar/seeds.fas_v_cycle_string; offspring prescreened on a 127^2
instance of the same 4-level grammar.

XLA-CPU exhausts LLVM JIT section memory after ~7 generations per
process — run under a checkpoint-resume restart
loop:

    for i in $(seq 1 8); do
      python scripts/evolve_fas.py --generations 25 --resume || true
    done
"""

import argparse
import os
import pathlib
import random
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

CKPT_DIR = str(pathlib.Path(__file__).resolve().parents[1] / ".evolve_fas_ckpt")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--generations", type=int, default=25)
    ap.add_argument("--mu", type=int, default=8)
    ap.add_argument("--max-level", type=int, default=10)
    ap.add_argument("--min-level", type=int, default=6)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-prescreen", action="store_true")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    print(f"[evolve-fas] device: {jax.devices()[0]}", file=sys.stderr,
          flush=True)

    from evostencils_tpu.problems.fas import fas_2d_basic
    from evostencils_tpu.optimization.program import Optimizer
    from evostencils_tpu.optimization.prescreen import SmallGridPrescreen
    from evostencils_tpu.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu.grammar.seeds import fas_v_cycle_string
    from evostencils_tpu.grammar import gp
    from evostencils_tpu.ir import transformations
    from evostencils_tpu.compiler.cycles import fas_v_cycle

    depth = args.max_level - args.min_level
    problem = fas_2d_basic(max_level=args.max_level, min_level=args.min_level)
    problem.dtype = np.float64
    evaluator = CycleEvaluator(problem, dtype=np.float64, max_iterations=60)
    prescreen = None
    if not args.no_prescreen:
        small = fas_2d_basic(max_level=3 + depth, min_level=3)
        small.dtype = np.float64
        prescreen = SmallGridPrescreen(small, rho_cap=0.9)
    opt = Optimizer(problem, evaluator=evaluator, rng=random.Random(11),
                    prescreen=prescreen,
                    checkpoint_directory_path=args.ckpt_dir)

    seed = fas_v_cycle_string(depth, args.max_level, omega=0.8,
                              pre=2, post=2)
    t0 = time.perf_counter()
    result = opt.evolutionary_optimization(
        mu_=args.mu, lambda_=args.mu, population_initialization_factor=2,
        generations=args.generations, initial_individuals=[seed],
        continue_from_checkpoint=args.resume, verbose=True)
    wall = time.perf_counter() - t0
    best = result["best_individual"]
    print(f"[evolve-fas] done in {wall:.1f}s, "
          f"{evaluator.compilations} structures compiled", flush=True)
    if prescreen is not None:
        print(f"[evolve-fas] prescreen: {prescreen.rejected}/"
              f"{prescreen.screened} offspring rejected", flush=True)
    print(f"[evolve-fas] best fitness: {best.fitness.values}", flush=True)
    print(f"[evolve-fas] best grammar: {str(best)}", flush=True)

    # head-to-head vs the hand-tuned FAS V(2,2) Newton-Jacobi 0.8
    ref_cycle = fas_v_cycle(problem.level_contexts, problem.rhs_entity,
                            coarse_operator=problem.coarsest_operator)
    transformations.assign_cycle_ids(ref_cycle)
    ref = evaluator.evaluate_expression(ref_cycle, key="__fas_reference__")
    ind = gp.parse_tree(str(best), opt._pset)
    expr = gp.compile_tree(ind, opt._pset)[0]
    transformations.assign_cycle_ids(expr)
    ev = evaluator.evaluate_expression(expr, key=str(best))
    for tag, r in (("hand-tuned V(2,2)", ref), ("evolved best", ev)):
        ms_it = (r.time_to_convergence_ms / r.iterations
                 if np.isfinite(r.iterations) and r.iterations else float("inf"))
        print(f"[evolve-fas] {tag}: rho={r.convergence_factor:.4f} "
              f"it={r.iterations:.0f} ms/it={ms_it:.3f} "
              f"t_conv={r.time_to_convergence_ms:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
