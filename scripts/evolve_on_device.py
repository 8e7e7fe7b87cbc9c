"""Evolution with fitness MEASURED ON THE DEVICE — the reference's entire
point is measuring candidates on the target machine (reference
code_generation/exastencils.py:485-537).

Campaign hardening:
* offspring are pre-screened on a small CPU instance of the problem
  (optimization/prescreen.py) so hopeless candidates never reach the
  device compile queue (the reference's cheap-estimate dual path,
  reference optimization/program.py:319-384);
* per-structure timing uses the slope-fit protocol (windows of 1/2/4/8
  chained solves; the fixed per-window cost cancels in the
  intercept — evaluation/evaluator.py);
* the final head-to-head (evolved champion vs reference V(2,1)) is
  measured INTERLEAVED in one process via
  ``CycleEvaluator.measure_interleaved``.

    python scripts/evolve_on_device.py
"""

import pathlib
import random
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

CKPT_DIR = str(pathlib.Path(__file__).resolve().parents[1] / ".evolve_ckpt")


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--generations", type=int, default=5)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the checkpoint of a previous run "
                         "(fitness cache + rng + population restored)")
    ap.add_argument("--no-prescreen", action="store_true")
    ap.add_argument("--mu", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--seed-reference", action="store_true",
                    help="seed the initial population with the reference "
                         "V(2,1) RB 1.15 grammar individual")
    ap.add_argument("--seeds-from", default=None,
                    help="checkpoint file whose hall-of-fame/population "
                         "champions seed the initial population")
    ap.add_argument("--generalization-interval", type=int, default=10 ** 9,
                    help="grow the problem one level (e.g. 511^2 -> "
                         "1023^2) every N generations and re-evaluate "
                         "the population (reference program.py:512-539)")
    ap.add_argument("--start-max-level", type=int, default=10)
    ap.add_argument("--start-min-level", type=int, default=5)
    ap.add_argument("--skip-headtohead", action="store_true",
                    help="just advance the campaign; the head-to-head is "
                         "measured separately in a fresh process "
                         "(scripts/head_to_head.py)")
    args = ap.parse_args()

    import jax
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    print(f"[evolve] device: {jax.devices()[0]}", file=sys.stderr,
          flush=True)

    from evostencils_tpu.problems.poisson import poisson_2d
    from evostencils_tpu.optimization.program import Optimizer
    from evostencils_tpu.optimization.prescreen import SmallGridPrescreen
    from evostencils_tpu.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.ir import partitioning as part
    from evostencils_tpu.grammar import gp
    from evostencils_tpu.ir import transformations

    max_level = args.start_max_level    # default 1023^2 fine grid
    min_level = args.start_min_level

    def problem_factory(mn, mx):
        prob = poisson_2d(max_level=mx, min_level=mn)
        prob.dtype = np.float32
        return prob

    problem = problem_factory(min_level, max_level)
    evaluator = CycleEvaluator(problem)
    # compiles run in the remote compile service; local threads only wait
    evaluator.compile_workers = 8
    prescreen = None
    if not args.no_prescreen:
        # same 5-level hierarchy at 127^2 on the host CPU
        small = poisson_2d(max_level=7, min_level=2)
        prescreen = SmallGridPrescreen(small, rho_cap=0.9)
    opt = Optimizer(problem, evaluator=evaluator, rng=random.Random(42),
                    prescreen=prescreen,
                    problem_factory=problem_factory,
                    checkpoint_directory_path=args.ckpt_dir)

    seeds = []
    if args.seed_reference:
        from evostencils_tpu.grammar.seeds import v_cycle_string
        seeds.append(v_cycle_string(max_level - min_level, max_level,
                                    smoother="collective_jacobi",
                                    omega=1.15))
    if args.seeds_from:
        from evostencils_tpu.optimization.program import \
            load_checkpoint_from_file
        cp = load_checkpoint_from_file(args.seeds_from)
        cands = list(cp.hof_items or []) + list(cp.population)
        seen = set()
        for ind in cands:
            s = str(ind)
            if s not in seen:
                seen.add(s)
                seeds.append(s)
            if len(seeds) >= args.mu:
                break

    gens = args.generations
    t_start = time.perf_counter()
    result = opt.evolutionary_optimization(
        mu_=args.mu, lambda_=args.mu, population_initialization_factor=2,
        generations=gens, continue_from_checkpoint=args.resume,
        generalization_interval=args.generalization_interval,
        initial_individuals=seeds or None,
        verbose=True)
    wall = time.perf_counter() - t_start
    best = result["best_individual"]
    vals = best.fitness.values
    print(f"[evolve] {gens} generations in {wall:.1f}s wall, "
          f"{evaluator.compilations} structures compiled "
          f"({wall / max(evaluator.compilations, 1):.1f}s/structure "
          f"amortized)", flush=True)
    if prescreen is not None:
        print(f"[evolve] prescreen: {prescreen.rejected}/"
              f"{prescreen.screened} offspring rejected before the "
              f"device compile queue", flush=True)
    print(f"[evolve] best fitness (rho, ms/it): {vals}", flush=True)
    print(f"[evolve] best grammar: {str(best)[:400]}", flush=True)
    if args.skip_headtohead:
        return

    # --- head-to-head: reference baseline vs evolved best, INTERLEAVED ---
    ref_cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                        pre_smoothing=2, post_smoothing=1, omega=1.15,
                        partitioning=part.RedBlack,
                        coarse_operator=problem.coarsest_operator)
    transformations.assign_cycle_ids(ref_cycle)
    state = gp.compile_tree(best, opt._pset)
    expr = state[0]
    transformations.assign_cycle_ids(expr)
    rows = evaluator.measure_interleaved(
        [("reference V(2,1) RB 1.15", ref_cycle), ("evolved best", expr)],
        reps=5)
    for r in rows:
        lo, hi = r["ms_per_iter_spread"]
        print(f"[evolve] {r['key']}: t_conv={r['time_to_convergence_ms']:.3f}"
              f" ms  rho={r['convergence_factor']:.4f} it={r['iterations']}"
              f"  ms/it={r['ms_per_iter']:.4f} [{lo:.4f},{hi:.4f}]",
              flush=True)
    ref_t = rows[0]["time_to_convergence_ms"]
    ev_t = rows[1]["time_to_convergence_ms"]
    verdict = "BEATS" if ev_t < ref_t else "does NOT beat"
    print(f"[evolve] evolved best {verdict} the reference baseline "
          f"on-device ({ev_t:.3f} vs {ref_t:.3f} ms to convergence, "
          f"interleaved in one process)", flush=True)


if __name__ == "__main__":
    main()
