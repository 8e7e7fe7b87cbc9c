"""Linear-elasticity evolution campaign: the
block-shape terminals and collective block-Jacobi smoothers finally get
evolutionary exercise (reference grammar/multigrid.py:388-407; papers
campaign on LinearElasticity).

Protocol: 2D linear elasticity (u,v system), levels 4->8 (255^2, the
reference configuration 2D_FD_LinearElasticity_fromL2.exa3:2-16),
mu=lambda=8, NSGA-II, fitness = (rho, ms/it) on the host CPU in f64,
seeded with the reference-config V(2,1) collective RB 1.25; offspring
prescreened on a 63^2 instance.

    for i in $(seq 1 10); do
      python scripts/evolve_elasticity.py --generations 25 --resume || true
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

CKPT_DIR = str(pathlib.Path(__file__).resolve().parents[1] / ".evolve_elasticity_ckpt")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--generations", type=int, default=25)
    ap.add_argument("--mu", type=int, default=8)
    ap.add_argument("--max-level", type=int, default=8)
    ap.add_argument("--min-level", type=int, default=4)
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
    print(f"[evolve-el] device: {jax.devices()[0]}", file=sys.stderr,
          flush=True)

    from evostencils_tpu.problems.elasticity import linear_elasticity_2d
    from evostencils_tpu.optimization.program import Optimizer
    from evostencils_tpu.optimization.prescreen import SmallGridPrescreen
    from evostencils_tpu.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu.grammar.seeds import v_cycle_string
    from evostencils_tpu.grammar import gp
    from evostencils_tpu.ir import partitioning as part
    from evostencils_tpu.ir import smoother, transformations
    from evostencils_tpu.compiler.cycles import v_cycle

    depth = args.max_level - args.min_level
    problem = linear_elasticity_2d(max_level=args.max_level,
                                   min_level=args.min_level)
    problem.dtype = np.float64
    evaluator = CycleEvaluator(problem, dtype=np.float64)
    prescreen = None
    if not args.no_prescreen:
        small = linear_elasticity_2d(max_level=2 + depth, min_level=2)
        small.dtype = np.float64
        prescreen = SmallGridPrescreen(small, rho_cap=0.9)
    opt = Optimizer(problem, evaluator=evaluator, rng=random.Random(5),
                    prescreen=prescreen,
                    checkpoint_directory_path=args.ckpt_dir)

    # reference solver block: coupled solve for uEq+vEq, RB-GS omega=1.25,
    # 2 pre / 1 post (2D_FD_LinearElasticity_fromL2.exa3:2-16)
    seed = v_cycle_string(depth, args.max_level,
                          smoother="collective_jacobi", omega=1.25)
    t0 = time.perf_counter()
    result = opt.evolutionary_optimization(
        mu_=args.mu, lambda_=args.mu, population_initialization_factor=2,
        generations=args.generations, initial_individuals=[seed],
        continue_from_checkpoint=args.resume, verbose=True)
    wall = time.perf_counter() - t0
    best = result["best_individual"]
    print(f"[evolve-el] done in {wall:.1f}s, "
          f"{evaluator.compilations} structures compiled", flush=True)
    if prescreen is not None:
        print(f"[evolve-el] prescreen: {prescreen.rejected}/"
              f"{prescreen.screened} offspring rejected", flush=True)
    print(f"[evolve-el] best fitness: {best.fitness.values}", flush=True)
    print(f"[evolve-el] best grammar: {str(best)}", flush=True)

    ref_cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                        pre_smoothing=2, post_smoothing=1, omega=1.25,
                        partitioning=part.RedBlack,
                        smoother_factory=smoother.generate_collective_jacobi,
                        coarse_operator=problem.coarsest_operator)
    transformations.assign_cycle_ids(ref_cycle)
    ref = evaluator.evaluate_expression(ref_cycle, key="__el_reference__")
    ind = gp.parse_tree(str(best), opt._pset)
    expr = gp.compile_tree(ind, opt._pset)[0]
    transformations.assign_cycle_ids(expr)
    ev = evaluator.evaluate_expression(expr, key=str(best))
    for tag, r in (("hand-tuned V(2,1) RB 1.25", ref), ("evolved best", ev)):
        ms_it = (r.time_to_convergence_ms / r.iterations
                 if np.isfinite(r.iterations) and r.iterations
                 else float("inf"))
        print(f"[evolve-el] {tag}: rho={r.convergence_factor:.4f} "
              f"it={r.iterations:.0f} ms/it={ms_it:.3f} "
              f"t_conv={r.time_to_convergence_ms:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
