"""Helmholtz evolution campaign — the reference's flagship: evolve the
shifted-Laplace MG preconditioner INSIDE BiCGStab, with k-doubling
robustness (reference notebooks/helmholtz.ipynb journey;
scripts/optimize.py:33-37 k schedule; code_generation/exastencils.py:518-532
robustness loop).

Fitness per candidate = the measured outer PreconditionedBiCGStab solve
with one application of the evolved cycle per iteration, taken as the
WORST CASE over k and 2k (robustness variants).  Runs on the host CPU in
f64 (convergence physics is precision-bound, not device-bound — the
reference's own protocol is f64 C++; device timing of the winning
preconditioner is a separate measurement), using the split-complex
formulation so the winner is directly the device-executable form.

    PYTHONPATH=... python scripts/evolve_helmholtz.py --generations 20
"""

import argparse
import os
import pathlib
import random
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

CKPT_DIR = str(pathlib.Path(__file__).resolve().parents[1] / ".evolve_helmholtz_ckpt")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--generations", type=int, default=20)
    ap.add_argument("--mu", type=int, default=8)
    ap.add_argument("--k", type=float, default=80.0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-level", type=int, default=7)
    ap.add_argument("--min-level", type=int, default=3)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    print(f"[evolve-hh] device: {jax.devices()[0]}", file=sys.stderr,
          flush=True)

    from evostencils_tpu.problems.helmholtz import helmholtz_2d_split
    from evostencils_tpu.optimization.program import Optimizer
    from evostencils_tpu.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.ir import partitioning as part
    from evostencils_tpu.ir import smoother, transformations
    from evostencils_tpu.grammar import gp

    kwargs = dict(max_level=args.max_level, min_level=args.min_level)
    problem = helmholtz_2d_split(k=args.k, **kwargs)
    problem.dtype = np.float64
    # robustness: every candidate must also solve 2k within the iteration
    # cap (reference k-doubling, exastencils.py:518-532)
    variant = helmholtz_2d_split(k=2 * args.k, **kwargs)
    variant.dtype = np.float64
    # evolution-time iteration cap: the reference-config preconditioner
    # needs 265 its at k=80 / ~1300 at 2k; candidates beyond ~2000 are
    # dead anyway and the reference's 10000 cap makes every FAILING
    # candidate cost ~50 s of CPU BiCGStab — the final protocol
    # (helmholtz_convergence.py) keeps the full 10000 cap
    problem.max_iterations = 2000
    variant.max_iterations = 2000
    evaluator = CycleEvaluator(problem, dtype=np.float64)
    opt = Optimizer(problem, evaluator=evaluator, rng=random.Random(7),
                    robustness_problems=[variant],
                    checkpoint_directory_path=args.ckpt_dir)

    # seed: the reference-config shifted-Laplace V(2,1) collective RB 0.6
    # preconditioner (2D_FD_Helmholtz_fromL3.exa3:203-212) — on the
    # indefinite operator a random mu=8 population contains nothing that
    # converges, so evolution starts from the reference's own baseline
    # (265 BiCGStab iterations at k=80) exactly as its notebook journey
    from evostencils_tpu.grammar.seeds import v_cycle_string
    depth = args.max_level - args.min_level
    seed = v_cycle_string(depth, args.max_level,
                          smoother="collective_jacobi", omega=0.6)
    t0 = time.perf_counter()
    result = opt.evolutionary_optimization(
        mu_=args.mu, lambda_=args.mu, population_initialization_factor=2,
        generations=args.generations, initial_individuals=[seed],
        continue_from_checkpoint=args.resume, verbose=True)
    wall = time.perf_counter() - t0
    best = result["best_individual"]
    print(f"[evolve-hh] {args.generations} generations in {wall:.1f}s, "
          f"{evaluator.compilations} structures compiled", flush=True)
    print(f"[evolve-hh] best fitness: {best.fitness.values}", flush=True)
    print(f"[evolve-hh] best grammar: {str(best)}", flush=True)

    # head-to-head vs the reference config: V(2,1) RB omega=0.6 collective
    # shifted-Laplace cycle (2D_FD_Helmholtz_fromL3.exa3:203-212), fitness
    # = outer BiCGStab iterations to 1e-7 at k (and 2k robustness)
    for tag, prob_v in (("k", problem), ("2k", variant)):
        ev_v = opt.evaluator if prob_v is problem else opt._robustness[0][0]
        ref_cycle = v_cycle(prob_v.level_contexts, prob_v.rhs_entity,
                            pre_smoothing=2, post_smoothing=1, omega=0.6,
                            partitioning=part.RedBlack,
                            smoother_factory=smoother
                            .generate_collective_jacobi,
                            coarse_operator=prob_v.coarsest_operator)
        transformations.assign_cycle_ids(ref_cycle)
        ref = ev_v.evaluate_expression(ref_cycle, key="__reference__")
        pset_v = opt._pset if prob_v is problem else opt._robustness[0][1]
        ind_v = gp.parse_tree(str(best), pset_v)
        expr = gp.compile_tree(ind_v, pset_v)[0]
        transformations.assign_cycle_ids(expr)
        ev = ev_v.evaluate_expression(expr, key=str(best))
        print(f"[evolve-hh] at {tag}: "
              f"reference V(2,1) 0.6: it={ref.iterations:.0f} "
              f"rho={ref.convergence_factor:.4f} | evolved: "
              f"it={ev.iterations:.0f} rho={ev.convergence_factor:.4f}",
              flush=True)
        verdict = ("<=" if ev.iterations <= ref.iterations else ">")
        print(f"[evolve-hh] evolved iterations {verdict} reference "
              f"({ev.iterations:.0f} vs {ref.iterations:.0f}) at {tag}",
              flush=True)


if __name__ == "__main__":
    main()
