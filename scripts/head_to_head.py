"""Fresh-process head-to-head: evolved champion(s) vs the reference
V(2,1) baseline, measured INTERLEAVED on the device (a fresh-process
head-to-head with reported spread).

Loads the campaign checkpoint (scripts/evolve_on_device.py), takes the
top-k hall-of-fame individuals by estimated time-to-convergence, compiles
them plus the reference baseline, and measures all of them with the
interleaved slope-fit protocol in THIS one process.

    python scripts/head_to_head.py
"""

import argparse
import math
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=str(pathlib.Path(__file__).resolve()
                                          .parents[1] / ".evolve_ckpt"
                                          / "checkpoint.p"))
    ap.add_argument("--top", type=int, default=3)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()

    import jax
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    print(f"[h2h] device: {jax.devices()[0]}", file=sys.stderr, flush=True)

    from evostencils_tpu.problems.poisson import poisson_2d
    from evostencils_tpu.optimization.program import (
        Optimizer, load_checkpoint_from_file)
    from evostencils_tpu.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu.grammar.multigrid import generate_primitive_set
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.ir import partitioning as part
    from evostencils_tpu.grammar import gp
    from evostencils_tpu.ir import transformations

    problem = poisson_2d(max_level=10, min_level=5)
    problem.dtype = np.float32
    evaluator = CycleEvaluator(problem)
    # final-verdict protocol: LARGE chained windows, so the fixed
    # per-window cost and its jitter are a small share of each window
    evaluator.timing_window_sizes = (2, 8, 32)
    evaluator.timing_window_budget_s = 4.0
    pset, _ = generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)

    cp = load_checkpoint_from_file(args.ckpt)
    cands = list(cp.hof_items or []) + list(cp.population)
    # rank by the checkpointed fitness's estimated time-to-convergence
    epsilon = 1e-20

    def est(ind):
        v = ind.fitness.values
        if len(v) == 2 and v[0] < 1 and v[1] < 1e50:
            return math.log(epsilon) / math.log(max(v[0], 1e-12)) * v[1]
        return float("inf")

    seen, ranked = set(), []
    for ind in sorted(cands, key=est):
        if str(ind) in seen or not np.isfinite(est(ind)):
            continue
        seen.add(str(ind))
        ranked.append(ind)
    ranked = ranked[:args.top]
    print(f"[h2h] checkpoint gen {cp.generation}: testing "
          f"{len(ranked)} champions", flush=True)

    entries = []
    ref_cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                        pre_smoothing=2, post_smoothing=1, omega=1.15,
                        partitioning=part.RedBlack,
                        coarse_operator=problem.coarsest_operator)
    transformations.assign_cycle_ids(ref_cycle)
    entries.append(("reference V(2,1) RB 1.15", ref_cycle))
    for i, ind in enumerate(ranked):
        try:
            tree = gp.parse_tree(str(ind), pset)
            expr = gp.compile_tree(tree, pset)[0]
            transformations.assign_cycle_ids(expr)
            entries.append((f"champion#{i} est={est(ind):.2f}ms", expr))
        except Exception as e:
            print(f"[h2h] champion#{i} failed to rebuild: {e}", flush=True)

    rows = evaluator.measure_interleaved(entries, reps=args.reps)
    ref_t = rows[0]["time_to_convergence_ms"]
    print(f"[h2h] {'structure':38s} {'t_conv ms':>10s} {'rho':>8s} "
          f"{'it':>5s} {'ms/it':>8s} {'spread':>17s}", flush=True)
    for r in rows:
        lo, hi = r["ms_per_iter_spread"]
        print(f"[h2h] {r['key']:38s} {r['time_to_convergence_ms']:10.3f} "
              f"{r['convergence_factor']:8.4f} {r['iterations']:5.0f} "
              f"{r['ms_per_iter']:8.4f} [{lo:.4f},{hi:.4f}]", flush=True)
    best = min(rows[1:], key=lambda r: r["time_to_convergence_ms"],
               default=None)
    if best is not None:
        verdict = ("BEATS" if best["time_to_convergence_ms"] < ref_t
                   else "does NOT beat")
        print(f"[h2h] best champion {verdict} the reference "
              f"({best['time_to_convergence_ms']:.3f} vs {ref_t:.3f} ms), "
              f"interleaved in one process", flush=True)


if __name__ == "__main__":
    main()
