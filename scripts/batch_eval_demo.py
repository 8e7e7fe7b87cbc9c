"""64 evolved cycles batch-evaluated on 3D Poisson — BASELINE.json
config 5, on one device.

The reference evaluates every individual as its own generated C++ binary
(reference optimization/program.py:924 measurement loop); here the
population is grouped by cycle STRUCTURE and each group runs as ONE
vmapped device program over the members' relaxation-factor vectors
(evaluation/evaluator.py:evaluate_population), so 64 candidates cost a
handful of compiles + a handful of batched launches.  The multi-process
fan-out of the same path is exercised on the virtual mesh by
tests/test_multihost.py.

    python scripts/batch_eval_demo.py
"""

import pathlib
import random
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--max-level", type=int, default=6)
    ap.add_argument("--min-level", type=int, default=2)
    ap.add_argument("--canonicalize", action="store_true",
                    help="merge structures differing only in smoother "
                         "sweep counts into shared programs "
                         "(compiler/canonical.py)")
    args = ap.parse_args()

    import jax
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    print(f"[batch] device: {jax.devices()[0]}", file=sys.stderr, flush=True)

    from evostencils_tpu.problems.poisson import poisson_3d
    from evostencils_tpu.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu.grammar.multigrid import generate_primitive_set
    from evostencils_tpu.grammar import gp

    # the reference's 3D configuration is 64^3, levels 2->6
    # (Poisson/3D_FD_Poisson_fromL2.knowledge:4-5)
    problem = poisson_3d(max_level=args.max_level, min_level=args.min_level)
    problem.dtype = np.float32
    evaluator = CycleEvaluator(problem)
    # compiles run in the remote compile service; local threads only wait,
    # so a wider pool overlaps more of the per-structure latency
    evaluator.compile_workers = 8
    evaluator.canonicalize = args.canonicalize
    pset, _ = generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)

    rng = random.Random(7)
    N = args.n
    pop = [gp.genGrow(pset, 0, 50, rng=rng) for _ in range(N)]

    t0 = time.perf_counter()
    results = evaluator.evaluate_population(pop, pset)
    wall = time.perf_counter() - t0

    finite = [r for r in results if np.isfinite(r.time_to_convergence_ms)]
    structures = evaluator.compilations
    print(f"[batch] {N} individuals in {wall:.1f}s wall "
          f"({wall / N:.2f}s/individual amortized), "
          f"{structures} structures compiled, "
          f"{len(finite)}/{N} finite fitness", flush=True)
    if args.canonicalize and getattr(evaluator, "canonical_collapse", None):
        keys, programs = evaluator.canonical_collapse
        print(f"[batch] canonicalization: {keys} structure keys -> "
              f"{programs} programs "
              f"({keys / max(programs, 1):.2f} structures/program)",
              flush=True)
    if finite:
        best = min(finite, key=lambda r: r.time_to_convergence_ms)
        print(f"[batch] best: t_conv={best.time_to_convergence_ms:.3f} ms "
              f"rho={best.convergence_factor:.4f} "
              f"it={best.iterations}", flush=True)
    else:
        print("[batch] ERROR: no finite fitness in the population",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
