"""Deep-convergence validation on hardware: df64 iterative refinement.

Runs the reference's deep-residual protocol ON THE DEVICE:
- 2D Poisson to 1e-12 relative residual (reference
  scripts/evaluate_reference_solver.py f64 protocol);
- FAS_2D_Basic to 1e-10 relative residual (reference FAS knowledge file);
both with f32-only device arithmetic (compiler/refine: df64 words +
native f32 V-cycle corrections), residual norms measured in f64 on host.

Also cross-checks the f32 evaluator's log(eps)/log(rho) extrapolation
(evaluation/evaluator.py) against the actually-measured deep iteration
counts.
"""

import argparse
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--max-level", type=int, default=10)
    parser.add_argument("--fas-max-level", type=int, default=8)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"

    import numpy as np
    import jax
    import jax.numpy as jnp
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()

    from evostencils_tpu.compiler.cycles import v_cycle, fas_v_cycle
    from evostencils_tpu.compiler.lower import lower_cycle
    from evostencils_tpu.compiler.refine import make_refined_solver
    from evostencils_tpu.ir import partitioning as part, base, system
    from evostencils_tpu.problems.poisson import poisson_2d
    from evostencils_tpu.problems.fas import fas_2d_basic
    from evostencils_tpu.problems.api import scalar_hierarchy
    from evostencils_tpu.stencils import gallery

    print(f"[deep] device: {jax.devices()[0]}", file=sys.stderr)

    # ---- 2D Poisson to 1e-12 ----------------------------------------------
    ml = args.max_level
    problem = poisson_2d(max_level=ml, min_level=max(ml - 6, 2))
    problem.dtype = np.float32
    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=2, post_smoothing=1, omega=1.15,
                    partitioning=part.RedBlack,
                    coarse_operator=problem.coarsest_operator)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    solve = make_refined_solver(lowered, inner_cycles=8,
                                target_reduction=1e-12)
    b = jnp.asarray(problem.build_rhs()[0], dtype=jnp.float32)
    t0 = time.perf_counter()
    res = solve(b)
    t = time.perf_counter() - t0
    rels = [r / res.residuals[0] for r in res.residuals]
    print(f"[deep] poisson2d {2**ml - 1}^2: converged={res.converged} "
          f"outer={res.outer_iterations} time={t:.2f}s", file=sys.stderr)
    print("[deep]   rel residuals: "
          + "  ".join(f"{r:.3e}" for r in rels), file=sys.stderr)
    # extrapolation cross-check: total fine cycles vs log(eps)/log(rho)
    inner_total = 8 * (res.outer_iterations - 1)
    rho_implied = (rels[-1]) ** (1.0 / max(inner_total, 1))
    print(f"[deep]   {inner_total} f32 V-cycles to 1e-12 => implied "
          f"rho {rho_implied:.4f} (f32 bench extrapolates from rho "
          f"measured over 4 cycles)", file=sys.stderr)

    # ---- same solve with bf16 inner cycles (mixed-precision MG) -----------
    # bf16 storage moves half the bytes of f32 per cycle
    bf_solve = make_refined_solver(lowered, inner_cycles=3, max_outer=16,
                                   target_reduction=1e-12,
                                   inner_dtype=jnp.bfloat16)
    t0 = time.perf_counter()
    bres = bf_solve(b)
    tb = time.perf_counter() - t0
    brels = [r / bres.residuals[0] for r in bres.residuals]
    print(f"[deep] poisson2d bf16-inner: converged={bres.converged} "
          f"outer={bres.outer_iterations} time={tb:.2f}s "
          f"({3 * (bres.outer_iterations - 1)} bf16 V-cycles)",
          file=sys.stderr)
    print("[deep]   rel residuals: "
          + "  ".join(f"{r:.3e}" for r in brels), file=sys.stderr)

    # ---- FAS to 1e-10 ------------------------------------------------------
    fml = args.fas_max_level
    fmin = max(fml - 4, 2)
    fas = fas_2d_basic(max_level=fml, min_level=fmin)
    fas.dtype = np.float32
    fcycle = fas_v_cycle(fas.level_contexts, fas.rhs_entity,
                         coarse_operator=fas.coarsest_operator)
    flow = lower_cycle(fcycle, fas.approximation, fas.rhs_entity)
    gen = gallery.ShiftedOperatorGenerator(gallery.Poisson2D(), 20.0)
    ctxs, coarsest = scalar_hierarchy("Ashift", 2, fml, fmin, gen)
    rhs_e = system.RightHandSide("f",
                                 [base.RightHandSide("f", ctxs[0].grid[0])])
    lin_cycle = v_cycle(ctxs, rhs_e, pre_smoothing=2, post_smoothing=1,
                        omega=1.0, partitioning=part.RedBlack,
                        coarse_operator=coarsest)
    corr = lower_cycle(lin_cycle, ctxs[0].approximation, rhs_e)
    fsolve = make_refined_solver(flow, inner_cycles=3, max_outer=10,
                                 target_reduction=1e-10,
                                 richardson_iterations=3,
                                 nonlinear=fas.level_contexts[0].operator,
                                 correction_lowered=corr)
    fb = jnp.asarray(fas.build_rhs()[0], dtype=jnp.float32)
    t0 = time.perf_counter()
    fres = fsolve(fb)
    t = time.perf_counter() - t0
    frels = [r / fres.residuals[0] for r in fres.residuals]
    print(f"[deep] fas2d {2**fml - 1}^2: converged={fres.converged} "
          f"outer={fres.outer_iterations} time={t:.2f}s", file=sys.stderr)
    print("[deep]   rel residuals: "
          + "  ".join(f"{r:.3e}" for r in frels), file=sys.stderr)

    ok = res.converged and fres.converged and bres.converged
    print(f'{{"poisson_1e12": {str(res.converged).lower()}, '
          f'"poisson_1e12_bf16_inner": {str(bres.converged).lower()}, '
          f'"fas_1e10": {str(fres.converged).lower()}}}')
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
