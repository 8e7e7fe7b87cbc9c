"""Headline benchmark: stencil DoF/s on the reference V-cycle, on one GPU.

Solves the reference 2D Poisson problem (V-cycle, RB-GS omega=1.15,
2 pre / 1 post — example_problems/Poisson/2D_FD_Poisson_fromL2.exa3) in f32
at 4095^2 (levels 12 -> 5) and reports fine-grid degrees of freedom
processed per second through full V-cycles
(``compiler.solve.make_cycle_loop``: K chained cycles in one program, closed
by ``jax.block_until_ready``).

The same cycle then solves to a 1e-5 relative residual on the device, and
the converged state's residual is checked there.  A run that finds no GPU,
or a GPU without a peak table (prediction.performance), fails.

``vs_baseline`` prices the *same cycle expression* on the reference's own
roofline machine model (6-core AVX2 CPU, 249.6 GFLOP/s, 45.8 GB/s —
reference scripts/optimize.py:79-84) via prediction.performance and reports
measured speedup over that model.

Prints ONE JSON line on stdout; diagnostics go to stderr.
"""

import json
import sys

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()

    from evostencils_tpu.problems.poisson import poisson_2d
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.compiler.lower import lower_cycle
    from evostencils_tpu.compiler.solve import make_solver
    from evostencils_tpu.ir import partitioning as part
    from evostencils_tpu.prediction.performance import (
        PerformanceEvaluator, REFERENCE_CPU, machine_for_device_kind)
    from evostencils_tpu.runtime.profiling import (
        card_description, require_gpu, time_cycle_loop)

    dev = require_gpu()
    machine = machine_for_device_kind(dev.device_kind)
    print(f"[bench] device: {dev.platform} {dev.device_kind} x"
          f"{len(jax.devices())}; card: {card_description()}",
          file=sys.stderr)

    max_level, min_level = 12, 5
    problem = poisson_2d(max_level=max_level, min_level=min_level)
    problem.dtype = np.float32
    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=2, post_smoothing=1, omega=1.15,
                    partitioning=part.RedBlack,
                    coarse_operator=problem.coarsest_operator)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    b = problem.build_rhs()
    omegas = jnp.asarray(lowered.default_omegas, dtype=jnp.float32)

    # --- throughput: K chained cycles per program ----------------------------
    K = 100
    cycle_time, first_s, _ = time_cycle_loop(lowered, b, omegas,
                                             n_cycles=K, reps=5)
    n_dof = int(np.prod(problem.finest_grid[0].size))
    dof_per_s = n_dof / cycle_time
    print(f"[bench] compile+first {K} cycles: {first_s:.1f}s; {n_dof} DoF, "
          f"cycle {cycle_time * 1e3:.4f} ms, {dof_per_s:.4e} DoF/s",
          file=sys.stderr)
    model_s = PerformanceEvaluator(machine).estimate_runtime(cycle)
    print(f"[bench] {machine.name} op-sum roofline (every operation pays "
          f"its own memory traffic): {model_s * 1e3:.4f} ms/cycle, "
          f"measured is {model_s / cycle_time:.3f}x of it", file=sys.stderr)

    # --- convergence on the device: solve to 1e-5 ---------------------------
    solver = make_solver(lowered, max_iterations=50, target_reduction=1e-5)
    u0 = tuple(jnp.zeros_like(x) for x in b)
    u, iters, hist = solver(u0, b, omegas)
    iters = int(iters)
    hist = np.asarray(hist)
    rho = float((hist[iters] / hist[0]) ** (1 / max(iters, 1)))
    print(f"[bench] solve to 1e-5 on the device: {iters} iterations, "
          f"rho={rho:.4f}", file=sys.stderr)
    if not (0 < iters < 50) or not np.isfinite(hist[iters]) \
            or hist[iters] > 1e-5 * hist[0]:
        print("[bench] the device solve did not reach 1e-5 — refusing to "
              "report", file=sys.stderr)
        sys.exit(1)

    # --- reference machine model for the same cycle -------------------------
    ref_cycle_time = PerformanceEvaluator(REFERENCE_CPU).estimate_runtime(cycle)
    vs_baseline = ref_cycle_time / cycle_time
    print(f"[bench] reference CPU roofline cycle: {ref_cycle_time * 1e3:.2f} ms "
          f"-> speedup {vs_baseline:.1f}x", file=sys.stderr)

    print(json.dumps({
        "metric": "poisson2d_4095sq_vcycle_throughput",
        "value": dof_per_s,
        "unit": "DoF/s",
        "vs_baseline": vs_baseline,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
