"""Smoke run of the system's main paths on NVIDIA GPUs.

    python chip_smoke.py          # one GPU: solve, families and search
    python chip_smoke.py --four   # four GPUs of one host: the mesh paths

Every phase prints its own lines and raises on any failed check, so the
script exits nonzero unless all of them pass.  JAX's first device must be a
GPU: there is no CPU fallback.  The last line of standard output is one
JSON object, ``{"ok": true, "device": {...}}``.

Phases (one GPU):

* solve — the reference 2D Poisson V(2,1) RB-GS omega=1.15 f32 cycle at
  4095^2 (levels 12 -> 5, as bench.py) and 3D Poisson at 255^3, each solved
  to a 1e-5 relative residual through ``make_solver`` on the device and
  compared with the same cycle solved in float64 on the host CPU backend of
  this process.  Information lines: ms/cycle, DoF/s, and the bytes/s of one
  plain RB-GS sweep against the card's bandwidth.
* families — variable-coefficient Poisson, elasticity and split-complex
  Helmholtz (preconditioned BiCGStab) at 2047^2 and FAS at 1023^2 run a few
  iterations on the device; each is compared with the CPU float64
  reference at a search size (255^2), where both can run.
* search — a seeded G3P search (poisson2d, levels 9 -> 5, f32, mu=lambda=8,
  2 generations) with measured device fitness; every fitness is finite.

With ``--four``: the shard_map/ppermute halo-pipeline V-cycle at 4095^2 on a
2x2 mesh, and the population-sharded batched evaluation, each compared with
the same computation on one card.
"""

import argparse
import json
import random
import sys
import tempfile
import time

import numpy as np

#: solve phase: f32 device solve against the CPU float64 reference.
#: Iterations may differ by one where the residual crosses 1e-5 between
#: two cycles.  rho (see compare) within 5%: f32 rounding moves the
#: per-cycle reduction by far less.  The solution within 1e-3 of
#: max|u|: both sit within ~rho^k ~ 1e-5..1e-4 of the discrete solution,
#: and the f32 fixed point drifts ~1e-4 in low-frequency modes over tens of
#: cycles.
ITER_TOL = 1
RHO_RTOL = 0.05
SOL_RTOL = 1e-3


class CheckFailed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def log(msg):
    print(msg, flush=True)


def rho_over(hist, m):
    """Mean per-iteration residual reduction over the first m iterations."""
    m = max(int(m), 1)
    return float((hist[m] / hist[0]) ** (1.0 / m))


def max_rel_diff(a_fields, b_fields):
    scale = max(float(np.max(np.abs(b))) for b in b_fields) or 1.0
    return max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for a, b in zip(a_fields, b_fields)) / scale


def compare(name, dev, ref, *, iter_tol=ITER_TOL, rho_rtol=RHO_RTOL,
            sol_rtol=SOL_RTOL):
    """Gate a device solve ``dev`` against the reference solve ``ref``;
    each is ``(solution fields as numpy, iterations, residual history)``."""
    u_d, k_d, h_d = dev
    u_r, k_r, h_r = ref
    check(np.all(np.isfinite(h_d[:k_d + 1])), f"{name}: non-finite residual")
    # rho over the common iterations but the last: the last one ends next
    # to the 1e-5 target, where the f32 residual itself carries rounding
    # noise of that order (b - Au cancels terms ~4/h^2 larger than b), so
    # its ratio measures f32 evaluation, not the cycle
    m = max(min(k_d, k_r) - 1, 1)
    rho_d, rho_r = rho_over(h_d, m), rho_over(h_r, m)
    err = max_rel_diff(u_d, u_r)
    log(f"[{name}] iterations device {k_d} / reference {k_r}; rho over "
        f"{m}: device {rho_d:.6f} / reference {rho_r:.6f}; solution max "
        f"relative difference {err:.3e}")
    check(abs(k_d - k_r) <= iter_tol,
          f"{name}: iterations {k_d} vs {k_r} (tolerance {iter_tol})")
    check(abs(rho_d - rho_r) <= rho_rtol * rho_r,
          f"{name}: rho {rho_d} vs {rho_r} (tolerance {rho_rtol:.0%})")
    check(err <= sol_rtol,
          f"{name}: solution difference {err:.3e} > {sol_rtol:.0e}")


# ---------------------------------------------------------------------------
# problems and cycles
# ---------------------------------------------------------------------------

def v21(problem, omega=1.15, partitioning=None):
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.ir import partitioning as part
    return v_cycle(problem.level_contexts, problem.rhs_entity,
                   pre_smoothing=2, post_smoothing=1, omega=omega,
                   partitioning=partitioning or part.RedBlack,
                   coarse_operator=problem.coarsest_operator)


def jacobi_v(problem):
    from evostencils_tpu.ir import partitioning as part
    return v21(problem, omega=0.8, partitioning=part.Single)


def fas_v(problem):
    from evostencils_tpu.compiler.cycles import fas_v_cycle
    return fas_v_cycle(problem.level_contexts, problem.rhs_entity,
                       coarse_operator=problem.coarsest_operator)


def family_specs():
    """(name, factory(max_level), cycle builder, device level, reference
    level) per family of scripts/bench_suite.py beyond plain Poisson."""
    from evostencils_tpu.problems import elasticity, fas, helmholtz, poisson
    return [
        ("poisson2d_var", lambda hi: poisson.poisson_2d_variable(hi, 5),
         jacobi_v, 11, 8),
        ("elasticity2d", lambda hi: elasticity.linear_elasticity_2d(hi, 4),
         lambda p: v21(p, omega=1.25), 11, 8),
        ("helmholtz2d_split",
         lambda hi: helmholtz.helmholtz_2d_split(max_level=hi, min_level=3),
         lambda p: v21(p, omega=0.6), 11, 8),
        ("fas2d", lambda hi: fas.fas_2d_basic(max_level=hi, min_level=6),
         fas_v, 10, 8),
    ]


def evaluator_solve(problem, cycle, dtype, *, max_iterations,
                    target=1e-30, device=None):
    """One solve through the measured-fitness path (CycleEvaluator), on
    ``device`` (default: JAX's first device) in ``dtype``.  Returns
    ``(solution as numpy, iterations, residual history, seconds of a
    second, compiled run)``."""
    import jax
    from evostencils_tpu.evaluation.evaluator import CycleEvaluator
    x64 = np.dtype(dtype) == np.float64
    device = device or jax.devices()[0]
    with jax.default_device(device), jax.enable_x64(x64):
        ev = CycleEvaluator(problem, dtype=dtype,
                            max_iterations=max_iterations,
                            target_reduction=target)
        u, k, hist = ev.solve(cycle, key="smoke")
        jax.block_until_ready(u)
        t0 = time.perf_counter()
        jax.block_until_ready(ev.solve(cycle, key="smoke")[0])
        seconds = time.perf_counter() - t0
        return tuple(np.asarray(x) for x in u), k, hist, seconds


def cpu_reference(lowered, problem, target, max_iterations):
    """The same lowered cycle solved in float64 on the host CPU backend."""
    import jax
    import jax.numpy as jnp
    from evostencils_tpu.compiler.solve import make_solver
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.enable_x64(True):
        problem.dtype = np.float64
        b = problem.build_rhs()
        u0 = tuple(jnp.zeros_like(x) for x in b)
        om = jnp.asarray(lowered.default_omegas, jnp.float64)
        run = make_solver(lowered, max_iterations, target)
        u, k, hist = run(u0, b, om)
        return tuple(np.asarray(x) for x in u), int(k), np.asarray(hist)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def solve_case(name, problem_fn, levels, machine, *, target=1e-5,
               max_iterations=50):
    """Solve-phase case: device f32 solve + throughput + sweep bandwidth,
    then the CPU float64 reference at the same size (6-7 s on the
    host's CPU at 4095^2 and 255^3)."""
    import jax
    import jax.numpy as jnp
    from evostencils_tpu.compiler.cycles import smooth
    from evostencils_tpu.compiler.lower import lower_cycle
    from evostencils_tpu.compiler.solve import make_solver
    from evostencils_tpu.ir import partitioning as part
    from evostencils_tpu.runtime.profiling import time_cycle_loop

    problem = problem_fn(*levels)
    problem.dtype = np.float32
    lowered = lower_cycle(v21(problem), problem.approximation,
                          problem.rhs_entity)
    b = problem.build_rhs()
    om = jnp.asarray(lowered.default_omegas, jnp.float32)
    n_dof = int(np.prod(problem.finest_grid[0].size))
    shape = "x".join(str(n) for n in problem.finest_grid[0].size)

    t0 = time.perf_counter()
    run = make_solver(lowered, max_iterations, target)
    u0 = tuple(jnp.zeros_like(x) for x in b)
    u, k, hist = jax.block_until_ready(run(u0, b, om))
    first_s = time.perf_counter() - t0
    k, hist = int(k), np.asarray(hist)
    check(0 < k < max_iterations and np.isfinite(hist[k])
          and hist[k] <= target * hist[0],
          f"{name}: device solve did not reach {target:g} in "
          f"{max_iterations} iterations (k={k}, r_k/r_0="
          f"{hist[k] / hist[0]:.3e})")
    dev = (tuple(np.asarray(x) for x in u), k, hist)
    log(f"[{name}] {shape} f32 device solve: {k} iterations to "
        f"{target:g}, compile+first solve {first_s:.1f} s")

    cycle_s, loop_first_s, _ = time_cycle_loop(lowered, b, om, n_cycles=50)
    log(f"[{name}] info: {cycle_s * 1e3:.4f} ms/cycle, "
        f"{n_dof / cycle_s:.4e} DoF/s (50 chained cycles, best of 3; "
        f"compile+first {loop_first_s:.1f} s)")
    sweep = smooth((problem.approximation, problem.rhs_entity),
                   problem.level_contexts[0], 1.15, part.RedBlack)[0]
    sweep_low = lower_cycle(sweep, problem.approximation, problem.rhs_entity)
    sweep_s, _, _ = time_cycle_loop(
        sweep_low, b, jnp.asarray(sweep_low.default_omegas, jnp.float32),
        n_cycles=100)
    # least traffic of one full RB-GS sweep: read u and b, write u
    sweep_bytes = 3 * n_dof * 4
    log(f"[{name}] info: plain RB-GS sweep {sweep_s * 1e3:.4f} ms, "
        f"{sweep_bytes / sweep_s / 1e9:.1f} GB/s of least traffic (read u, "
        f"b; write u) = {sweep_bytes / sweep_s / machine.bandwidth:.1%} of "
        f"{machine.bandwidth / 1e12:.2f} TB/s")

    t0 = time.perf_counter()
    ref = cpu_reference(lowered, problem, target, max_iterations)
    log(f"[{name}] CPU float64 reference solve: {time.perf_counter() - t0:.1f} s")
    compare(name, dev, ref)


def phase_solve(machine, *, level_2d=(12, 5), level_3d=(8, 2)):
    from evostencils_tpu.problems.poisson import poisson_2d, poisson_3d
    solve_case("poisson2d", poisson_2d, level_2d, machine)
    solve_case("poisson3d", poisson_3d, level_3d, machine)


def phase_families(*, iterations=5, device_levels=None, ref_levels=None):
    import jax
    for name, factory, cycle_fn, dev_level, ref_level in family_specs():
        dev_level = (device_levels or {}).get(name, dev_level)
        ref_level = (ref_levels or {}).get(name, ref_level)
        p = factory(dev_level)
        u, k, hist, secs = evaluator_solve(p, cycle_fn(p), np.float32,
                                           max_iterations=iterations)
        n = p.finest_grid[0].size
        check(k > 0 and np.all(np.isfinite(hist[:k + 1]))
              and all(np.all(np.isfinite(x)) for x in u),
              f"{name}: non-finite values at {n}")
        check(hist[k] < hist[0], f"{name}: residual did not decrease at {n}")
        log(f"[{name}] {n[0]}x{n[1]} f32 device: {k} iterations, "
            f"r_k/r_0={hist[k] / hist[0]:.3e}, info: "
            f"{secs / k * 1e3:.3f} ms/iteration (with its residual check)")
        p_d, p_r = factory(ref_level), factory(ref_level)
        dev = evaluator_solve(p_d, cycle_fn(p_d), np.float32,
                              max_iterations=iterations)[:3]
        ref = evaluator_solve(p_r, cycle_fn(p_r), np.float64,
                              max_iterations=iterations,
                              device=jax.devices("cpu")[0])[:3]
        # fixed iteration budget: the f32 run may stop at its 1e-5 floor
        # earlier, so only the common iterations are compared
        compare(f"{name}@{2 ** ref_level - 1}", dev, ref,
                iter_tol=iterations)


def phase_search(*, levels=(9, 5), mu=8, lam=8, generations=2, seed=0):
    from evostencils_tpu.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu.optimization.program import Optimizer
    from evostencils_tpu.problems.poisson import poisson_2d
    problem = poisson_2d(*levels)
    problem.dtype = np.float32
    evaluator = CycleEvaluator(problem)
    records = []
    evaluate = evaluator.evaluate_population

    def recording(individuals, pset):
        results = evaluate(individuals, pset)
        records.extend(zip(results, evaluator.last_timings))
        return results

    evaluator.evaluate_population = recording
    with tempfile.TemporaryDirectory(dir=".") as ckpt:
        t0 = time.perf_counter()
        result = Optimizer(problem, evaluator=evaluator,
                           checkpoint_directory_path=ckpt,
                           rng=random.Random(seed)).evolutionary_optimization(
            mu_=mu, lambda_=lam, generations=generations, verbose=False)
        wall = time.perf_counter() - t0
    for i, (res, t) in enumerate(records):
        t = t or {}
        log(f"[search] individual {i}: compile {t.get('compile_s', 0):.2f} s,"
            f" run {t.get('run_s', 0):.2f} s (group of "
            f"{t.get('group_size', 0)}), rho={res.convergence_factor:.4g}")
    fitness = [v for pop in result["populations"] for ind in pop
               for v in ind.fitness.values]
    converged = sum(r.iterations < 1e100 for r, _ in records)
    log(f"[search] {len(records)} evaluations in {wall:.1f} s, "
        f"{evaluator.compilations} structures compiled, {converged} "
        f"converged; best {result['best_individual'].fitness.values}")
    check(records and fitness and np.all(np.isfinite(fitness)),
          "search: a fitness is not finite")
    check(not evaluator.run_failures,
          f"search: solves raised {evaluator.run_failures[:3]}")
    check(converged > 0, "search: no individual converged")


def phase_four(devices, *, level=(12, 5), pop_level=(9, 5), pop=16,
               n_cycles=3):
    """The two paths of __graft_entry__.dryrun_multichip on ``devices``
    (a 2x2 mesh), each compared with the same computation on one card."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import (_build_poisson_cycle, population_fitness,
                                 sharded_vcycles)
    check(len(devices) == 4, f"--four needs 4 devices, found {len(devices)}")
    t0 = time.perf_counter()
    sharded = sharded_vcycles(devices, *level, n_cycles=n_cycles)
    log(f"[four] halo-pipeline V-cycle x{n_cycles} at "
        f"{2 ** level[0] - 1}^2 on a 2x2 mesh: {time.perf_counter() - t0:.1f}"
        f" s with compile")
    lowered, u, b, om = _build_poisson_cycle(*level, jnp.float32)
    step = jax.jit(lowered.step)
    for i in range(n_cycles):
        u = step(u, b, om)
        err = max_rel_diff((sharded[i],), (np.asarray(u[0]),))
        log(f"[four] halo pipeline vs one card after cycle {i + 1}: max "
            f"relative difference {err:.3e}")
        # f32 sums are taken in another order across the halo seams.  After
        # one cycle that is rounding (3.5e-7 at 1023^2 on virtual CPU
        # devices); later cycles amplify it in the low-frequency modes
        # about 4x per level of refinement (2.8e-6, 4.5e-6, 1.7e-5 after
        # three cycles at 255^2, 511^2, 1023^2), up to the f32 fixed-point
        # drift that the solve phase bounds by SOL_RTOL
        tol = 1e-5 if i == 0 else SOL_RTOL
        check(err <= tol, f"four: halo pipeline differs from one card by "
                          f"{err:.3e} after cycle {i + 1} (tolerance {tol})")

    fit_sharded = np.asarray(population_fitness(devices, *pop_level, pop))
    fit_single = np.asarray(population_fitness(devices[:1], *pop_level, pop))
    err = float(np.max(np.abs(fit_sharded - fit_single)
                       / np.maximum(np.abs(fit_single), 1e-30)))
    log(f"[four] population-sharded evaluation of {pop} individuals at "
        f"{2 ** pop_level[0] - 1}^2 vs one card: max relative difference "
        f"{err:.3e}")
    check(np.all(np.isfinite(fit_sharded)) and err <= 1e-5,
          f"four: sharded fitness differs from one card by {err:.3e}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run the four-card mesh paths instead")
    args = parser.parse_args(argv)

    import jax
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's first device is {dev.platform} "
              f"({dev.device_kind}); a GPU is required", file=sys.stderr)
        return 2
    from evostencils_tpu.config import enable_persistent_compilation_cache
    from evostencils_tpu.prediction.performance import machine_for_device_kind
    from evostencils_tpu.runtime.profiling import card_description
    enable_persistent_compilation_cache()
    log(f"device: {dev.platform} {dev.device_kind}, count {len(devices)}")
    log(f"card: {card_description()}")
    machine = machine_for_device_kind(dev.device_kind)

    t_start = time.perf_counter()
    if args.four:
        phases = [("four", lambda: phase_four(devices[:4]))]
    else:
        phases = [("solve", lambda: phase_solve(machine)),
                  ("families", phase_families),
                  ("search", phase_search)]
    for name, phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"phase {name} passed in {time.perf_counter() - t0:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
