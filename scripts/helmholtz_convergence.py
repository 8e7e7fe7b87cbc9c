"""Helmholtz k/2k/4k robustness at the REFERENCE size (levels 3->7,
k = 80 schedule) — the reference's generalization/robustness protocol
(reference scripts/optimize.py:33-37, code_generation/exastencils.py:518-532,
example_problems/Helmholtz/2D_FD_Helmholtz_fromL3.exa3:144-212).

Solves A u = f (A = -Lap - k^2 with Robin x-boundaries) by BiCGStab
preconditioned with one shifted-Laplace MG V-cycle per application, to the
reference target 1e-7.  Runs both formulations:

* complex (complex64/128 program, on the CPU)
* split-complex 2x2 real system (the device form)

Usage:
    python scripts/helmholtz_convergence.py [--device]
"""

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def run_case(problem, build, tag, maxiter=5000):
    import jax
    import jax.numpy as jnp
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.compiler.lower import lower_cycle, operator_applier
    from evostencils_tpu.ir import partitioning as part
    from evostencils_tpu.ir import smoother
    from evostencils_tpu.ops.solvers import (preconditioned_bicgstab,
                                             preconditioned_bicgstab_split)

    cyc = v_cycle(problem.level_contexts, problem.rhs_entity,
                  pre_smoothing=2, post_smoothing=1, omega=0.6,
                  partitioning=part.RedBlack,
                  smoother_factory=smoother.generate_collective_jacobi,
                  coarse_operator=problem.coarsest_operator)
    low = lower_cycle(cyc, problem.approximation, problem.rhs_entity)
    om = jnp.asarray(low.default_omegas)
    b = build()
    mv = operator_applier(problem.outer_solver.operator)
    split = getattr(problem.outer_solver, "split", False)
    solver = preconditioned_bicgstab_split if split \
        else preconditioned_bicgstab

    def precond(fields):
        zero = tuple(jnp.zeros_like(f) for f in fields)
        return low.step(zero, fields, om)

    t0 = time.perf_counter()
    x, k, hist = solver(mv, precond, b, tol=1e-7, maxiter=maxiter,
                        history_size=0)
    k = int(k)
    wall = time.perf_counter() - t0
    hist = np.asarray(jax.device_get(hist))
    r0 = hist[0]
    # final relative residual via one more matvec
    ax = mv(x)
    rr = np.sqrt(sum(float(jnp.sum(jnp.abs(bb - aa) ** 2))
                     for bb, aa in zip(b, ax)))
    rel = rr / max(r0, 1e-300)
    rho = (rel) ** (1.0 / max(k, 1))
    conv = "ok" if rel <= 1.1e-7 and k < maxiter else "NOT CONVERGED"
    print(f"[helmholtz] {tag}: iters={k} rel_res={rel:.2e} "
          f"rho={rho:.3f} wall={wall:.1f}s {conv}", flush=True)
    return k, rel


def run_case_df64(problem, build, tag, maxiter=5000, segment=40):
    """The f32 split solve under df64 reliable residual updates
    (compiler/refine_split.py): x accumulates as a double-float pair and
    the recurrence residual is periodically replaced by the TRUE df64
    residual — the f32 device form of the reference's f64 1e-7
    protocol."""
    import jax
    import jax.numpy as jnp
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.compiler.lower import lower_cycle, operator_applier
    from evostencils_tpu.compiler.refine_split import (
        split_system_residual_df, reliable_bicgstab_split)
    from evostencils_tpu.ir import partitioning as part
    from evostencils_tpu.ir import smoother

    cyc = v_cycle(problem.level_contexts, problem.rhs_entity,
                  pre_smoothing=2, post_smoothing=1, omega=0.6,
                  partitioning=part.RedBlack,
                  smoother_factory=smoother.generate_collective_jacobi,
                  coarse_operator=problem.coarsest_operator)
    low = lower_cycle(cyc, problem.approximation, problem.rhs_entity)
    om = jnp.asarray(low.default_omegas, jnp.float32)
    b = build()
    mv = operator_applier(problem.outer_solver.operator)
    residual_df = split_system_residual_df(problem.outer_solver.operator)

    def precond(fields):
        zero = tuple(jnp.zeros_like(f) for f in fields)
        return low.step(zero, fields, om)

    t0 = time.perf_counter()
    x_hi, x_lo, k, hist = reliable_bicgstab_split(
        mv, precond, residual_df, b, tol=1e-7, maxiter=maxiter,
        segment=segment)
    wall = time.perf_counter() - t0
    rel = hist[-1]
    rho = rel ** (1.0 / max(k, 1))
    conv = "ok" if rel <= 1.1e-7 and k < maxiter else "NOT CONVERGED"
    print(f"[helmholtz] {tag} (df64 reliable): iters={k} "
          f"true_rel_res={rel:.2e} rho={rho:.3f} wall={wall:.1f}s {conv}",
          flush=True)
    return k, rel


def run_case_df64_basis(problem, build, tag, maxiter=10000, segment=100):
    """The FULL df64-recurrence BiCGStab (compiler/refine_split.py
    df64_basis_bicgstab_split): vectors, dots, scalars and matvec all in
    double-float words; only the V-cycle preconditioner stays f32.  The
    r4-verdict experiment for the k=320 device cell."""
    import jax
    import jax.numpy as jnp
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.compiler.lower import lower_cycle
    from evostencils_tpu.compiler.refine_split import (
        split_system_residual_df, split_system_matvec_df,
        df64_basis_bicgstab_split)
    from evostencils_tpu.ir import partitioning as part
    from evostencils_tpu.ir import smoother

    cyc = v_cycle(problem.level_contexts, problem.rhs_entity,
                  pre_smoothing=2, post_smoothing=1, omega=0.6,
                  partitioning=part.RedBlack,
                  smoother_factory=smoother.generate_collective_jacobi,
                  coarse_operator=problem.coarsest_operator)
    low = lower_cycle(cyc, problem.approximation, problem.rhs_entity)
    om = jnp.asarray(low.default_omegas, jnp.float32)
    b = build()
    matvec_df = split_system_matvec_df(problem.outer_solver.operator)
    residual_df = split_system_residual_df(problem.outer_solver.operator)

    def precond(fields):
        zero = tuple(jnp.zeros_like(f) for f in fields)
        return low.step(zero, fields, om)

    t0 = time.perf_counter()
    x_hi, x_lo, k, hist = df64_basis_bicgstab_split(
        matvec_df, precond, residual_df, b, tol=1e-7, maxiter=maxiter,
        segment=segment, verbose=True)
    wall = time.perf_counter() - t0
    rel = hist[-1]
    rho = rel ** (1.0 / max(k, 1))
    conv = "ok" if rel <= 1.1e-7 and k < maxiter else "NOT CONVERGED"
    print(f"[helmholtz] {tag} (df64 BASIS): iters={k} "
          f"true_rel_res={rel:.2e} rho={rho:.3f} wall={wall:.1f}s {conv}",
          flush=True)
    return k, rel


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", action="store_true",
                        help="run the split-complex cases on the default "
                             "device instead of forcing CPU")
    parser.add_argument("--df64", action="store_true",
                        help="solve the split cases with df64 reliable "
                             "residual updates to the TRUE 1e-7 target "
                             "(f32 arithmetic; device-executable)")
    parser.add_argument("--df64-basis", action="store_true",
                        help="full df64-recurrence BiCGStab (vectors, "
                             "dots, scalars, matvec in double-float; "
                             "f32 preconditioner)")
    parser.add_argument("--ks", type=float, nargs="*", default=None)
    parser.add_argument("--maxiter", type=int, default=10000,
                        help="outer iteration cap (reference: 10000)")
    parser.add_argument("--max-level", type=int, default=7)
    parser.add_argument("--min-level", type=int, default=3)
    args = parser.parse_args()
    import os
    if not args.device:
        # the convergence study runs on the CPU (physics, not device
        # timing)
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    if not args.device:
        # the reference's protocol is f64 C++; f32 BiCGStab recurrence
        # residuals drift from the true residual at ~1e-5 relative on
        # this indefinite operator (measured), so the convergence study
        # runs in f64.  The device (f32-only) run reports iteration
        # counts with the drift caveat.
        jax.config.update("jax_enable_x64", True)
    print(f"[helmholtz] device: {jax.devices()[0]}", file=sys.stderr)
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    if args.df64 or args.df64_basis:
        # f32 contractions may run at reduced precision on an
        # accelerator (TF32 on the GPU); the BiCGStab recurrence then sees
        # an operator accurate to only ~1e-3 and stalls before diverging
        # — HIGHEST keeps true-f32 contractions
        jax.config.update("jax_default_matmul_precision", "highest")

    from evostencils_tpu.problems.helmholtz import (helmholtz_2d,
                                                    helmholtz_2d_split)
    for k in (args.ks or (80.0, 160.0, 320.0)):
        if not args.device and not args.df64 and not args.df64_basis:
            pc = helmholtz_2d(max_level=args.max_level,
                              min_level=args.min_level, k=k)
            run_case(pc, pc.build_rhs, f"complex  k={k:.0f} "
                     f"levels {args.min_level}->{args.max_level}")
        ps = helmholtz_2d_split(max_level=args.max_level,
                                min_level=args.min_level, k=k)
        if args.df64_basis:
            ps.dtype = np.float32
            run_case_df64_basis(ps, lambda p=ps: p.rhs_builder(np.float32),
                                f"split    k={k:.0f} levels "
                                f"{args.min_level}->{args.max_level}",
                                maxiter=args.maxiter)
        elif args.df64:
            ps.dtype = np.float32
            run_case_df64(ps, lambda p=ps: p.rhs_builder(np.float32),
                          f"split    k={k:.0f} levels "
                          f"{args.min_level}->{args.max_level}",
                          maxiter=args.maxiter)
        else:
            dt = np.float32 if args.device else np.float64
            run_case(ps, lambda p=ps: p.rhs_builder(dt),
                     f"split    k={k:.0f} levels "
                     f"{args.min_level}->{args.max_level}")


if __name__ == "__main__":
    main()
