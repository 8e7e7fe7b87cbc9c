"""Device wall-clock verdict for the Helmholtz evolution winner:
evolved preconditioner vs the reference V(2,1) collective RB 0.6,
measured as FULL outer solves to TRUE 1e-7 on the device (df64-basis
BiCGStab, compiler/refine_split.py), ALTERNATED within one process so
drift in the device's clocks hits both equally.

    python scripts/h2h_helmholtz_device.py \
        --ks 80 160 --reps 3
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ks", type=float, nargs="*", default=[80.0, 160.0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=10000)
    ap.add_argument("--champion-key",
                    default="helmholtz_split_k80_robust_gen20")
    ap.add_argument("--champion-index", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    jax.config.update("jax_default_matmul_precision", "highest")
    print(f"[hh-dev] device: {jax.devices()[0]}", file=sys.stderr,
          flush=True)

    from evostencils_tpu.problems.helmholtz import helmholtz_2d_split
    from evostencils_tpu.grammar.multigrid import generate_primitive_set
    from evostencils_tpu.grammar import gp
    from evostencils_tpu.ir import partitioning as part
    from evostencils_tpu.ir import smoother, transformations
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.compiler.lower import lower_cycle
    from evostencils_tpu.compiler.refine_split import (
        split_system_residual_df, split_system_matvec_df,
        df64_basis_bicgstab_split)

    champions = json.loads(
        (ROOT / "results" / "evolved_champions.json").read_text())
    grammar = champions[args.champion_key][args.champion_index]["grammar"]

    for k in args.ks:
        p = helmholtz_2d_split(max_level=7, min_level=3, k=k)
        p.dtype = np.float32
        pset, _ = generate_primitive_set(
            p.approximation, p.rhs_entity, p.level_contexts,
            p.coarsest_operator, coupled_fields=True)
        entries = {}
        ref = v_cycle(p.level_contexts, p.rhs_entity, pre_smoothing=2,
                      post_smoothing=1, omega=0.6,
                      partitioning=part.RedBlack,
                      smoother_factory=smoother.generate_collective_jacobi,
                      coarse_operator=p.coarsest_operator)
        transformations.assign_cycle_ids(ref)
        entries["reference"] = ref
        tree = gp.parse_tree(grammar, pset)
        ev = gp.compile_tree(tree, pset)[0]
        transformations.assign_cycle_ids(ev)
        entries["evolved"] = ev

        b = p.rhs_builder(np.float32)
        matvec_df = split_system_matvec_df(p.outer_solver.operator)
        residual_df = split_system_residual_df(p.outer_solver.operator)

        solvers = {}
        for name, cyc in entries.items():
            low = lower_cycle(cyc, p.approximation, p.rhs_entity)
            om = jnp.asarray(low.default_omegas, jnp.float32)

            def precond(fields, low=low, om=om):
                zero = tuple(jnp.zeros_like(f) for f in fields)
                return low.step(zero, fields, om)

            solvers[name] = precond

        rows = {name: [] for name in solvers}
        for rep in range(args.reps):
            for name, precond in solvers.items():
                t0 = time.perf_counter()
                _, _, it, hist = df64_basis_bicgstab_split(
                    matvec_df, precond, residual_df, b, tol=1e-7,
                    maxiter=args.maxiter, segment=100)
                wall = time.perf_counter() - t0
                ok = hist[-1] <= 1.1e-7
                rows[name].append((wall, it, hist[-1], ok))
                print(f"[hh-dev] k={k:.0f} rep{rep} {name}: "
                      f"{wall:.2f}s wall, {it} its, "
                      f"rel={hist[-1]:.2e} {'ok' if ok else 'FAIL'}",
                      flush=True)
        for name, rr in rows.items():
            walls = sorted(w for w, _, _, ok in rr if ok)
            its = sorted(i for _, i, _, ok in rr if ok)
            if walls:
                print(f"[hh-dev] k={k:.0f} {name}: median wall "
                      f"{walls[len(walls) // 2]:.2f}s, median its "
                      f"{its[len(its) // 2]}", flush=True)
            else:
                print(f"[hh-dev] k={k:.0f} {name}: no converged reps",
                      flush=True)


if __name__ == "__main__":
    main()
