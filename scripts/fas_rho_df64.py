"""FAS suite-row convergence under the df64 residual protocol.

The reference measures FAS rho as ``(r_N / r_0)^(1/N)`` from per-cycle
residuals of the f64 solver run to 1e-10 (reference
code_generation/exastencils_FAS.py:370-394).  In f32 the
CYCLE arithmetic floors near 1e-6 relative, so this script separates the
two physical quantities the reference's single number conflates:

1. the FAS V-cycle's asymptotic contraction rho, measured from TRUE df64
   residuals (compiler/refine.scalar_residual_df_fn) per cycle over the
   pre-floor segment — pure physics, no f32 residual-measurement
   artifact;
2. the deep 1e-10 target, reached by the df64 Newton refinement path
   (scripts/deep_solve.py protocol).

    python scripts/fas_rho_df64.py
"""

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-level", type=int, default=10)
    ap.add_argument("--min-level", type=int, default=6)
    ap.add_argument("--cycles", type=int, default=40)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import os
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    print(f"[fas-rho] device: {jax.devices()[0]}", file=sys.stderr,
          flush=True)

    from evostencils_tpu.problems.fas import fas_2d_basic
    from evostencils_tpu.compiler.cycles import fas_v_cycle
    from evostencils_tpu.compiler.lower import (lower_cycle, _nonlinear_of)
    from evostencils_tpu.compiler.refine import (
        scalar_residual_df_fn, _constant_scalar_stencil)
    from evostencils_tpu.ir import transformations
    from evostencils_tpu.ops import df64

    p = fas_2d_basic(max_level=args.max_level, min_level=args.min_level)
    p.dtype = np.float32
    # same cycle as the suite row (scripts/bench_suite.py _fas_v):
    # V(2,2) damped Newton-Jacobi 0.8, the reference FAS template config
    cyc = fas_v_cycle(p.level_contexts, p.rhs_entity,
                      coarse_operator=p.coarsest_operator)
    transformations.assign_cycle_ids(cyc)
    low = lower_cycle(cyc, p.approximation, p.rhs_entity)
    om = jnp.asarray(low.default_omegas, jnp.float32)
    b = p.build_rhs()
    nl = _nonlinear_of(p.level_contexts[0].operator)[0]
    residual_df = scalar_residual_df_fn(_constant_scalar_stencil(low), nl)

    @jax.jit
    def step_and_residual(u, b0):
        out = low.step(u, b0, om)
        rh, rl = residual_df(out[0], jnp.zeros_like(out[0]), b0[0])
        s = jnp.max(jnp.abs(rh))
        ss = jnp.where(s > 0, s, 1.0)
        n2h, n2l = df64.df_norm2_sq((rh / ss, rl / ss))
        return out, n2h, n2l, ss

    u = tuple(jnp.zeros_like(x) for x in b)
    rh, rl = residual_df(u[0], jnp.zeros_like(u[0]), b[0])
    r0 = float(np.sqrt(float(jnp.sum(
        (rh.astype(jnp.float32) + rl.astype(jnp.float32)) ** 2))))
    print(f"[fas-rho] levels {args.min_level}->{args.max_level} "
          f"({2 ** args.max_level - 1}^2), r0={r0:.3e}", flush=True)
    rels = []
    prev = r0
    for k in range(1, args.cycles + 1):
        u, n2h, n2l, ss = step_and_residual(u, b)
        rn = float(ss) * float(np.sqrt(float(n2h) + float(n2l)))
        ratio = rn / prev
        rels.append((k, rn / r0, ratio))
        prev = rn
    # the clean (pre-floor) segment: per-cycle ratios while still
    # contracting AND well above the floor (a measured residual within
    # ~30x of the floor is sqrt(true^2 + floor^2)-polluted)
    floor_rel = min(r[1] for r in rels)
    clean = [r for r in rels if r[2] < 0.97 and r[1] > 30 * floor_rel]
    for k, rel, ratio in rels[:12]:
        print(f"[fas-rho] cycle {k:2d}: rel={rel:.3e} ratio={ratio:.4f}",
              flush=True)
    if clean:
        ratios = np.array([r[2] for r in clean])
        k_last = clean[-1][0]
        rho = float(np.exp(np.mean(np.log(ratios))))
        print(f"[fas-rho] asymptotic rho (df64 residuals, cycles 1.."
              f"{k_last}, rel reaches {clean[-1][1]:.2e}): "
              f"rho = {rho:.4f}", flush=True)
    print(f"[fas-rho] f32-state residual floor: {floor_rel:.2e} relative "
          f"(the df64 Newton path reaches 1e-10; deep_solve.py round-3 "
          f"record)", flush=True)


if __name__ == "__main__":
    main()
