"""A/B: explicit shard_map/ppermute halo pipeline vs GSPMD sharded sweeps.

Round-1 review asked for the cost of the GSPMD fallback that
variable-coefficient / complex / system smoothers used to take under a
mesh (the halo pipeline now covers them — parallel/halo.sweep_var,
sweep_sys, complex sweep).  This measures on the virtual 8-device CPU
mesh (the same mechanism the test suite and __graft_entry__'s multichip
dryrun use).  Absolute times are CPU times; the quantity of interest is
the RATIO pipeline/GSPMD per smoother family and the communication
structure (ppermute ring vs XLA-inserted collectives); NVLink numbers
come from chip_smoke.py --four on real cards.

Run: JAX_PLATFORMS=cpu python scripts/mesh_ab.py
"""

import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np


def timeit(fn, *args, K=30, reps=3):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)   # real CPU backend: this is a true barrier
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        o = args[0]
        for _ in range(K):
            o = fn(o, *args[1:])
        jax.block_until_ready(o)
        ts.append(time.perf_counter() - t0)
    return min(ts) / K


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from evostencils_tpu.config import enable_persistent_compilation_cache
    from evostencils_tpu.parallel.mesh import make_mesh, grid_sharding
    from evostencils_tpu.parallel import halo
    from evostencils_tpu.problems.poisson import poisson_2d
    from evostencils_tpu.ops.stencil_values import five_point_values

    enable_persistent_compilation_cache()
    assert len(jax.devices()) >= 8, "need 8 virtual devices"
    mesh = make_mesh(jax.devices()[:8], mesh_shape=(4, 2),
                     axis_names=("x", "y"))
    L = 11
    n = 2 ** L - 1
    problem = poisson_2d(max_level=L, min_level=5)
    st = problem.level_contexts[0].operator.entries[0][0].generate_stencil()
    vals = five_point_values(st)
    dinv = 1.0 / vals[0]
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    om = jnp.float32(1.15)

    # -- explicit ppermute pipeline -----------------------------------------
    pipe = jax.jit(lambda u_, b_, om_: halo.sweep(
        mesh, u_, b_, om_, vals, dinv, red_black=True))
    t_pipe = timeit(pipe, u, b, om)

    # -- GSPMD: same masked half-sweep math, sharded arrays, XLA inserts
    #    the boundary communication itself ----------------------------------
    gshard = grid_sharding(mesh, 2)

    # GSPMD needs mesh-divisible dims: run on a zero-padded (n+1, n+1)
    # array and mask the pad ring out of every update (it stays zero, so
    # the interior sees Dirichlet boundaries exactly as the pipeline does)
    npad = n + 1
    ii = jnp.arange(npad)
    valid = (ii[:, None] < n) & (ii[None, :] < n)

    def half(u_, b_, parity):
        up = jnp.pad(u_, 1)
        au = sum(v * up[1 + o0:1 + o0 + npad, 1 + o1:1 + o1 + npad]
                 for v, (o0, o1) in zip(
                     vals, [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]))
        mask = valid & (((ii[:, None] + ii[None, :]) % 2) == parity)
        return u_ + jnp.where(mask, om * dinv * (b_ - au), 0.0)

    def gspmd_sweep(u_, b_, om_):
        del om_
        return half(half(u_, b_, 0), b_, 1)

    u_sh = jax.device_put(jnp.pad(u, ((0, 1), (0, 1))), gshard)
    b_sh = jax.device_put(jnp.pad(b, ((0, 1), (0, 1))), gshard)
    gspmd = jax.jit(gspmd_sweep,
                    in_shardings=(gshard, gshard, None),
                    out_shardings=gshard)
    t_gspmd = timeit(gspmd, u_sh, b_sh, om)

    # -- fully replicated single-device reference ---------------------------
    rep = jax.jit(gspmd_sweep)
    t_rep = timeit(rep, jnp.pad(u, ((0, 1), (0, 1))),
                   jnp.pad(b, ((0, 1), (0, 1))), om)

    print(f"[mesh] 8-device CPU mesh, {n}x{n} f32 RB sweep:",
          file=sys.stderr)
    print(f"[mesh] halo pipeline : {t_pipe * 1e3:8.2f} ms", file=sys.stderr)
    print(f"[mesh] GSPMD sharded : {t_gspmd * 1e3:8.2f} ms", file=sys.stderr)
    print(f"[mesh] replicated    : {t_rep * 1e3:8.2f} ms", file=sys.stderr)
    print(f"[mesh] pipeline/GSPMD ratio: {t_pipe / t_gspmd:.2f}",
          file=sys.stderr)

    import json
    print(json.dumps({"halo_pipeline_ms": t_pipe * 1e3,
                      "gspmd_ms": t_gspmd * 1e3,
                      "replicated_ms": t_rep * 1e3,
                      "ratio_pipeline_over_gspmd": t_pipe / t_gspmd}))


if __name__ == "__main__":
    main()
