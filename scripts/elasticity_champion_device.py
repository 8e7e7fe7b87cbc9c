"""Device ms/cycle for the evolved elasticity champions vs the hand-tuned
V(2,1) collective RB 1.25 (convergence physics settled on CPU f64 by the
campaign, results/evolved_champions.json).  Reference analogue: the
papers' LinearElasticity campaign measures evolved solver wall-clock through generated C++
(reference code_generation/exastencils.py:485-537).

Interleaved slope-fit over chained 200-cycle launches, alternating all
structures within one process, at the campaign configuration
(levels 4->8, 255^2 u,v system).

    python scripts/elasticity_champion_device.py
"""

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    import jax
    import jax.numpy as jnp
    from evostencils_tpu.config import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    print(f"[el-dev] device: {jax.devices()[0]}", file=sys.stderr,
          flush=True)

    from evostencils_tpu.problems.elasticity import linear_elasticity_2d
    from evostencils_tpu.grammar.multigrid import generate_primitive_set
    from evostencils_tpu.grammar import gp
    from evostencils_tpu.ir import partitioning as part
    from evostencils_tpu.ir import smoother, transformations
    from evostencils_tpu.compiler.cycles import v_cycle
    from evostencils_tpu.compiler.lower import lower_cycle
    from evostencils_tpu.compiler.solve import make_cycle_loop

    problem = linear_elasticity_2d(max_level=8, min_level=4)   # 255^2
    problem.dtype = np.float32
    pset, _ = generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)
    champions = json.loads(
        (ROOT / "results" / "evolved_champions.json").read_text())
    rows = champions["elasticity2d_255sq_collective_gen25"]

    entries = {}
    ref = v_cycle(problem.level_contexts, problem.rhs_entity,
                  pre_smoothing=2, post_smoothing=1, omega=1.25,
                  partitioning=part.RedBlack,
                  smoother_factory=smoother.generate_collective_jacobi,
                  coarse_operator=problem.coarsest_operator)
    transformations.assign_cycle_ids(ref)
    entries["hand-tuned V(2,1) RB 1.25"] = ref
    for tag, row in (("evolved best-rho", rows[0]),
                     ("evolved balanced", rows[4])):
        tree = gp.parse_tree(row["grammar"], pset)
        ev = gp.compile_tree(tree, pset)[0]
        transformations.assign_cycle_ids(ev)
        entries[tag] = ev

    b = problem.build_rhs()
    runs = {}
    for name, cyc in entries.items():
        low = lower_cycle(cyc, problem.approximation, problem.rhs_entity)
        om = jnp.asarray(low.default_omegas, jnp.float32)
        run = make_cycle_loop(low, 200)
        u = tuple(jnp.zeros_like(x) for x in b)
        u = run(u, b, om)
        float(np.asarray(jax.device_get(u[0].ravel()[0])))
        runs[name] = {"run": run, "om": om, "u": u, "per_s": {}}

    salt = 1
    for rep in range(3):
        for S in (1, 2, 4):
            for name, st in runs.items():
                u0 = tuple(x * (1 + (salt % 7) * 1e-30) for x in st["u"])
                float(np.asarray(jax.device_get(u0[0].ravel()[0])))
                t0 = time.perf_counter()
                out = u0
                for j in range(S):
                    out = st["run"](tuple(
                        x * (1 + ((salt + j) % 5) * 1e-30) for x in out),
                        b, st["om"])
                float(np.asarray(jax.device_get(out[0].ravel()[0])))
                st["per_s"].setdefault(S, []).append(
                    time.perf_counter() - t0)
                st["u"] = out
                salt += S
    for name, st in runs.items():
        pairs = [(S, min(ws)) for S, ws in sorted(st["per_s"].items())]
        A = np.stack([[p[0] for p in pairs], np.ones(len(pairs))], 1)
        W = np.array([p[1] for p in pairs])
        slope = np.linalg.lstsq(A, W, rcond=None)[0][0]
        print(f"[el-dev] {name}: {slope * 1e3 / 200:.4f} ms/cycle",
              flush=True)


if __name__ == "__main__":
    main()
