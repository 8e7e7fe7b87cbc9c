"""2-process ``jax.distributed`` CPU test of the multi-host optimizer tier.

Spawns two fresh interpreters that bring up the JAX distributed runtime
over a localhost coordinator and exercise ``JaxProcessCommunicator`` — the
pickled-uint8 ``process_allgather`` path that replaces the reference's
mpi4py layer (reference optimization/program.py:285-310).  Asserts the
collectives round-trip and that a 2-rank mini-evolution with deterministic
(model-based) fitness is identical to the single-process run, the same
replication contract ``tests/test_comm.py`` checks for thread islands.
"""

import json
import pathlib
import random
import socket
import subprocess
import sys

import pytest

from evostencils_tpu.grammar.multigrid import generate_primitive_set
from evostencils_tpu.optimization.program import Optimizer
from evostencils_tpu.problems.poisson import poisson_2d

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "multihost_worker.py"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    port = _free_port()
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp)}
    procs, outs = [], []
    for rank in range(2):
        out = tmp / f"rank{rank}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(port), str(rank), str(out)],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    results = []
    for p, out in zip(procs, outs):
        try:
            _, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        results.append(json.load(open(out)))
    return results


class TestJaxProcessCommunicator:
    def test_collectives_roundtrip(self, worker_results):
        r0, r1 = sorted(worker_results, key=lambda r: r["rank"])
        for r in (r0, r1):
            assert r["size"] == 2
            # allgather returns both ranks' objects in rank order,
            # independent of per-rank payload size (pad-to-max path)
            assert [g["rank"] for g in r["gathered"]] == [0, 1]
            assert [len(g["blob"]) for g in r["gathered"]] == [100, 200]
            assert r["reduced"] == pytest.approx(1.5 + 2.5)
            assert r["bcast"] == "from-1"
            assert r["reassembled"] == list(range(7))

    def test_two_rank_evolution_matches_single_process(self, worker_results,
                                                         tmp_path):
        r0, r1 = sorted(worker_results, key=lambda r: r["rank"])
        # ranks agree with each other (replicated-population contract)
        assert r0["best"] == r1["best"]
        assert r0["population"] == r1["population"]

        # ... and with the single-process run of the identical stream
        problem = poisson_2d(max_level=3, min_level=2)
        pset, _ = generate_primitive_set(
            problem.approximation, problem.rhs_entity,
            problem.level_contexts, problem.coarsest_operator)
        opt = Optimizer(problem, rng=random.Random(123),
                        model_based_estimation=True,
                        checkpoint_directory_path=str(tmp_path))
        pop, log, hof, _, _ = opt.NSGAII(
            pset=pset, initial_population_size=8, generations=2, mu_=4,
            lambda_=4, min_level=2, max_level=3, verbose=False)
        best = min(hof, key=lambda i: i.fitness.values)
        assert r0["best"] == str(best)
        assert r0["best_fitness"] == pytest.approx(list(best.fitness.values))
        assert r0["population"] == sorted(str(i) for i in pop)
        # total_evaluations counts the replicated pending list, so every
        # rank and the solo run must agree on it
        assert r0["total_evaluations"] == opt.total_evaluations
        assert r1["total_evaluations"] == opt.total_evaluations
