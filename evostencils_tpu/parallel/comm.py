"""Host-level collectives for population-parallel evolution.

Replacement for the reference's optimizer-tier mpi4py layer
(reference optimization/program.py:285-310: ``allgather``/``gather``/
``allreduce``/``barrier`` wrappers that no-op without a communicator, used
for offspring exchange, fitness-cache replication, timing reduction and
rank-0-only I/O).  Three implementations:

* :class:`NullCommunicator` — single-process fallback, every collective is
  the identity (mirrors the reference's ``mpi_comm is None`` path);
* :class:`ThreadCommunicator` — N in-process ranks over a shared mailbox,
  for tests and single-host island runs (XLA releases the GIL during
  compiled execution, so evaluation overlaps across threads);
* :class:`JaxProcessCommunicator` — multi-host runs under
  ``jax.distributed``: Python objects ride the accelerator fabric as
  pickled uint8 arrays through ``multihost_utils.process_allgather``,
  replacing MPI entirely (SURVEY.md §5 'Distributed communication
  backend').

The optimizer keeps populations replicated: every rank runs the identical
generation/selection stream (same rng seed), only *evaluation* is
partitioned ``pending[rank::size]`` and the (tree-string, fitness) pairs
are allgathered — evaluation cost divides by the rank count while ranks
stay mutually consistent.  With deterministic fitness (model-based
estimation) a multi-rank run is bit-identical to the single-process run;
with *measured* fitness, wall-clock objectives additionally reflect
device contention between concurrently evaluating ranks (thread islands
share one accelerator), so selections can differ from a solo run within
timing noise.
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, List, Sequence


class Communicator:
    """Interface: rank/size + object collectives."""

    rank: int = 0
    size: int = 1

    def allgather_object(self, obj: Any) -> List[Any]:
        """Gather one Python object per rank, returned in rank order."""
        raise NotImplementedError

    def broadcast_object(self, obj: Any, root: int = 0) -> Any:
        return self.allgather_object(obj)[root]

    def allreduce_sum(self, value: float) -> float:
        return float(sum(self.allgather_object(float(value))))

    def barrier(self) -> None:
        self.allgather_object(None)

    def shard(self, seq: Sequence) -> list:
        """This rank's strided slice of a replicated work list."""
        return list(seq[self.rank::self.size])

    def allgather_shards(self, local: Sequence) -> list:
        """Inverse of :meth:`shard`: reassemble the full list in original
        order from every rank's strided shard."""
        shards = self.allgather_object(list(local))
        total = sum(len(s) for s in shards)
        out: List[Any] = [None] * total
        for r, shard in enumerate(shards):
            out[r::self.size] = shard
        return out


class NullCommunicator(Communicator):
    """Single-process no-op communicator (reference program.py:285-310
    with ``mpi_comm is None``)."""

    def allgather_object(self, obj: Any) -> List[Any]:
        return [obj]

    def barrier(self) -> None:
        pass


class _ThreadGroupState:
    def __init__(self, size: int):
        self.size = size
        self.slots: List[Any] = [None] * size
        self.gate = threading.Barrier(size)


class ThreadCommunicator(Communicator):
    """One of N in-process ranks sharing a mailbox + barrier."""

    def __init__(self, state: _ThreadGroupState, rank: int):
        self._state = state
        self.rank = rank
        self.size = state.size

    def allgather_object(self, obj: Any) -> List[Any]:
        st = self._state
        st.slots[self.rank] = obj
        st.gate.wait()            # all slots written
        out = list(st.slots)
        st.gate.wait()            # all slots read before reuse
        return out

    def barrier(self) -> None:
        self._state.gate.wait()


def make_thread_communicators(size: int) -> List[ThreadCommunicator]:
    """A group of ``size`` in-process communicators (one per island
    thread)."""
    state = _ThreadGroupState(size)
    return [ThreadCommunicator(state, r) for r in range(size)]


def run_island_threads(fns) -> list:
    """Run one callable per rank, each in its own thread with its own
    :class:`ThreadCommunicator`; returns the per-rank results in rank
    order.  An exception on any rank aborts the group's barrier (so no
    rank deadlocks) and is re-raised here."""
    comms = make_thread_communicators(len(fns))
    results: List[Any] = [None] * len(fns)
    errors: List[Any] = [None] * len(fns)

    def body(rank):
        try:
            results[rank] = fns[rank](comms[rank])
        except BaseException as e:      # noqa: BLE001 — must unblock peers
            errors[rank] = e
            comms[rank]._state.gate.abort()

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None and not isinstance(e, threading.BrokenBarrierError):
            raise e
    for e in errors:
        if e is not None:
            raise e
    return results


class JaxProcessCommunicator(Communicator):
    """Multi-host collectives over the JAX runtime (no MPI).

    Objects are pickled to uint8 device arrays, padded to the global max
    length and exchanged with ``multihost_utils.process_allgather`` — the
    same fabric the solver's own collectives use.  Requires
    ``jax.distributed.initialize()`` to have run on every host.
    """

    def __init__(self):
        import jax
        self.rank = jax.process_index()
        self.size = jax.process_count()

    def allgather_object(self, obj: Any) -> List[Any]:
        import numpy as np
        from jax.experimental import multihost_utils

        if self.size == 1:
            return [obj]
        payload = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
        lengths = np.asarray(multihost_utils.process_allgather(
            np.array([payload.size], dtype=np.int64))).reshape(-1)
        max_len = int(lengths.max())
        padded = np.zeros(max_len, dtype=np.uint8)
        padded[:payload.size] = payload
        rows = np.asarray(multihost_utils.process_allgather(padded))
        rows = rows.reshape(self.size, max_len)
        return [pickle.loads(rows[r, :int(lengths[r])].tobytes())
                for r in range(self.size)]


def initialize_multihost(coordinator_address: str = None,
                         num_processes: int = None,
                         process_id: int = None) -> Communicator:
    """Bring up the JAX multi-host runtime and return the process
    communicator (replaces the reference's `mpiexec` + mpi4py bootstrap,
    reference scripts/optimize.py:39-48).

    With no arguments, jax.distributed auto-detects the cluster where its
    environment describes one; elsewhere (as on a single GPU host) pass
    ``coordinator_address``, ``num_processes`` and ``process_id``."""
    import jax
    try:
        # CPU clusters need an explicit cross-process collectives backend
        # (GPUs use NCCL natively); harmless if already set
        if jax.config.jax_platforms and \
                jax.config.jax_platforms.startswith("cpu"):
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except AttributeError:
        pass
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
    return JaxProcessCommunicator()


def default_communicator() -> Communicator:
    """JaxProcessCommunicator when running multi-host, else the no-op."""
    try:
        import jax
        if jax.process_count() > 1:
            return JaxProcessCommunicator()
    except Exception:
        pass
    return NullCommunicator()
