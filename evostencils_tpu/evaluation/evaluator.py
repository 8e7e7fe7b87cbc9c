"""Measured fitness evaluation: compile-once, batch-execute populations.

This is the native replacement of the reference's per-individual pipeline
ExaSlang emission -> JVM compiler -> make/g++ -> subprocess run
(reference code_generation/exastencils.py:485-537, seconds per individual).
Here:

* each distinct cycle *structure* (tree with relaxation-factor terminals
  normalized out) is lowered and jit-compiled once;
* all individuals sharing a structure are evaluated in ONE vmapped solve —
  the relaxation-factor vector is a traced argument, so a whole
  population slice becomes a single batched device program
  (BASELINE.json config 5: 64 evolved cycles batch-evaluated);
* per-individual time-to-convergence = measured per-cycle time of the
  structure x iteration count of the individual.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..compiler.lower import lower_cycle, lower_composed, ChainLink, LoweredCycle
from ..compiler.solve import make_solver, residual_norm_fn
from ..grammar import gp
from ..ir import transformations, base

_RF_PATTERN = re.compile(r"rf_\d+")


def structure_key(individual) -> str:
    """Tree string with relaxation-factor terminals normalized away."""
    return _RF_PATTERN.sub("rf", str(individual))


@dataclass
class EvaluationResult:
    time_to_convergence_ms: float
    convergence_factor: float
    iterations: float   # float so that infinity is representable


class CycleEvaluator:
    """Measured evaluation backend over a Problem."""

    def __init__(self, problem, *, dtype=None, max_iterations: Optional[int] = None,
                 target_reduction: Optional[float] = None,
                 throughput_cycles: int = 5, infinity: float = 1e100,
                 chain: Optional[List[ChainLink]] = None,
                 cand_entities: Optional[Tuple] = None):
        from ..config import enable_persistent_compilation_cache
        enable_persistent_compilation_cache()
        self.problem = problem
        #: level-chunked runs: the finer chunks' best cycles (finest first);
        #: candidates are then coarse cycles spliced in underneath and the
        #: measured solve is the FULL composed program on the finest grid
        #: (reference optimization/program.py:810-899)
        self.chain = chain or []
        #: (approximation, rhs) entities the candidate chunk's trees bind
        self.cand_entities = cand_entities
        if self.chain and cand_entities is None:
            raise ValueError("chain evaluation requires cand_entities")
        #: fixed omega prefix of the composed program (chain cycles)
        self._omega_prefix = np.concatenate(
            [[float(c.relaxation_factor)
              for c in transformations.find_nodes(link.root, base.Cycle)]
             for link in self.chain]) if self.chain else np.zeros(0)
        self.dtype = dtype or problem.dtype
        if self.dtype == np.float64 and not jax.config.jax_enable_x64:
            self.dtype = np.float32      # what the backend can actually hold
        self.max_iterations = max_iterations or problem.max_iterations
        self.target_reduction = target_reduction or problem.target_reduction
        # f32 residuals stagnate around 1e-7 relative; measure rho at a
        # reachable reduction and extrapolate the iteration count to the
        # problem target with log(eps)/log(rho) — the reference's own
        # time-to-convergence model (reference program.py:347-349)
        self.measurement_reduction = self.target_reduction
        if np.dtype(self.dtype).itemsize <= 4:
            self.measurement_reduction = max(self.target_reduction, 1e-5)
        self.throughput_cycles = throughput_cycles
        self.infinity = infinity
        problem.dtype = self.dtype
        self._b = problem.build_rhs()
        self._u0 = tuple(jnp.zeros_like(x) for x in self._b)
        self._solver_cache: Dict[str, dict] = {}
        self.compilations = 0
        #: (structure key, exception repr) of every group whose solve
        #: raised; its members got infinity fitness
        self.run_failures: List[Tuple[str, str]] = []
        self.last_timings: List[Optional[dict]] = []

    # -- structure compilation ----------------------------------------------

    def _get_compiled(self, key: str, expression: base.Cycle):
        entry = self._solver_cache.get(key)
        if entry is not None:
            return entry
        if self.chain:
            lowered = lower_composed(self.chain, expression,
                                     *self.cand_entities)
        else:
            lowered = lower_cycle(expression, self.problem.approximation,
                                  self.problem.rhs_entity)
        outer = getattr(self.problem, "outer_solver", None)
        if outer is not None:
            solver = self._make_outer_solver(lowered, expression, outer)
        else:
            solver = make_solver(lowered, self.max_iterations,
                                 self.measurement_reduction)
        batched_solver = jax.jit(jax.vmap(
            lambda om: solver(self._u0, self._b, om)[1:]))

        entry = {"lowered": lowered, "solver": solver,
                 "batched_solver": batched_solver,
                 "cycle_time_ms": None}
        self._solver_cache[key] = entry
        self.compilations += 1
        return entry

    def _make_outer_solver(self, lowered, expression, outer):
        """Outer Krylov solve with the evolved cycle as preconditioner
        (reference Helmholtz PreconditionedBiCGStab).  Split-complex
        problems use the (re, im)-pair variant so the compiled program
        stays real-typed."""
        from ..compiler.lower import operator_applier
        from ..ops.solvers import (preconditioned_bicgstab,
                                   preconditioned_bicgstab_split)

        matvec = operator_applier(outer.operator)
        max_iter = min(outer.max_iterations, self.max_iterations)
        bicgstab = (preconditioned_bicgstab_split
                    if getattr(outer, "split", False)
                    else preconditioned_bicgstab)

        def solver(u0, b, omegas):
            # f32 matmuls and contractions may run at reduced precision
            # on an accelerator (TF32 on the GPU keeps ~3 decimal digits);
            # a Krylov recurrence then sees an operator accurate to ~1e-3,
            # stalls, and can break down.  Trace the whole outer solve at
            # HIGHEST precision — multigrid cycles alone are insensitive,
            # Krylov is not.
            with jax.default_matmul_precision("highest"):
                def precond(fields):
                    zero = tuple(jnp.zeros_like(f) for f in fields)
                    return lowered.step(zero, fields, omegas)

                x, k, hist = bicgstab(
                    matvec, precond, b, tol=outer.tolerance,
                    maxiter=max_iter, history_size=max_iter)
            return x, k, hist

        return jax.jit(solver)

    #: slope-fit timing protocol: repetitions per window size and the
    #: chained-solve counts per timed window.  The per-solve time is the
    #: least-squares SLOPE of window-time vs solves-per-window, so the
    #: fixed per-window cost (dispatch and synchronisation) lands in the
    #: intercept and cancels.
    timing_reps = 3
    timing_window_sizes = (1, 2, 4, 8)
    #: False skips wall-time measurement entirely (cycle time fixed at
    #: 1.0 ms, so time_to_convergence degenerates to the iteration
    #: count) — the prescreen evaluator only needs convergence
    timing_enabled = True
    #: soft budget: the largest window is shrunk so one window stays under
    #: this many seconds (slow/failing structures should not stall a
    #: generation)
    timing_window_budget_s = 1.5

    _chain_op_cached = None

    def _chain_op(self):
        """Device-side state chaining: scale the previous solution to
        numerical irrelevance (1e-35: below f32 ulp of b in the residual,
        so the iteration trace is bit-identical) so (a) no call can be
        served from an identical-arguments cache and (b) the chain stays
        on-device — no host fetch between the solves of one window."""
        if self._chain_op_cached is None:
            self._chain_op_cached = jax.jit(
                lambda x, e: jax.tree_util.tree_map(
                    lambda xi: jnp.nan_to_num(
                        xi * e.astype(xi.dtype),
                        nan=0.0, posinf=0.0, neginf=0.0), x))
        return self._chain_op_cached

    def _solve_window(self, run, om, x, n_solves: int, salt: int):
        """Time one window of ``n_solves`` chained solves.  Returns
        (wall seconds, final solution)."""
        chain = self._chain_op()
        u0 = chain(x, jnp.float32((salt % 7 + 1) * 1e-35))
        jax.block_until_ready(u0)           # drain all prior dispatch
        t0 = time.perf_counter()
        out = run(u0, self._b, om)
        for j in range(1, n_solves):
            u0 = chain(out[0], jnp.float32(((salt + j) % 7 + 1) * 1e-35))
            out = run(u0, self._b, om)
        jax.block_until_ready(out[0])       # close the window
        return time.perf_counter() - t0, out[0]

    @staticmethod
    def _fit_slope(pairs) -> float:
        """Least-squares slope of (solves-per-window, window seconds)."""
        S = np.array([p[0] for p in pairs], dtype=float)
        W = np.array([p[1] for p in pairs], dtype=float)
        A = np.stack([S, np.ones_like(S)], axis=1)
        slope, _ = np.linalg.lstsq(A, W, rcond=None)[0]
        return float(slope)

    def _window_plan(self, probe_s: float):
        """Window sizes fitting the per-window budget given one solve
        takes ``probe_s`` (upper bound: includes the fixed per-window
        cost)."""
        sizes = [s for s in self.timing_window_sizes
                 if s == 1 or s * probe_s <= self.timing_window_budget_s]
        return tuple(sizes)

    def _timing_series(self, run, om, x, reps=None, sizes=None, salt0=0):
        """Per-window-size wall-time minima for one compiled solver.
        Returns ({size: [seconds, ...]}, final solution, next salt)."""
        per_s: Dict[int, List[float]] = {}
        salt = salt0
        for _ in range(reps or self.timing_reps):
            for S in sizes or self.timing_window_sizes:
                w, x = self._solve_window(run, om, x, S, salt)
                salt += S
                per_s.setdefault(S, []).append(w)
        return per_s, x, salt

    @classmethod
    def _slope_from_series(cls, per_s) -> float:
        """Per-solve seconds from a window series: slope over per-size
        minima (min = least-contended sample; contention only adds time).
        Degenerates to the single-size minimum when the plan had to shrink
        to one size (solve so slow the round trip is negligible)."""
        pairs = [(S, min(ws)) for S, ws in sorted(per_s.items())]
        if len(pairs) == 1:
            return pairs[0][1] / pairs[0][0]
        slope = cls._fit_slope(pairs)
        if slope <= 0:          # pathological noise: fall back to the
            lo, hi = pairs[0], pairs[-1]        # two-point estimate
            slope = (hi[1] - lo[1]) / max(hi[0] - lo[0], 1)
        return max(slope, 1e-12)

    def _measure_cycle_time(self, entry) -> float:
        """Per-iteration wall time of this structure, measured by re-running
        the already-compiled solver (the full converging solve — same
        protocol as the reference, which times the generated binary's whole
        run; exastencils.py:417-443).  No extra compilation: one XLA
        program per structure is the evolution-loop latency budget.

        Slope-fit protocol (see ``timing_reps``): windows of 1/2/4/8
        chained solves, per-size minima, least-squares slope = seconds per
        solve; divided by the (deterministic) iteration count."""
        if entry["cycle_time_ms"] is not None:
            return entry["cycle_time_ms"]
        if not self.timing_enabled:
            entry["cycle_time_ms"] = 1.0
            return 1.0
        lowered = entry["lowered"]
        om = jnp.asarray(lowered.default_omegas, dtype=jnp.float32
                         if self.dtype == np.float32 else None)
        run = entry["solver"]
        out = run(self._u0, self._b, om)
        x = out[0]
        iters = max(int(jax.device_get(out[1])), 1)    # compile + warm
        w_probe, x = self._solve_window(run, om, x, 1, 0)
        if w_probe > self.timing_window_budget_s:
            # seconds-long solves (e.g. iteration-capped failures): the
            # fixed per-window cost is negligible — one sample is
            # enough, and a full series would stall the generation
            entry["cycle_time_ms"] = w_probe * 1e3 / iters
            return entry["cycle_time_ms"]
        sizes = self._window_plan(w_probe)
        per_s, x, _ = self._timing_series(run, om, x, sizes=sizes, salt0=1)
        per_s.setdefault(1, []).append(w_probe)
        slope = self._slope_from_series(per_s)
        entry["cycle_time_ms"] = slope * 1e3 / iters
        return entry["cycle_time_ms"]

    def measure_interleaved(self, keyed_expressions, reps: int = 5):
        """Head-to-head measurement of several structures INTERLEAVED in
        this one process ('A beats B' claims must not compare timings
        from different processes).  The timed windows round-robin across
        the structures within every repetition, so drift in the device's
        clocks hits all of them equally; each
        structure gets a per-rep slope fit, reported as median + spread.

        ``keyed_expressions``: list of (key, expression).  Returns a list
        of dicts with ms_per_iter (median over reps), spread (min/max of
        the per-rep slopes), iterations, time_to_convergence_ms.
        """
        entries = []
        for key, expression in keyed_expressions:
            entry = self._get_compiled(key, expression)
            lowered = entry["lowered"]
            om = jnp.asarray(lowered.default_omegas,
                             dtype=jnp.float32
                             if self.dtype == np.float32 else None)
            run = entry["solver"]
            out = run(self._u0, self._b, om)
            x = out[0]
            iters = max(int(jax.device_get(out[1])), 1)
            hist = np.asarray(jax.device_get(out[2]))
            w_probe, x = self._solve_window(run, om, x, 1, 0)
            entries.append({"entry": entry, "om": om, "run": run, "x": x,
                            "iters": iters, "hist": hist,
                            "sizes": self._window_plan(w_probe),
                            "rep_slopes": []})
        salt = 1
        for rep in range(reps):
            # one full window series per structure per rep, interleaved at
            # window granularity across structures
            per_rep = [dict() for _ in entries]
            longest = max(len(e["sizes"]) for e in entries)
            for si in range(longest):
                for ei, e in enumerate(entries):
                    if si >= len(e["sizes"]):
                        continue
                    S = e["sizes"][si]
                    w, e["x"] = self._solve_window(e["run"], e["om"],
                                                   e["x"], S, salt)
                    salt += S
                    per_rep[ei].setdefault(S, []).append(w)
            for ei, e in enumerate(entries):
                e["rep_slopes"].append(self._slope_from_series(per_rep[ei]))
        results = []
        for (key, _), e in zip(keyed_expressions, entries):
            slopes = np.array(e["rep_slopes"])
            ms_it = float(np.median(slopes)) * 1e3 / e["iters"]
            res = self._result_from_history_with_time(
                e["entry"], e["hist"], e["iters"], ms_it)
            results.append({
                "key": key, "ms_per_iter": ms_it,
                "ms_per_iter_spread": (float(slopes.min()) * 1e3 / e["iters"],
                                       float(slopes.max()) * 1e3 / e["iters"]),
                "iterations": res.iterations,
                "convergence_factor": res.convergence_factor,
                "time_to_convergence_ms": res.time_to_convergence_ms,
            })
        return results


    # -- single evaluation ---------------------------------------------------

    def solve(self, expression: base.Cycle, key: Optional[str] = None):
        """One measured-path solve of ``expression`` from the zero guess
        with its own relaxation factors: ``(solution fields, iterations,
        residual history)``, the history as a host array."""
        entry = self._get_compiled(key or str(id(expression)), expression)
        omegas = jnp.asarray(entry["lowered"].default_omegas,
                             dtype=self._om_dtype())
        u, iters, hist = entry["solver"](self._u0, self._b, omegas)
        return u, int(iters), np.asarray(jax.device_get(hist))

    def evaluate_expression(self, expression: base.Cycle,
                            key: Optional[str] = None) -> EvaluationResult:
        key = key or str(id(expression))
        _, iters, hist = self.solve(expression, key)
        return self._result_from_history(self._solver_cache[key], hist, iters)

    def _result_from_history(self, entry, hist, iters) -> EvaluationResult:
        return self._result_from_history_with_time(
            entry, hist, iters, None)

    def _result_from_history_with_time(self, entry, hist, iters,
                                       cycle_time) -> EvaluationResult:
        if cycle_time is None:
            cycle_time = self._measure_cycle_time(entry)
        r0 = hist[0]
        converged = (r0 > 0 and np.isfinite(hist[iters])
                     and hist[iters] <= self.measurement_reduction * r0
                     * (1 + 1e-6))
        if iters > 0 and np.isfinite(hist[iters]) and hist[iters] > 0 and r0 > 0:
            rho = float((hist[iters] / r0) ** (1.0 / iters))
        else:
            rho = self.infinity if not np.isfinite(hist[iters]) else 0.0
        if not converged or not np.isfinite(rho):
            return EvaluationResult(self.infinity,
                                    rho if np.isfinite(rho) else self.infinity,
                                    self.infinity)
        if self.measurement_reduction > self.target_reduction and rho > 0:
            # extrapolate to the problem target (f32 measurement window)
            iters_full = (np.log(self.target_reduction) / np.log(rho)
                          if rho < 1 else self.infinity)
        else:
            iters_full = float(iters)
        if not np.isfinite(iters_full) or iters_full > 10 * self.max_iterations:
            return EvaluationResult(self.infinity, rho, self.infinity)
        return EvaluationResult(cycle_time * iters_full, rho,
                                float(np.ceil(iters_full)))

    # -- batched population evaluation ---------------------------------------

    #: threads used to overlap per-structure XLA compilations (the
    #: evolution loop's latency budget is compile-bound; compilation
    #: happens outside the GIL / in the compile service, so a small pool
    #:  overlaps well).  Set to 1 to force serial compilation.
    compile_workers: int = 4

    def _om_dtype(self):
        return jnp.float32 if self.dtype == np.float32 else None

    def _precompile_groups(self, groups, expressions, omega_batches):
        """Warm the jit caches of all new structures concurrently via the
        AOT API (lower -> compile).  Failures are swallowed — the caller's
        per-group execution reports them as infinity fitness.

        BOTH programs of a structure are compiled here: the vmapped
        batched solve (only when the group actually batches, B > 1) and
        the single-sample solver that the timing path and B == 1 groups
        run, so neither compiles serially inside _measure_cycle_time.
        Each job's seconds (trace + compile) land in ``entry[slot + "_s"]``."""
        import concurrent.futures as cf
        keys = [k for k in groups if k not in self._solver_cache]
        if not keys or self.compile_workers <= 1:
            return
        entries = {}
        for key in keys:
            try:
                entries[key] = self._get_compiled(
                    key, expressions[groups[key][0]])
            except Exception:
                pass

        jobs = []
        for key, entry in entries.items():
            om_b = omega_batches[key]
            if om_b.shape[0] > 1:
                jobs.append((entry, "batched_aot", entry["batched_solver"],
                             (om_b,)))
            om1 = jnp.asarray(np.asarray(om_b[0]), dtype=self._om_dtype())
            jobs.append((entry, "solver_aot", entry["solver"],
                         (self._u0, self._b, om1)))

        def compile_one(job):
            # AOT lower+compile, KEEPING the compiled executable: calling
            # the lazy jit wrapper afterwards would re-trace the whole
            # program a second time (tracing is GIL-serial Python and, on
            # a warm persistent cache, costs as much as the compile —
            # measured round 5)
            entry, slot, fn, args = job
            t0 = time.perf_counter()
            entry[slot] = fn.lower(*args).compile()
            entry[slot + "_s"] = time.perf_counter() - t0

        with cf.ThreadPoolExecutor(self.compile_workers) as pool:
            futures = [pool.submit(compile_one, j) for j in jobs]
            for f in cf.as_completed(futures):
                try:
                    f.result()
                except Exception:
                    pass   # fall back to the lazy jit path at call time

    #: opt-in structure canonicalization (compiler/canonical.py): pad
    #: smoother chains with zero-omega sweeps so SWEEP COUNT becomes a
    #: traced value like omega already is — structures differing only in
    #: sweep counts then share one compiled program.  Timing caveat: the
    #: shared program's ms/iteration is an upper bound for members with
    #: fewer real sweeps (the padded sweeps execute, scaled by zero).
    canonicalize = False

    def _merge_canonical_groups(self, groups, expressions):
        """Merge structure-key groups whose padded trees share a
        relaxation-blind signature; split again on omega-count mismatch
        (signature-collision guard)."""
        from ..compiler import canonical
        merged: Dict[str, List[int]] = {}
        for key, members in groups.items():
            try:
                for i in members:
                    canonical.pad_smoother_chains(expressions[i])
                    transformations.assign_cycle_ids(expressions[i])
                sig = canonical.signature(expressions[members[0]])
            except Exception:
                merged[key] = list(members)   # keep the unmerged group
                continue
            merged.setdefault(sig, []).extend(members)
        out: Dict[str, List[int]] = {}
        for sig, members in merged.items():
            by_count: Dict[int, List[int]] = {}
            for i in members:
                n = len(transformations.find_nodes(expressions[i],
                                                   base.Cycle))
                by_count.setdefault(n, []).append(i)
            if len(by_count) == 1:
                out[sig] = members
            else:
                for n, mem in by_count.items():
                    out[f"{sig}#n{n}"] = mem
        #: (structure keys before, programs after) of the last merge
        self.canonical_collapse = (len(groups), len(out))
        return out

    def evaluate_population(self, individuals: List, pset) -> List[EvaluationResult]:
        """Group by structure, one vmapped batched solve per group.

        Leaves per-individual costs in ``last_timings`` (``compile_s``: AOT
        trace + compile seconds of the individual's structure, 0 when it
        was compiled before; ``run_s``: wall seconds of its group's solves
        and timing windows, which include any compile the AOT step did not
        do) and the exceptions of groups whose solve raised in
        ``run_failures``."""
        self.last_timings = [None] * len(individuals)
        groups: Dict[str, List[int]] = {}
        expressions: List[Optional[base.Cycle]] = [None] * len(individuals)
        results: List[Optional[EvaluationResult]] = [None] * len(individuals)
        for i, ind in enumerate(individuals):
            if len(ind) > 150:
                results[i] = EvaluationResult(self.infinity, self.infinity,
                                              self.infinity)
                continue
            try:
                state = gp.compile_tree(ind, pset)
                expr = state[0]
                transformations.assign_cycle_ids(expr)
                expressions[i] = expr
                groups.setdefault(structure_key(ind), []).append(i)
            except (MemoryError, ValueError, NotImplementedError,
                    RuntimeError, KeyError):
                results[i] = EvaluationResult(self.infinity, self.infinity,
                                              self.infinity)
        if self.canonicalize:
            groups = self._merge_canonical_groups(groups, expressions)
        # pad each group's batch to a power-of-two bucket: group sizes
        # vary per generation and every distinct batch shape is a fresh
        # XLA compilation — bucketing bounds compiles per structure at
        # log2(mu) while wasting only the padded lanes' device time
        omega_batches: Dict[str, jnp.ndarray] = {}
        for key, members in groups.items():
            # composed chunk programs: fixed chain omegas prefix the
            # candidate's own factors (lower_composed id assignment)
            omega_batch = np.stack([
                np.concatenate([
                    self._omega_prefix,
                    [float(c.relaxation_factor) for c in
                     transformations.find_nodes(expressions[i], base.Cycle)]])
                for i in members])
            B = len(members)
            bucket = 1 << (B - 1).bit_length()
            if bucket > B:
                omega_batch = np.concatenate(
                    [omega_batch,
                     np.repeat(omega_batch[:1], bucket - B, axis=0)])
            omega_batches[key] = jnp.asarray(omega_batch,
                                             dtype=self._om_dtype())
        try:
            self._precompile_groups(groups, expressions, omega_batches)
        except Exception:
            pass
        for key, members in groups.items():
            try:
                entry = self._get_compiled(key, expressions[members[0]])
            except (NotImplementedError, ValueError, RuntimeError, KeyError,
                    np.linalg.LinAlgError):
                for i in members:
                    results[i] = EvaluationResult(self.infinity, self.infinity,
                                                  self.infinity)
                continue
            B = len(members)
            omega_batch = omega_batches[key]
            compile_s = (entry.pop("batched_aot_s", 0.0)
                         + entry.pop("solver_aot_s", 0.0))
            t0 = time.perf_counter()
            try:
                if B == 1:
                    # single member: run the plain solver — the SAME
                    # compiled program the timing path uses, so the
                    # structure costs ONE compile, not two (the dominant
                    # case for random populations)
                    om1 = jnp.asarray(np.asarray(omega_batch[0]),
                                      dtype=self._om_dtype())
                    run = entry.get("solver_aot") or entry["solver"]
                    _, it1, h1 = run(self._u0, self._b, om1)
                    iters_b = np.asarray([jax.device_get(it1)])
                    hist_b = np.asarray(jax.device_get(h1))[None]
                else:
                    run_b = (entry.get("batched_aot")
                             or entry["batched_solver"])
                    iters_b, hist_b = run_b(omega_batch)
                    iters_b = np.asarray(jax.device_get(iters_b))[:B]
                    hist_b = np.asarray(jax.device_get(hist_b))[:B]
            except Exception as e:
                self.run_failures.append((key, repr(e)))
                for i in members:
                    results[i] = EvaluationResult(self.infinity, self.infinity,
                                                  self.infinity)
                continue
            for j, i in enumerate(members):
                results[i] = self._result_from_history(
                    entry, hist_b[j], int(iters_b[j]))
            run_s = time.perf_counter() - t0
            for i in members:
                self.last_timings[i] = {"compile_s": compile_s,
                                        "run_s": run_s, "group_size": B}
        return results
