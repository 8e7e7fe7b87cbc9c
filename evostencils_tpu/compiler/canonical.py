"""Structure canonicalization: make smoother SWEEP COUNT a traced value.

The evaluator already traces relaxation factors (one compiled program
serves every omega assignment of a structure, evaluator.structure_key).
This module extends that to sweep counts: every maximal chain of
consecutive diagonal-smoother sweeps (same smoother signature, same
partitioning, same rhs) is padded to ``PAD_TO`` sweeps by inserting cycles with
relaxation factor 0.0 at the chain's INNER end.  A zero-omega sweep is
an exact identity (u + 0 * B^-1 r = u), so padded and unpadded programs
compute bitwise-identical states for the real sweeps; individuals whose
trees differ only in sweep counts then share ONE compiled program, with
their omega vectors distinguishing them (zeros in the padded slots).

The reference analogue: one generated C++ binary serves exactly one
individual (reference optimization/program.py:924); collapsing compiles
across individuals is the point of the batched-evaluation design.

Cost trade: the padded program executes every padded sweep (multiplied
by zero), so a 1-sweep member pays 3 sweeps of device work inside a
shared program — compiles dominate evaluation wall time (3-12 s of
compile against 0.1-0.8 s of run per individual on an H100, PERF.md), so
the trade wins whenever any collapse happens.  Timing caveat recorded where
used: ms/iteration measured on the canonical program is an upper bound
for members with fewer real sweeps.
"""

from typing import List, Optional

from ..ir import base, system
from ..ir import partitioning as part

#: pad every recognized chain of 1..PAD_TO sweeps up to exactly PAD_TO;
#: longer chains are left alone and keep their natural count in the
#: signature
PAD_TO = 3


def _sweep_parts(cycle):
    """(inverse, residual) if ``cycle`` is a diagonal-smoother sweep
    u + w * D^-1 (b - A u) over its own approximation, else None."""
    if not isinstance(cycle, base.Cycle):
        return None
    if cycle.partitioning not in (part.RedBlack, part.Single):
        return None
    corr = cycle.correction
    if not (isinstance(corr, base.Multiplication)
            and isinstance(corr.operand1, base.Inverse)
            and isinstance(corr.operand2, base.Residual)):
        return None
    if not isinstance(corr.operand1.operand,
                      (system.Diagonal, system.ElementwiseDiagonal,
                       base.Diagonal)):
        return None
    if corr.operand2.approximation is not cycle.approximation:
        return None
    return corr.operand1, corr.operand2


def _chain_below(cycle):
    """Maximal same-smoother same-partitioning sweep chain starting at
    ``cycle`` going inward; returns (sweeps outermost-first, inner)."""
    sweeps = []
    cur = cycle
    partitioning = None
    rhs = None
    while True:
        parts = _sweep_parts(cur)
        if parts is None:
            break
        inv, res = parts
        if sweeps:
            prev_inv, prev_res = _sweep_parts(sweeps[-1])
            if (cur.partitioning is not partitioning
                    or res.rhs is not rhs
                    or type(inv.operand) is not type(prev_inv.operand)):
                break
        else:
            partitioning = cur.partitioning
            rhs = res.rhs
        sweeps.append(cur)
        cur = cur.approximation
    return sweeps, cur


def pad_smoother_chains(root: base.Cycle) -> int:
    """Pad every recognized sweep chain in ``root`` (in place) to PAD_TO
    sweeps with zero-relaxation sweeps at the inner end.  Returns the
    number of inserted sweeps."""
    inserted = 0
    seen = set()
    stack = [root]
    while stack:
        node = stack.pop()
        if id(node) in seen or not isinstance(node, base.Expression):
            continue
        seen.add(id(node))
        if isinstance(node, base.Cycle) and _sweep_parts(node) is not None:
            sweeps, inner = _chain_below(node)
            # heads are reached first in the outer-to-inner traversal;
            # inner sweeps of a handled chain are marked seen below
            if sweeps and id(sweeps[0]) == id(node):
                L = len(sweeps)
                if 0 < L < PAD_TO:
                    last = sweeps[-1]
                    inv, res = _sweep_parts(last)
                    cur = last.approximation
                    for _ in range(PAD_TO - L):
                        pad_res = base.Residual(res.operator, cur, res.rhs)
                        # fresh Inverse + smoother wrapper per pad sweep:
                        # naturally-built chains create one per sweep too
                        # (grammar `smoothing` calls the factory each
                        # time), so the padded tree's SHARING topology
                        # matches a natural chain's — required for the
                        # DAG-aware signature to align back-references
                        pad_inv = base.Inverse(
                            type(inv.operand)(inv.operand.operand))
                        pad = base.Cycle(
                            cur, last.rhs,
                            base.Multiplication(pad_inv, pad_res),
                            partitioning=last.partitioning,
                            relaxation_factor=0.0,
                            predecessor=last.predecessor)
                        cur = pad
                        inserted += 1
                    last.approximation = cur
                    # Residual fields are read-only: rebuild the inner
                    # sweep's correction against the padded state
                    last.correction = base.Multiplication(
                        inv, base.Residual(res.operator, cur, res.rhs))
                for s in sweeps:
                    seen.add(id(s))
                stack.append(inner)
                continue
        for child in getattr(node, "children", ()):
            stack.append(child)
    return inserted


def _sig(node, out: List[str], memo=None):
    # expression graphs are DAGs (rhs/tau subtrees are shared by every
    # residual of a level); without sharing-aware serialization the
    # string blows up exponentially in depth — emit a back-reference the
    # second time a node is reached.  Individuals grouped by
    # structure_key are built by identical compile_tree runs, so their
    # sharing topology (and hence the back-reference pattern) matches.
    if memo is None:
        memo = {}
    if isinstance(node, base.Expression):
        ref = memo.get(id(node))
        if ref is not None:
            out.append(f"#{ref}")
            return
        memo[id(node)] = len(memo)
    t = type(node).__name__
    if isinstance(node, base.Cycle):
        p = getattr(node.partitioning, "__name__",
                    str(node.partitioning))
        out.append(f"Cy[{p}](")
        _sig(node.approximation, out, memo)
        out.append(",")
        _sig(node.rhs, out, memo)
        out.append(",")
        _sig(node.correction, out, memo)
        out.append(")")
        return
    if isinstance(node, base.Expression):
        try:
            name = getattr(node, "name", "")
        except Exception:
            name = ""
        lvl = ""
        try:
            grid = node.grid
            g = grid[0] if isinstance(grid, (list, tuple)) else grid
            lvl = str(getattr(g, "level", ""))
        except Exception:
            pass
        out.append(f"{t}:{name}@{lvl}(")
        first = True
        for child in node.children:
            if not first:
                out.append(",")
            _sig(child, out, memo)
            first = False
        out.append(")")
        return
    out.append(repr(node))


def signature(root: base.Cycle) -> str:
    """Relaxation-factor-blind structural signature of a (padded) cycle
    tree: node types, operator names, grid levels, partitionings and
    topology — everything that determines the compiled program except
    the traced omega values."""
    out: List[str] = []
    _sig(root, out)
    return "".join(out)
