"""Cycle compiler: multigrid expression IR -> jitted JAX programs.

This replaces the reference's entire evaluation backend — ExaSlang emission,
the external Scala/Java ExaStencils compiler, g++ and subprocess solver runs
(reference code_generation/exastencils.py:318-925) — with trace-once,
execute-batched lowering:

* grid functions are tuples of per-field jnp arrays (interior points only),
* stencil algebra runs at trace time (numpy), producing coefficient fields,
  batched block inverses and dense coarse factorizations embedded as
  constants,
* relaxation factors enter as a *traced* vector indexed by cycle id, so one
  compiled program serves every relaxation-factor assignment of the same
  cycle structure (this is what lets whole populations share compilations
  and be vmapped),
* red-black partitioned smoothing is two masked half-sweeps with a fresh
  residual in between, matching the reference's coloring semantics
  (exastencils.py:659-682) and its LFA symbol
  (model_based_prediction/convergence.py:104-106).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import reduce
from typing import Callable, Dict, List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..grids import Grid
from ..ir import base, system
from ..ir import partitioning as part
from ..ir import transformations
from ..ir.krylov import KrylovSubspaceMethod
from ..ops import apply as ops
from ..ops import solvers
from ..ops import stencil_values
from ..ops.local_solve import get_block_solve_plan
from ..stencils import constant, periodic

DIRECT_SOLVE_MAX = 4096


_DENSE_INVERSE_CACHE: dict = {}


_STENCIL_FIELD_CACHE: dict = {}


def _stencil_field_of(op):
    """StencilField of an operator whose generator supports field form
    (variable coefficients / boundary-modified stencils), else None."""
    gen = getattr(op, "stencil_generator", None)
    if gen is None or not hasattr(gen, "generate_stencil_field"):
        return None
    key = (id(gen), tuple(op.grid.size))
    hit = _STENCIL_FIELD_CACHE.get(key)
    # the cached generator reference both validates the id (a dead
    # generator's id can be REUSED by a fresh object — observed as a
    # split-complex Helmholtz problem picking up the complex problem's
    # coefficient fields) and keeps it alive so the id stays unique
    if hit is not None and hit[0] is gen:
        return hit[1]
    sf = gen.generate_stencil_field(op.grid)
    _STENCIL_FIELD_CACHE[key] = (gen, sf)
    return sf


def _nonlinear_of(op):
    """(generator, entry) when the operator carries a nonlinear term
    (FAS problems, problems/fas.FASOperatorGenerator), else None."""
    entry = op
    if isinstance(entry, system.Operator):
        if len(entry.entries) != 1:
            return None
        entry = entry.entries[0][0]
    gen = getattr(entry, "stencil_generator", None)
    if gen is not None and hasattr(gen, "nonlinear_term"):
        return gen, entry
    return None


def field_grids(expr) -> List[Grid]:
    g = expr.grid
    return g if isinstance(g, list) else [g]


def _zeros_for(grids: List[Grid], dtype):
    return tuple(jnp.zeros(tuple(g.size), dtype=dtype) for g in grids)


def is_function(expr) -> bool:
    """Grid functions have column shape (n, 1); operators are (n, m)."""
    return expr.shape[1] == 1


def red_black_masks(shape: Tuple[int, ...], dtype=None):
    """Node-parity masks: red = even node-index sum; interior index i is
    node i+1 (ops.apply.LATTICE_ORIGIN).

    Built from iotas on device: materializing them as numpy constants
    would embed O(grid) bytes into the compiled program."""
    dtype = dtype or jnp.float32
    idx = sum(jax.lax.broadcasted_iota(jnp.int32, shape, k)
              for k in range(len(shape)))
    idx = idx + len(shape) * ops.LATTICE_ORIGIN
    red = (idx % 2 == 0)
    return red.astype(dtype), (~red).astype(dtype)


# ---------------------------------------------------------------------------
# Dense coarse-grid factorization
# ---------------------------------------------------------------------------

def _system_entries(op) -> List[List]:
    if isinstance(op, system.Operator):
        return op.entries
    return [[op]]


def dense_inverse(op) -> np.ndarray:
    """Dense inverse of a (small) system operator, cached by stencil content."""
    entries = _system_entries(op)
    grids = [row[0].grid for row in entries] if isinstance(op, system.Operator) \
        else [op.grid]
    key_parts = []
    blocks = []
    for i, row in enumerate(entries):
        brow = []
        for j, entry in enumerate(row):
            st = entry.generate_stencil()
            ps = periodic.as_periodic(st) if st is not None else None
            key_parts.append((i, j, ps))
            brow.append((entry, ps))
        blocks.append(brow)
    key = (tuple(key_parts), tuple(tuple(g.size) for g in grids))
    cached = _DENSE_INVERSE_CACHE.get(key)
    if cached is not None:
        return cached
    sizes = [int(np.prod(g.size)) for g in grids]
    n = sum(sizes)
    dense_blocks = {}
    any_complex = False
    for i, row in enumerate(blocks):
        for j, (entry, ps) in enumerate(row):
            sf = _stencil_field_of(entry)
            if sf is not None:
                dense_blocks[(i, j)] = sf.dense_matrix()
            elif ps is not None and ps.constant_entries():
                dense_blocks[(i, j)] = ops.dense_matrix(ps, grids[j])
            if (i, j) in dense_blocks and \
                    np.iscomplexobj(dense_blocks[(i, j)]):
                any_complex = True
    K = np.zeros((n, n), dtype=np.complex128 if any_complex else np.float64)
    r0 = 0
    for i, row in enumerate(blocks):
        c0 = 0
        for j, _ in enumerate(row):
            if (i, j) in dense_blocks:
                K[r0:r0 + sizes[i], c0:c0 + sizes[j]] = dense_blocks[(i, j)]
            c0 += sizes[j]
        r0 += sizes[i]
    inv = np.linalg.inv(K)
    _DENSE_INVERSE_CACHE[key] = inv
    return inv


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------

@dataclass
class LoweredCycle:
    """A compiled multigrid cycle step.

    ``step(u_fields, b_fields, omegas) -> u_fields_new`` is jit-compatible;
    ``omegas`` is a 1-D relaxation-factor vector indexed by cycle id.
    """
    step: Callable
    n_omegas: int
    default_omegas: np.ndarray
    grids: List[Grid]
    operator: object  # the finest-level system operator (for residuals)
    expression: object = None  # the source Cycle IR (profiling/roofline)


def _sys_entry_nine(e):
    """Coefficients of one block-system entry in NINE_OFFSETS order, or
    None.  Constant stencils inside the 3x3 box classify, and so do
    StencilField entries whose every coefficient field is uniform."""
    if isinstance(e, base.ZeroOperator):
        return (0.0,) * 9
    if type(e) is not base.Operator or _nonlinear_of(e) is not None:
        return None
    sf = _stencil_field_of(e)
    if sf is None:
        st = e.generate_stencil()
        if not isinstance(st, constant.Stencil):
            return None
        return stencil_values.nine_point_coeffs(st)
    if set(sf.offsets) - set(stencil_values.NINE_OFFSETS):
        return None
    if len(set(sf.offsets)) != len(sf.offsets):
        return None     # duplicate offset would silently overwrite
    nine = [0.0] * 9
    for off, f in zip(sf.offsets, sf.fields):
        f = np.asarray(f)
        if np.iscomplexobj(f):
            return None
        desc = ops.almost_uniform_desc(f)
        if desc is None or desc[0] != "const":
            return None
        nine[stencil_values.NINE_OFFSETS.index(off)] = float(desc[1])
    return tuple(nine)


def _sys_nine_table(A):
    """Per-entry 9-point coefficient tables of an FxF block system, or None
    when any entry is outside the 3x3 box or has non-uniform
    coefficients."""
    coeffs = []
    for row in A.entries:
        crow = []
        for e in row:
            c = _sys_entry_nine(e)
            if c is None:
                return None
            crow.append(c)
        coeffs.append(tuple(crow))
    return tuple(coeffs)


class _Lowering:
    def __init__(self, approximation, rhs, omegas, cgs_override=None):
        self.omegas = omegas
        #: ``(fields, omegas) -> fields`` used for CoarseGridSolver nodes
        #: whose ``expression`` is None — this is how a coarser chunk's
        #: evolved cycle is spliced in as the coarse-grid solver of an
        #: already-evolved finer chunk (level-chunked runs, reference
        #: optimization/program.py:810-899) without mutating the shared
        #: CGS terminal object of the grammar.
        self.cgs_override = cgs_override
        self.env: Dict[int, object] = {}
        self.memo: Dict[int, object] = {}
        self.approximation = approximation
        self.rhs = rhs

    def bind(self, u_fields, b_fields):
        self.env[id(self.approximation)] = tuple(u_fields)
        self.env[id(self.rhs)] = tuple(b_fields)
        if isinstance(self.approximation, system.Approximation):
            for e, u in zip(self.approximation.entries, u_fields):
                self.env[id(e)] = (u,)
        if isinstance(self.rhs, system.RightHandSide):
            for e, b in zip(self.rhs.entries, b_fields):
                self.env[id(e)] = (b,)
        self.dtype = u_fields[0].dtype

    # -- grid functions ----------------------------------------------------

    def eval_function(self, expr):
        key = id(expr)
        if key in self.memo:
            return self.memo[key]
        result = self._eval_function(expr)
        self.memo[key] = result
        return result

    def _eval_function(self, expr):
        if id(expr) in self.env:
            return self.env[id(expr)]
        if isinstance(expr, (system.ZeroApproximation, base.ZeroApproximation)):
            return _zeros_for(field_grids(expr), self.dtype)
        if isinstance(expr, base.Cycle):
            return self.eval_cycle(expr)
        if isinstance(expr, base.Residual):
            b = self.eval_function(expr.rhs)
            x = self.eval_function(expr.approximation)
            ax = self.apply_operator(expr.operator, x)
            return tuple(bi - axi for bi, axi in zip(b, ax))
        if isinstance(expr, base.Multiplication):
            x = self.eval_function(expr.operand2)
            return self.apply_operator(expr.operand1, x)
        if isinstance(expr, base.Addition):
            a = self.eval_function(expr.operand1)
            b = self.eval_function(expr.operand2)
            return tuple(ai + bi for ai, bi in zip(a, b))
        if isinstance(expr, base.Subtraction):
            a = self.eval_function(expr.operand1)
            b = self.eval_function(expr.operand2)
            return tuple(ai - bi for ai, bi in zip(a, b))
        if isinstance(expr, base.Scaling):
            x = self.eval_function(expr.operand)
            return tuple(expr.factor * xi for xi in x)
        if isinstance(expr, (system.Approximation, base.Approximation)):
            raise KeyError(f"unbound grid function {expr}")
        raise NotImplementedError(f"cannot evaluate {type(expr).__name__} as function")

    # -- cycles ------------------------------------------------------------

    def eval_cycle(self, cycle: base.Cycle):
        omega = self.omegas[cycle.global_id]
        x = self.eval_function(cycle.approximation)
        if self._is_smoother(cycle.correction):
            nl = self._nonlinear_smoother_parts(cycle.correction)
            if nl is not None:
                return self._nonlinear_smooth(cycle, x, omega, nl)
            halo_out = self._try_halo_smoother(cycle, x, omega)
            if halo_out is not None:
                return halo_out
            if cycle.partitioning is part.RedBlack:
                return self._red_black_sweep(cycle, x, omega)
        c = self.eval_function(cycle.correction)
        return tuple(xi + omega * ci for xi, ci in zip(x, c))

    @staticmethod
    def _pointwise_smoother_entry(cycle):
        """(scalar operator entry, residual) when the cycle is a
        pointwise-diagonal smoother u + w*D^-1*(b - A u) of a scalar
        (1x1-system) operator — the shared preamble of the halo-pipeline
        smoother patterns.  None otherwise."""
        corr = cycle.correction
        L = corr.operand1.operand
        residual = corr.operand2
        if residual.approximation is not cycle.approximation:
            return None
        if not isinstance(L, (system.Diagonal, system.ElementwiseDiagonal,
                              base.Diagonal)):
            return None
        A = residual.operator
        entry = A
        if isinstance(A, system.Operator):
            if len(A.entries) != 1:
                return None
            entry = A.entries[0][0]
        if not isinstance(entry, base.Operator):
            return None
        return entry, residual

    def _star_smoother_parts(self, cycle, x):
        """(stencil_vals, b) when the cycle is a pointwise-diagonal smoother
        of a scalar constant star operator — 5-point in 2D, 7-point in 3D.
        Returns None otherwise."""
        found = self._pointwise_smoother_entry(cycle)
        if found is None:
            return None
        entry, residual = found
        if _nonlinear_of(entry) is not None or \
                _stencil_field_of(entry) is not None:
            return None
        st = entry.generate_stencil()
        if not isinstance(st, constant.Stencil):
            return None
        if x[0].ndim == 2:
            vals = stencil_values.five_point_values(st)
        elif x[0].ndim == 3:
            vals = stencil_values.seven_point_values(st)
        else:
            return None
        if vals is None or vals[0] == 0.0:
            return None
        b = self.eval_function(residual.rhs)[0]
        return vals, b

    def _var_smoother_parts(self, cycle, x):
        """(coefficient stack, b) when the cycle is a pointwise-diagonal
        smoother of a scalar variable-coefficient 5-point operator
        (StencilField form).  None otherwise."""
        found = self._pointwise_smoother_entry(cycle)
        if found is None:
            return None
        entry, residual = found
        if _nonlinear_of(entry) is not None:
            return None
        sf = _stencil_field_of(entry)
        if sf is None or x[0].ndim != 2:
            return None
        key = ("var_stack", id(sf), str(x[0].dtype))
        if key not in self.memo:
            self.memo[key] = stencil_values.five_point_stack(sf, x[0].dtype)
        stack = self.memo[key]
        if stack is None:
            return None
        b = self.eval_function(residual.rhs)[0]
        return stack, b

    def _cx_smoother_parts(self, cycle, x):
        """(complex stencil values, b) when the cycle is a
        pointwise-diagonal smoother of a scalar constant COMPLEX 5-point
        operator (Helmholtz shifted-Laplace)."""
        found = self._pointwise_smoother_entry(cycle)
        if found is None:
            return None
        entry, residual = found
        if _nonlinear_of(entry) is not None or x[0].ndim != 2:
            return None
        if _stencil_field_of(entry) is not None:
            # variable coefficients (Robin-folded boundary columns): a
            # constant-stencil sweep would compute the residual with the
            # interior stencil everywhere — wrong on the boundary columns
            return None
        st = entry.generate_stencil()
        if not isinstance(st, constant.Stencil):
            return None
        vals = stencil_values.complex_five_point_values(st)
        if vals is None or vals[0] == 0:
            return None
        b = self.eval_function(residual.rhs)[0]
        return vals, b

    def _sys_smoother_parts(self, cycle, x):
        """(coeffs, minv, b) when the cycle is a pointwise smoother of an
        FxF block system whose entries are uniform stencils inside the
        3x3 offset box (linear elasticity).  minv is the constant FxF
        point-solve matrix: inverse of the center-coefficient matrix
        (ElementwiseDiagonal) or of its diagonal (Diagonal)."""
        corr = cycle.correction
        L = corr.operand1.operand
        residual = corr.operand2
        if residual.approximation is not cycle.approximation:
            return None
        if not isinstance(L, (system.Diagonal, system.ElementwiseDiagonal)):
            return None
        A = residual.operator
        if not isinstance(A, system.Operator):
            return None
        F = len(A.entries)
        if F < 2 or len(x) != F or any(len(r) != F for r in A.entries):
            return None
        if x[0].ndim != 2:
            return None
        coeffs = _sys_nine_table(A)
        if coeffs is None:
            return None
        kind = "diag" if isinstance(L, system.Diagonal) else "elem"
        minv = self._sys_minv(coeffs, kind)
        if minv is None:
            return None
        b = self.eval_function(residual.rhs)
        if len(b) != F:
            return None
        return coeffs, minv, b

    def _try_halo_smoother(self, cycle, x, omega):
        """Smoother sweep through the shard_map halo pipeline
        (parallel/halo.py) when a mesh is configured and the smoother has
        one of the patterns it implements.  Returns None for the generic
        path."""
        from ..config import config
        mesh = config.shard_map_mesh
        if mesh is None:
            return None
        red_black = cycle.partitioning is part.RedBlack
        if not red_black and cycle.partitioning is not part.Single:
            return None
        from ..parallel import halo
        if not halo.supports(mesh, x[0]):
            return None
        parts = self._star_smoother_parts(cycle, x)
        if parts is not None:
            vals, b = parts
            om = jnp.asarray(omega, x[0].dtype)
            return (halo.sweep(mesh, x[0], b, om, vals, 1.0 / vals[0],
                               red_black=red_black),)
        if x[0].ndim != 2:
            return None
        cparts = self._cx_smoother_parts(cycle, x)
        if cparts is not None:
            vals, b = cparts
            return (halo.sweep(mesh, x[0], b, omega, vals, 1.0 / vals[0],
                               red_black=red_black),)
        vparts = self._var_smoother_parts(cycle, x)
        if vparts is not None:
            stack, b = vparts
            om = jnp.asarray(omega, x[0].dtype)
            return (halo.sweep_var(mesh, x[0], b, om, stack,
                                   red_black=red_black),)
        sparts = self._sys_smoother_parts(cycle, x)
        if sparts is not None:
            coeffs, minv, b = sparts
            om = jnp.asarray(omega, x[0].dtype)
            return halo.sweep_sys(mesh, x, b, om, coeffs, minv,
                                  red_black=red_black)
        return None

    @staticmethod
    def _nonlinear_smoother_parts(corr):
        """(generator, entry, mode, n_steps) for a nonlinear smoother
        correction, else None.  mode: 'picard' (frozen coefficient) or
        'newton' (Jacobian denominator, reference ir/smoother.py:41-46)."""
        A = corr.operand2.operator
        nl = _nonlinear_of(A)
        if nl is None:
            return None
        L = corr.operand1.operand
        if isinstance(L, base.Addition) and \
                isinstance(L.operand2, system.Jacobian):
            return nl + ("newton", L.operand2.n_newton_steps)
        return nl + ("picard", 1)

    def _nonlinear_smooth(self, cycle, x, omega, nl):
        """Damped Newton-/Picard-Jacobi sweep(s):
        u <- u + w * mask * (b - A(u)) / (diag(L) + d(u))
        (reference FAS_2D_Basic_template.exa4 Smoother; RB coloring applies
        the same update in two masked half-sweeps)."""
        gen, entry, mode, n_steps = nl
        corr = cycle.correction
        b = self.eval_function(corr.operand2.rhs)[0]
        st = periodic.as_periodic(entry.generate_stencil())
        diag_lin = periodic.diagonal(st)
        diag_val = diag_lin.to_constant().value_at(
            (0,) * entry.grid.dimension) if diag_lin.is_constant else None
        u = x[0]
        if cycle.partitioning is part.RedBlack:
            masks = red_black_masks(tuple(entry.grid.size), self.dtype)
        else:
            masks = (jnp.ones(tuple(entry.grid.size), self.dtype),)

        def denom(u):
            if mode == "newton":
                d_nl = gen.nonlinear_derivative(u)
            else:
                d_nl = gen.nonlinear_coefficient(u)
            if diag_val is not None:
                return jnp.asarray(diag_val, u.dtype) + d_nl
            return ops.apply_stencil(diag_lin, jnp.ones_like(u)) + d_nl

        for _ in range(max(int(n_steps), 1)):
            for mask in masks:
                r = b - (ops.apply_stencil(st, u) + gen.nonlinear_term(u))
                u = u + omega * mask * (r / denom(u))
        return (u,)

    @staticmethod
    def _sys_minv(coeffs, kind):
        """Constant FxF point-solve matrix of a 9-point block system, or
        None."""
        F = len(coeffs)
        centers = np.array([[coeffs[i][j][0] for j in range(F)]
                            for i in range(F)])
        if kind == "diag":
            d = np.diag(centers)
            if np.any(d == 0.0):
                return None
            minv = np.diag(1.0 / d)
        else:
            if abs(np.linalg.det(centers)) < 1e-30:
                return None
            minv = np.linalg.inv(centers)
        return tuple(tuple(float(v) for v in r) for r in minv)


    @staticmethod
    def _is_smoother(corr) -> bool:
        return (isinstance(corr, base.Multiplication)
                and isinstance(corr.operand1, base.Inverse)
                and isinstance(corr.operand2, base.Residual))

    def _red_black_sweep(self, cycle: base.Cycle, x, omega):
        corr = cycle.correction
        inverse_op = corr.operand1
        residual = corr.operand2
        b = self.eval_function(residual.rhs)
        A = residual.operator
        masks = [red_black_masks(tuple(g.size), self.dtype)
                 for g in field_grids(cycle)]

        def half(u, color):
            r = tuple(bi - ai for bi, ai in zip(b, self.apply_operator(A, u)))
            c = self.apply_operator(inverse_op, r)
            return tuple(ui + omega * m[color].astype(ui.dtype) * ci
                         for ui, ci, m in zip(u, c, masks))

        u1 = half(x, 0)   # red half-sweep first
        return half(u1, 1)  # black with refreshed red values

    # -- operators ----------------------------------------------------------

    def apply_operator(self, expr, fields: Tuple):
        if isinstance(expr, base.Inverse):
            return self.apply_inverse(expr.operand, fields)
        if isinstance(expr, base.CoarseGridSolver):
            return self.apply_coarse_solver(expr, fields)
        if isinstance(expr, KrylovSubspaceMethod):
            matvec = lambda v: self.apply_operator(expr.operator, v)
            return solvers.FIXED_KRYLOV[expr.name](matvec, fields, expr.iterations)
        if isinstance(expr, system.Restriction) or (
                isinstance(expr, base.Restriction) and not isinstance(expr, base.ZeroRestriction)):
            return self._apply_restriction(expr, fields)
        if isinstance(expr, system.Prolongation) or (
                isinstance(expr, base.Prolongation) and not isinstance(expr, base.ZeroProlongation)):
            return self._apply_prolongation(expr, fields)
        if isinstance(expr, system.Operator):
            return self._apply_system(expr, fields)
        if isinstance(expr, base.ZeroOperator):
            return tuple(jnp.zeros_like(f) for f in fields)
        if isinstance(expr, base.Identity):
            return fields
        if isinstance(expr, base.Operator):
            nl = _nonlinear_of(expr)
            if nl is not None:
                gen, entry = nl
                st = entry.generate_stencil()
                lin = ops.apply_stencil(periodic.as_periodic(st), fields[0])
                return (lin + gen.nonlinear_term(fields[0]),)
            sf = _stencil_field_of(expr)
            if sf is not None:
                return (sf.apply(fields[0]),)
            st = expr.generate_stencil()
            return (ops.apply_stencil(periodic.as_periodic(st), fields[0]),)
        if isinstance(expr, (system.Diagonal, system.ElementwiseDiagonal,
                             base.Diagonal, base.LowerTriangle,
                             base.UpperTriangle, base.BlockDiagonal)):
            return self._apply_stencil_expr(expr, fields)
        if isinstance(expr, base.Multiplication):
            return self.apply_operator(expr.operand1,
                                       self.apply_operator(expr.operand2, fields))
        if isinstance(expr, base.Addition):
            a = self.apply_operator(expr.operand1, fields)
            b = self.apply_operator(expr.operand2, fields)
            return tuple(ai + bi for ai, bi in zip(a, b))
        if isinstance(expr, base.Subtraction):
            a = self.apply_operator(expr.operand1, fields)
            b = self.apply_operator(expr.operand2, fields)
            return tuple(ai - bi for ai, bi in zip(a, b))
        if isinstance(expr, base.Scaling):
            x = self.apply_operator(expr.operand, fields)
            return tuple(expr.factor * xi for xi in x)
        if isinstance(expr, base.Transpose):
            st = expr.generate_stencil()
            return (ops.apply_stencil(st, fields[0]),)
        raise NotImplementedError(f"cannot apply {type(expr).__name__}")

    def _apply_system(self, op: system.Operator, fields):
        out = []
        for row in op.entries:
            acc = None
            for entry, x in zip(row, fields):
                if isinstance(entry, base.ZeroOperator):
                    continue
                (y,) = self.apply_operator(entry, (x,))
                acc = y if acc is None else acc + y
            out.append(acc if acc is not None
                       else jnp.zeros(tuple(row[0].grid.size), self.dtype))
        return tuple(out)

    def _apply_stencil_expr(self, expr, fields):
        """Apply by materializing the expression's (periodic) stencil."""
        ps = periodic.as_periodic(expr.generate_stencil())
        if ps is None:
            raise NotImplementedError(f"no stencil for {type(expr).__name__}")
        return tuple(ops.apply_stencil(ps, f) for f in fields) \
            if len(fields) > 1 else (ops.apply_stencil(ps, fields[0]),)

    def _apply_restriction(self, expr, fields):
        entries = expr.entries if isinstance(expr, system.Restriction) else None
        ops_list = [row[i] for i, row in enumerate(entries)] if entries else [expr]
        out = []
        for op, x in zip(ops_list, fields):
            st = op.generate_stencil()
            out.append(ops.restrict(st, x))
        return tuple(out)

    def _apply_prolongation(self, expr, fields):
        entries = expr.entries if isinstance(expr, system.Prolongation) else None
        ops_list = [row[i] for i, row in enumerate(entries)] if entries else [expr]
        out = []
        for op, x in zip(ops_list, fields):
            st = op.generate_stencil()
            out.append(ops.prolong(st, x, tuple(op.fine_grid.size)))
        return tuple(out)

    # -- inverses (smoother solves) -----------------------------------------

    def apply_inverse(self, L, fields):
        # decoupled point Jacobi: per-field diagonal reciprocal
        if isinstance(L, system.Diagonal):
            op = self._unwrap_operator(L.operand)
            out = []
            for i, x in enumerate(fields):
                entry = op.entries[i][i]
                sf = _stencil_field_of(entry)
                if sf is not None:
                    d = np.asarray(sf.diagonal_field())
                    dtype = jnp.promote_types(x.dtype, jnp.complex64) \
                        if np.iscomplexobj(d) else x.dtype
                    out.append(x.astype(dtype) / jnp.asarray(d, dtype=dtype))
                    continue
                ps = periodic.as_periodic(entry.generate_stencil())
                inv = periodic.inverse(periodic.diagonal(ps))
                out.append(ops.apply_stencil(inv, x))
            return tuple(out)
        # collective point Jacobi: m x m central-coefficient solve per point
        if isinstance(L, system.ElementwiseDiagonal):
            op = self._unwrap_operator(L.operand)
            return self._pointwise_collective_inverse(op, fields)
        # scalar diagonal
        if isinstance(L, base.Diagonal):
            ps = periodic.as_periodic(L.generate_stencil())
            inv = periodic.inverse(ps)
            return tuple(ops.apply_stencil(inv, f) for f in fields)
        # block-diagonal (collective or scalar block Jacobi)
        if isinstance(L, base.BlockDiagonal):
            ps = periodic.as_periodic(L.generate_stencil())
            plan = get_block_solve_plan([[ps]], L.block_size,
                                        tuple(L.grid.size))
            return plan.apply(fields)
        if isinstance(L, system.Operator):
            return self._system_local_inverse(L, fields)
        if isinstance(L, base.Operator):
            ps = periodic.as_periodic(L.generate_stencil())
            if ps is not None and periodic.is_diagonal(ps):
                return tuple(ops.apply_stencil(periodic.inverse(ps), f)
                             for f in fields)
            if ps is not None and not ps.is_constant:
                plan = get_block_solve_plan([[ps]], ps.period, tuple(L.grid.size))
                return plan.apply(fields)
        # triangular / general small: dense fallback
        return self._dense_solve(L, fields)

    @staticmethod
    def _unwrap_operator(expr):
        while not isinstance(expr, system.Operator):
            if isinstance(expr, base.UnaryExpression):
                expr = expr.operand
            else:
                raise NotImplementedError(
                    f"cannot locate system operator under {type(expr).__name__}")
        return expr

    def _pointwise_collective_inverse(self, op: system.Operator, fields):
        m = len(op.entries)
        if m == 1:
            entry = op.entries[0][0]
            sf = _stencil_field_of(entry)
            if sf is not None:
                d = np.asarray(sf.diagonal_field())
                x = fields[0]
                dtype = jnp.promote_types(x.dtype, jnp.complex64) \
                    if np.iscomplexobj(d) else x.dtype
                return (x.astype(dtype) / jnp.asarray(d, dtype=dtype),)
            ps = periodic.as_periodic(entry.generate_stencil())
            inv = periodic.inverse(periodic.diagonal(ps))
            return (ops.apply_stencil(inv, fields[0]),)
        # pointwise-varying central coefficients (boundary-folded
        # operators, e.g. split-complex Helmholtz Robin columns): solve
        # the m x m system per grid point with the true local diagonal —
        # the reference's `solve locally` uses the folded operator too
        sfs = [[_stencil_field_of(op.entries[i][j]) for j in range(m)]
               for i in range(m)]
        if any(sf is not None for row in sfs for sf in row):
            return self._pointwise_varying_inverse(op, sfs, fields)
        # constant central coefficients -> single m x m inverse
        D = np.zeros((m, m), dtype=np.complex128)
        is_complex = False
        for i in range(m):
            for j in range(m):
                ps = periodic.as_periodic(op.entries[i][j].generate_stencil())
                if ps is None:
                    continue
                if not ps.is_constant:
                    raise NotImplementedError(
                        "periodic collective point smoother not supported yet")
                v = ps.to_constant().value_at((0,) * ps.dimension, 0)
                if isinstance(v, complex):
                    is_complex = True
                D[i, j] = v
        if not is_complex:
            D = D.real
        Dinv = np.linalg.inv(D)
        out = []
        for i in range(m):
            acc = None
            for j in range(m):
                if Dinv[i, j] == 0:
                    continue
                term = jnp.asarray(Dinv[i, j], fields[j].dtype) * fields[j]
                acc = term if acc is None else acc + term
            out.append(acc if acc is not None else jnp.zeros_like(fields[i]))
        return tuple(out)

    def _pointwise_varying_inverse(self, op: system.Operator, sfs, fields):
        """Collective point solve with position-dependent central
        coefficients: D(x) y(x) = r(x) per grid point, D built from the
        entries' diagonal fields (constant entries broadcast).  Closed
        form for m == 2; batched linalg.solve otherwise."""
        m = len(op.entries)
        shape = fields[0].shape
        dtype = fields[0].dtype
        d = [[None] * m for _ in range(m)]
        for i in range(m):
            for j in range(m):
                sf = sfs[i][j]
                if sf is not None:
                    arr = np.asarray(sf.diagonal_field())
                else:
                    ps = periodic.as_periodic(
                        op.entries[i][j].generate_stencil())
                    if ps is None:
                        arr = np.zeros(shape)
                    elif not ps.is_constant:
                        raise NotImplementedError(
                            "periodic collective point smoother not "
                            "supported yet")
                    else:
                        arr = np.full(
                            shape, ps.to_constant().value_at(
                                (0,) * ps.dimension, 0))
                if np.iscomplexobj(arr):
                    dtype = jnp.promote_types(dtype, jnp.complex64)
                d[i][j] = arr
        f = [x.astype(dtype) for x in fields]
        if m == 2:
            # precompute the 2x2 point-INVERSE entries in numpy at trace
            # time; boundary-folded operators make them constant except
            # on a couple of rows, so the per-sweep solve applies as four
            # scalar multiplies + O(n) row fixups instead of streaming
            # four full-grid matrices (ops/apply.py almost_uniform_desc)
            det = d[0][0] * d[1][1] - d[0][1] * d[1][0]
            minv = [[d[1][1] / det, -d[0][1] / det],
                    [-d[1][0] / det, d[0][0] / det]]
            out = []
            for i in range(2):
                acc = None
                fixups = []
                for j in range(2):
                    desc = ops.almost_uniform_desc(minv[i][j])
                    term, fixes = ops.almost_uniform_mul(
                        desc, minv[i][j], f[j], dtype)
                    fixups.extend(fixes)
                    acc = term if acc is None else acc + term
                for r_i, add in fixups:
                    acc = acc.at[r_i].add(add)
                out.append(acc)
            return tuple(out)
        d = [[jnp.asarray(a, dtype) for a in row] for row in d]
        D = jnp.stack([jnp.stack(row, axis=-1) for row in d], axis=-2)
        r = jnp.stack(f, axis=-1)[..., None]
        y = jnp.linalg.solve(D, r)[..., 0]
        return tuple(y[..., i] for i in range(m))

    def _system_local_inverse(self, op: system.Operator, fields):
        """Invert a system operator whose entries are block-diagonal periodic
        stencils (collective block Jacobi) or pointwise-diagonal stencils."""
        m = len(op.entries)
        stencils = [[periodic.as_periodic(e.generate_stencil()) for e in row]
                    for row in op.entries]
        periods = [ps.period for row in stencils for ps in row if ps is not None]
        # the plan's block lattice must tile every entry's period exactly:
        # per-axis lcm (a max would cut couplings of a period that does not
        # divide it, silently inverting a different operator than the IR's
        # block-diagonal restriction — per-field block shapes like (2,1)
        # and (3,1) hit this)
        lcm_period = tuple(reduce(math.lcm, (p[k] for p in periods), 1)
                           for k in range(len(periods[0])))
        all_diagonal = all(ps is None or periodic.is_diagonal(ps)
                           for row in stencils for ps in row)
        if all_diagonal and lcm_period == (1,) * len(lcm_period):
            return self._pointwise_collective_inverse(op, fields)
        shape = tuple(op.entries[0][0].grid.size)
        plan = get_block_solve_plan(stencils, lcm_period, shape)
        return plan.apply(fields)

    def _dense_solve(self, L, fields):
        n = sum(int(np.prod(f.shape)) for f in fields)
        if n > DIRECT_SOLVE_MAX:
            raise NotImplementedError(
                f"dense inverse fallback too large ({n} unknowns) for {L}")
        inv = dense_inverse(L) if isinstance(L, (system.Operator, base.Operator)) \
            else self._dense_inverse_of_expression(L, fields)
        return self._apply_dense(inv, fields)

    def _dense_inverse_of_expression(self, L, fields):
        grids = field_grids(L)
        ps = periodic.as_periodic(L.generate_stencil())
        if ps is None:
            raise NotImplementedError(f"cannot materialize {L}")
        K = ops.dense_matrix(ps, grids[0])
        return np.linalg.inv(K)

    def _apply_dense(self, inv: np.ndarray, fields):
        flat = jnp.concatenate([f.reshape(-1) for f in fields])
        # keep the field dtype, so an f32 cycle stays f32; promote only if
        # the inverse is complex and the field real.  HIGHEST: an f32
        # product may otherwise run in TF32 (~3 decimal digits) on the GPU,
        # which would turn the exact coarse solve into an inexact one
        dtype = flat.dtype
        if np.iscomplexobj(inv):
            dtype = jnp.promote_types(dtype, jnp.complex64)
        y = jnp.matmul(jnp.asarray(inv, dtype=dtype), flat.astype(dtype),
                       precision=jax.lax.Precision.HIGHEST)
        out = []
        o = 0
        for f in fields:
            k = int(np.prod(f.shape))
            out.append(y[o:o + k].reshape(f.shape))
            o += k
        return tuple(out)

    # -- coarse-grid solver ---------------------------------------------------

    def apply_coarse_solver(self, cgs: base.CoarseGridSolver, fields):
        if cgs.expression is not None:
            # evolved coarse solver: one application of the stored cycle
            if getattr(cgs.expression, "wants_omegas", False):
                return cgs.expression(fields, self.omegas)
            return cgs.expression(fields)
        if self.cgs_override is not None:
            # FAS chunk boundary: the coarse solve starts from the
            # restricted solution, not zero (reference FAS semantics,
            # exastencils_FAS.py:121-147) — evaluate the CGS node's
            # initial guess and hand it to the spliced coarser chunk
            u0 = None
            if getattr(cgs, "initial_guess", None) is not None:
                u0 = self.eval_function(cgs.initial_guess)
            return self.cgs_override(fields, self.omegas, u0)
        op = cgs.operator
        nl = _nonlinear_of(op)
        if nl is not None:
            u0 = None
            if getattr(cgs, "initial_guess", None) is not None:
                u0 = self.eval_function(cgs.initial_guess)[0]
            return self._nonlinear_coarse_solve(nl, fields, u0)
        n = sum(int(np.prod(g.size)) for g in field_grids(op))
        if n <= DIRECT_SOLVE_MAX:
            return self._apply_dense(dense_inverse(op), fields)
        matvec = lambda v: self.apply_operator(op, v)
        return solvers.cg(matvec, fields, tol=1e-12, maxiter=1000)

    def _nonlinear_coarse_solve(self, nl, fields, u0=None):
        """Coarsest nonlinear solve: fixed damped Newton-Jacobi sweeps
        (reference FAS_2D_Basic_template.exa4 CGS@coarsest, 200 sweeps),
        starting from the restricted solution when provided."""
        gen, entry = nl
        st = periodic.as_periodic(entry.generate_stencil())
        diag_val = periodic.diagonal(st).to_constant().value_at(
            (0,) * entry.grid.dimension)
        b = fields[0]

        def body(_, u):
            r = b - (ops.apply_stencil(st, u) + gen.nonlinear_term(u))
            d = jnp.asarray(diag_val, u.dtype) + gen.nonlinear_derivative(u)
            return u + NONLINEAR_CGS_OMEGA * (r / d)

        start = jnp.zeros_like(b) if u0 is None else u0
        u = jax.lax.fori_loop(0, NONLINEAR_CGS_SWEEPS, body, start)
        return (u,)


NONLINEAR_CGS_SWEEPS = 200   # reference FAS CGS@coarsest: 200 smoother sweeps
NONLINEAR_CGS_OMEGA = 0.8


def _find_fine_operator(root):
    """Locate the finest-level operator for residual computation."""
    res_nodes = transformations.find_nodes(root, base.Residual)
    fine_grids = field_grids(root)
    for r in res_nodes:
        if field_grids(r) == fine_grids or \
                [g.size for g in field_grids(r)] == [g.size for g in fine_grids]:
            return r.operator
    return None


def lower_cycle(root: base.Cycle, approximation, rhs) -> LoweredCycle:
    """Lower a cycle expression to a jit-compatible step function."""
    n = transformations.assign_cycle_ids(root)
    cycles = transformations.find_nodes(root, base.Cycle)
    default_omegas = np.array([float(c.relaxation_factor) for c in cycles])

    def step(u_fields, b_fields, omegas):
        lowering = _Lowering(approximation, rhs, omegas)
        lowering.bind(u_fields, b_fields)
        return lowering.eval_function(root)

    return LoweredCycle(step=step, n_omegas=n, default_omegas=default_omegas,
                        grids=field_grids(root),
                        operator=_find_fine_operator(root), expression=root)


@dataclass
class ChainLink:
    """One finished chunk of a level-chunked run: its best cycle expression
    and the grid-function entities it binds (reference: each chunk's best
    cycle function is appended to the solver program and the next run's
    coarse-grid calls resolve to it, optimization/program.py:890-898)."""
    root: base.Cycle
    approximation: object
    rhs: object


def make_chain_applier(root, approximation, rhs, inner=None):
    """Wrap a chunk cycle as ``fn(fields, omegas, initial_guess=None) ->
    fields`` starting from a zero initial guess (or ``initial_guess`` —
    the restricted solution a FAS chunk boundary hands down), with
    ``inner`` (same signature, or None) spliced into its unsolved
    CoarseGridSolver nodes.  The omegas vector is the composed program's
    full relaxation-factor vector, indexed by the global cycle ids
    previously assigned across all chunks (lower_composed)."""

    def applier(fields, omegas, initial_guess=None):
        lowering = _Lowering(approximation, rhs, omegas, cgs_override=inner)
        u0 = (tuple(initial_guess) if initial_guess is not None
              else tuple(jnp.zeros_like(f) for f in fields))
        lowering.bind(u0, tuple(fields))
        return lowering.eval_function(root)

    applier.wants_omegas = True
    return applier


def lower_composed(chain: List[ChainLink], cand_root: base.Cycle,
                   cand_approximation, cand_rhs) -> LoweredCycle:
    """Lower the full-program composition of a level-chunked run: the finer
    chunks' best cycles (``chain``, finest first) stacked so that each
    chunk's unsolved coarse-grid solve dispatches to the next, with the
    candidate coarse cycle innermost.

    This is the native counterpart of the reference's solver-program
    splicing (a coarser run's candidates are measured as the coarse-grid
    solver underneath the already-evolved finer cycles,
    optimization/program.py:810-899, exastencils.py:485-537).  Cycle ids are
    assigned chain-first, candidate last, so one omegas vector drives the
    whole program; the candidate's relaxation factors stay traced arguments
    and a population sharing the composed structure still batches into one
    vmapped program."""
    if not chain:
        return lower_cycle(cand_root, cand_approximation, cand_rhs)
    offset = 0
    for link in chain:
        offset = transformations.assign_cycle_ids(link.root, start=offset)
    n = transformations.assign_cycle_ids(cand_root, start=offset)
    all_cycles = [c for link in chain
                  for c in transformations.find_nodes(link.root, base.Cycle)]
    all_cycles += transformations.find_nodes(cand_root, base.Cycle)
    default_omegas = np.array([float(c.relaxation_factor)
                               for c in all_cycles])

    inner = make_chain_applier(cand_root, cand_approximation, cand_rhs)
    for link in reversed(chain[1:]):
        inner = make_chain_applier(link.root, link.approximation, link.rhs,
                                   inner)
    head = chain[0]

    def step(u_fields, b_fields, omegas):
        lowering = _Lowering(head.approximation, head.rhs, omegas,
                             cgs_override=inner)
        lowering.bind(u_fields, b_fields)
        return lowering.eval_function(head.root)

    return LoweredCycle(step=step, n_omegas=n, default_omegas=default_omegas,
                        grids=field_grids(head.root),
                        operator=_find_fine_operator(head.root),
                        expression=head.root)


def make_cycle_applier(root: base.Cycle, approximation, rhs,
                       omegas=None) -> Callable:
    """Wrap a lowered cycle as ``fn(rhs_fields) -> solution_fields`` with a
    zero initial guess — the form CoarseGridSolver.expression expects when an
    evolved coarser cycle serves as the coarse-grid solver (reference
    appends the coarse cycle function to the solver program,
    optimization/program.py:890-898)."""
    cycles = transformations.find_nodes(root, base.Cycle)
    if any(c.global_id is None for c in cycles):
        transformations.assign_cycle_ids(root)
        cycles = transformations.find_nodes(root, base.Cycle)
    if omegas is None:
        omegas = np.array([float(c.relaxation_factor) for c in cycles])

    def apply_fn(fields):
        lowering = _Lowering(approximation, rhs, jnp.asarray(omegas))
        u0 = tuple(jnp.zeros_like(f) for f in fields)
        lowering.bind(u0, tuple(fields))
        return lowering.eval_function(root)

    return apply_fn

def operator_applier(op) -> Callable:
    """Standalone applier for an operator expression (for outer residuals)."""
    def apply(fields, _lowering=_Lowering(None, None, None)):
        _lowering.dtype = fields[0].dtype
        return _lowering.apply_operator(op, tuple(fields))
    return apply
