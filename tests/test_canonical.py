"""Structure canonicalization: zero-omega
sweep padding makes sweep count a traced value — padded programs are
exact, and individuals differing only in sweep counts share one
compiled program."""

import numpy as np
import jax
import pytest

from evostencils_tpu.problems.poisson import poisson_2d
from evostencils_tpu.grammar.multigrid import generate_primitive_set
from evostencils_tpu.grammar.seeds import v_cycle_string
from evostencils_tpu.grammar import gp
from evostencils_tpu.ir import base, transformations
from evostencils_tpu.compiler import canonical
from evostencils_tpu.compiler.lower import lower_cycle
from evostencils_tpu.evaluation.evaluator import CycleEvaluator, structure_key


def _problem():
    p = poisson_2d(max_level=6, min_level=3)
    p.dtype = np.float64
    return p


def _expr(problem, pset, s):
    tree = gp.parse_tree(s, pset)
    expr = gp.compile_tree(tree, pset)[0]
    transformations.assign_cycle_ids(expr)
    return expr


def test_padding_is_exact_identity():
    problem = _problem()
    pset, _ = generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)
    s = v_cycle_string(3, 6, pre=1, post=1)
    b = problem.build_rhs()
    u0 = tuple(np.zeros_like(np.asarray(x)) for x in b)

    ref_expr = _expr(problem, pset, s)
    low = lower_cycle(ref_expr, problem.approximation, problem.rhs_entity)
    om = np.asarray(low.default_omegas)
    u_ref = low.step(u0, b, om)

    pad_expr = _expr(problem, pset, s)
    inserted = canonical.pad_smoother_chains(pad_expr)
    assert inserted > 0
    transformations.assign_cycle_ids(pad_expr)
    low_pad = lower_cycle(pad_expr, problem.approximation, problem.rhs_entity)
    om_pad = np.asarray(low_pad.default_omegas)
    assert len(om_pad) == len(om) + inserted
    assert np.count_nonzero(om_pad == 0.0) == inserted
    u_pad = low_pad.step(u0, b, om_pad)
    for a, c in zip(u_ref, u_pad):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_sweep_counts_share_signature():
    problem = _problem()
    pset, _ = generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)
    variants = [v_cycle_string(3, 6, pre=p, post=q)
                for p, q in ((1, 1), (2, 1), (2, 2))]
    # distinct structure keys before canonicalization
    assert len({structure_key(gp.parse_tree(s, pset)) for s in variants}) == 3
    sigs = set()
    for s in variants:
        expr = _expr(problem, pset, s)
        canonical.pad_smoother_chains(expr)
        sigs.add(canonical.signature(expr))
    assert len(sigs) == 1


def test_population_results_unchanged_by_canonicalization():
    problem = _problem()
    pset, _ = generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)
    pop = [gp.parse_tree(v_cycle_string(3, 6, pre=p, post=q, omega=om), pset)
           for (p, q, om) in ((1, 1, 1.15), (2, 1, 1.15), (2, 2, 0.8))]

    ev_plain = CycleEvaluator(problem)
    plain = ev_plain.evaluate_population(list(pop), pset)

    ev_canon = CycleEvaluator(problem)
    ev_canon.canonicalize = True
    canon = ev_canon.evaluate_population(list(pop), pset)

    assert ev_canon.canonical_collapse == (3, 1)
    assert ev_canon.compilations < ev_plain.compilations
    for a, c in zip(plain, canon):
        assert a.iterations == c.iterations
        # plain groups of 1 run the unbatched solver while the merged
        # group runs the vmapped one — XLA reduction reassociation moves
        # the measured factor at the 1e-5 level (padding itself is exact,
        # see test_padding_is_exact_identity)
        assert a.convergence_factor == pytest.approx(c.convergence_factor,
                                                     rel=1e-3)
