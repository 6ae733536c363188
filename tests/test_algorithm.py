"""Algorithm-layer edge cases: verify_solution, cycling detection, failure
paths, combine width guard, intersection iterator semantics."""

import numpy as np
import pytest

import qpn_tpu as qt
from qpn_tpu.algorithm import (verify_solution, check_qp_convexity, _combine,
                               intersection_iter, solve_qep)
from qpn_tpu.geometry.poly import Poly, PolyUnion, from_box
from qpn_tpu.network import QP, Quadratic


def _qp(Q, q, cons, vars_):
    return QP(f=Quadratic(np.asarray(Q), np.asarray(q), 0.0),
              constraint_indices=cons, var_indices=vars_)


def test_verify_solution_interior_optimum():
    # min (x-1)^2 over R: optimal at x=1 with no constraints
    qp = _qp([[2.0]], [-2.0], [], [0])
    ret = verify_solution(qp, 1, [], [0], np.array([1.0]))
    assert ret.solution
    ret = verify_solution(qp, 1, [], [0], np.array([0.5]))
    assert not ret.solution


def test_verify_solution_active_constraint():
    # min x s.t. x >= 0: optimal at 0 with dual 1
    qp = _qp([[0.0]], [1.0], [1], [0])
    box = Poly(np.array([[1.0]]), [0.0], [np.inf])
    ret = verify_solution(qp, 1, [box], [0], np.array([0.0]))
    assert ret.solution
    assert ret.lam[0] == pytest.approx(1.0, abs=1e-6)
    # x=1 is feasible but suboptimal
    ret = verify_solution(qp, 1, [box], [0], np.array([1.0]))
    assert not ret.solution
    # infeasible point
    ret = verify_solution(qp, 1, [box], [0], np.array([-1.0]))
    assert not ret.solution
    assert "infeasible" in ret.e


def test_verify_feas_tol_option():
    """The feasibility gate is a real option: the
    reference hardcodes 1e-3 and misreports options.tol in the message
    (qp_processing.jl:86-89); here the default keeps the 1e-3 behavior but
    the gate is configurable and the message reports the tolerance USED."""
    from qpn_tpu.algorithm import verify_solutions_batch
    from qpn_tpu.options import QPNetOptions
    qp = _qp([[0.0]], [1.0], [1], [0])
    box = Poly(np.array([[1.0]]), [0.0], [np.inf])
    x = np.array([-1e-4])        # infeasible by 1e-4
    # default gate (1e-3, reference parity): the point passes feasibility
    assert verify_solution(qp, 1, [box], [0], x).solution
    # tightened gate: rejected, and the message quotes the REAL gate
    ret = verify_solution(qp, 1, [box], [0], x, feas_tol=1e-6)
    assert not ret.solution
    assert "1e-06" in ret.e
    # batch variant honors the same knob
    ret_b = verify_solutions_batch([(qp, [box], [0])], x, feas_tol=1e-6)[0]
    assert not ret_b.solution and "1e-06" in ret_b.e
    # the option exists with the parity default
    assert QPNetOptions().verify_feas_tol == 1e-3


def test_check_qp_convexity_raises():
    A = np.array([[1.0]])
    with pytest.raises(RuntimeError, match="not convex"):
        check_qp_convexity(np.array([[-2.0]]), A, np.array([0.0]),
                           np.array([1.0]), [0], 9)
    # nullspace-restricted convexity: indefinite Q but equality pins the
    # concave direction
    Q = np.diag([-2.0, 2.0])
    A = np.array([[1.0, 0.0]])
    check_qp_convexity(Q, A, np.array([0.5]), np.array([0.5]), [0, 1], 9)


def test_cycling_detection():
    qpn = qt.setup("simple_bilevel")
    qpn.options.perturb_to_continue = False   # reference error-path parity
    qpn.iterate_cache[1] = []
    x = np.array([1.0, 2.0, 3.0, 4.0])
    # seed the cache with the projection of x, then solve from x with the
    # same projections -> cycling detected immediately
    rng = np.random.default_rng(0)
    proj = [rng.standard_normal(4) for _ in range(4)]
    qpn.iterate_cache[1] = [np.array([x @ v for v in proj])]
    from qpn_tpu.algorithm import solve_base
    ret = solve_base(qpn, x, proj_vectors=proj,
                     rng=np.random.default_rng(1))
    assert not ret.solved
    assert "Cycling" in str(ret.error)


def test_cycling_perturb_recovery():
    """With perturb_to_continue (the reference's disabled branch wired
    live), a seeded cycle is escaped by nudging non-level variables."""
    qpn = qt.setup("simple_bilevel")
    assert qpn.options.perturb_to_continue
    x = np.array([1.0, 2.0, 3.0, 4.0])
    rng = np.random.default_rng(0)
    proj = [rng.standard_normal(4) for _ in range(4)]
    qpn.iterate_cache[1] = [np.array([x @ v for v in proj])]
    from qpn_tpu.algorithm import solve_base
    ret = solve_base(qpn, x, proj_vectors=proj,
                     rng=np.random.default_rng(1))
    assert ret.solved


def test_combine_width_guard():
    # >3 unions with total width >20 must abort (qp_processing.jl:281-285)
    big_union = PolyUnion([from_box([float(i)], [i + 1.0])
                           for i in range(6)])
    regions = [from_box([0.0], [10.0]) for _ in range(4)]
    sols = [big_union] * 4
    with pytest.raises(RuntimeError, match="Too many"):
        list(_combine(regions, sols, np.array([0.5])))


def test_combine_single_union_shortcut():
    pu = PolyUnion([from_box([0.0], [1.0])])
    out = _combine([from_box([0.0], [1.0])], [pu], np.array([0.5]))
    assert len(list(out)) == 1


def test_intersection_iter_prunes_and_redzone():
    # two unions, each = {solution piece, complement piece}; red_lengths = 1
    # each; the all-complement combo must be excluded.
    sol_a = from_box([0.0], [1.0])
    comp_a = from_box([1.0], [2.0])
    sol_b = from_box([0.5], [1.5])
    comp_b = from_box([-1.0], [0.5])
    pus = [PolyUnion([sol_a, comp_a]), PolyUnion([sol_b, comp_b])]
    center = np.array([0.5])
    out = list(intersection_iter(pus, [1, 1], center))
    # combos: (sol_a,sol_b) ok; (sol_a,comp_b) ok (touches 0.5);
    # (comp_a,*) pruned (0.5 not in closure); (comp_a,comp_b) redzone anyway
    assert 1 <= len(out) <= 2
    for p in out:
        assert p.closure().contains(center)


def test_solve_qep_single_player_matches_qp():
    """QEP of a single unconstrained player = its QP optimum."""
    qpn = qt.setup("simple_bilevel")
    x = np.array([1.0, 2.0, 0.0, 0.0])
    # player 2 (leader) with child solution graph = follower fixed at y=x
    S = {1: Poly(np.array([[0.0, 0.0, 1.0, -1.0]]), [0.0], [0.0])}
    x_opt = solve_qep(qpn, [2], x, S)
    # leader minimizes (x-w1)^2 + (y-w2)^2 s.t. y=x -> x=y=(w1+w2)/2
    assert np.allclose(x_opt[2:], [1.5, 1.5], atol=1e-6)


def test_eliminate_variables():
    from qpn_tpu.geometry import eliminate_variables
    # x + y = 1, 0 <= x <= 1, eliminate y
    p = Poly(np.array([[1.0, 1.0], [1.0, 0.0]]), [1.0, 0.0], [1.0, 1.0])
    out = eliminate_variables(p, [1])
    # result lives on the keep coordinates (x): [0, 1]
    assert out.dim == 1
    assert out.contains(np.array([0.5]))
    assert not out.contains(np.array([1.5]))


def test_get_single_solution_runs():
    from qpn_tpu.enumeration import get_single_solution
    from qpn_tpu.ops.avi import GAVI
    g = GAVI(M=np.array([[2.0, -1.0]]), N=np.array([[-2.0]]),
             o=np.array([0.0]),
             l1=np.array([-np.inf]), u1=np.array([np.inf]),
             A=np.array([[1.0, 0.0]]), B=np.array([[0.0]]),
             l2=np.array([0.0]), u2=np.array([np.inf]))
    piece, x, reduced, z = get_single_solution(
        g, np.array([2.0, 0.0]), np.array([2.0]), 0, 0, [0], [1],
        np.random.default_rng(0))
    assert piece.m >= 1
    assert np.allclose(x, [2.0, 2.0])


def test_convexity_audit_per_combo():
    """Reference semantics audit convexity PER child-piece combination
    (check_qp_convexity runs inside verify_solution with the child polys
    appended, qp_processing.jl:69): a Q indefinite on the base nullspace but
    PSD on every combo's (smaller) nullspace must pass; it must still raise
    when some combo leaves the bad direction free."""
    import pytest
    from types import SimpleNamespace
    from qpn_tpu.algorithm import _audit_convexity
    from qpn_tpu.geometry.poly import Poly
    from qpn_tpu.network import Quadratic

    Q = np.diag([1.0, -1.0])
    qp = SimpleNamespace(f=Quadratic(Q, np.zeros(2), 0.0))
    x = np.zeros(2)
    box = Poly(np.eye(2), np.full(2, -1.0), np.full(2, 1.0))
    pin_y = Poly(np.array([[0.0, 1.0]]), np.zeros(1), np.zeros(1))

    # base audit fails (y free), but the only combo pins y=0 -> PSD reduced
    _audit_convexity(qp, 1, x, [0, 1], [box], [[box, pin_y]])

    with pytest.raises(RuntimeError, match="not convex"):
        _audit_convexity(qp, 1, x, [0, 1], [box], [[box], [box, pin_y]])


class TestMinNormSharedVariableMode:
    """shared_variable_mode=MIN_NORM consumer: the
    reference's live solve_qep accepts and DROPS the flag (avi.jl:387-390);
    its semantics live in deprecated/avi.jl:148-369 — re-solve restricted to
    the local solution piece minimizing the solution-graph duals' norm."""

    def test_min_norm_changes_psi_on_degenerate_duals(self):
        """Duplicated constraint rows make the equilibrium duals ψ a
        degenerate affine set; MIN_NORM must pick the minimum-norm
        representative (equal split), changing ψ from the solver's
        arbitrary landing point."""
        import numpy as np
        from qpn_tpu.algorithm import min_norm_revise_qep
        from qpn_tpu.ops.avi import GAVI, convert_gavi, check_avi_solution

        # min ½x² − 2x  s.t.  x ≤ 1 stated TWICE: at x*=1 the duals obey
        # ψ1+ψ2 = −1, ψᵢ ≤ 0 (the framework's −Aᵀψ stationarity layout,
        # create_labeled_gavi_from_qp) — any split solves the GAVI
        gavi = GAVI(
            M=np.array([[1.0, -1.0, -1.0]]),
            N=np.zeros((1, 0)), o=np.array([-2.0]),
            l1=np.array([-np.inf]), u1=np.array([np.inf]),
            A=np.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]]),
            B=np.zeros((2, 0)),
            l2=np.array([-np.inf, -np.inf]), u2=np.array([1.0, 1.0]))
        w = np.zeros(0)
        # start interior to the degenerate dual face (both rows active
        # with nonzero duals) so the LOCAL piece — MIN_NORM revises within
        # one piece, like the reference's deprecated flow — contains the
        # whole ψ1+ψ2=−1, ψ≤0 segment
        z_lopsided = np.array([1.0, -0.9, -0.1])   # a valid but extreme ψ
        ok, bad, _ = check_avi_solution(convert_gavi(gavi),
                                        np.concatenate([z_lopsided, [1, 1]]),
                                        w)
        assert ok, f"test premise: z_lopsided must solve the GAVI ({bad})"
        z_rev = min_norm_revise_qep(gavi, [1, 2], z_lopsided, w)
        assert abs(z_rev[0] - 1.0) <= 1e-6          # x* unchanged
        assert abs(z_rev[1] + z_rev[2] + 1.0) <= 1e-6   # still stationary
        psi0 = np.linalg.norm(z_lopsided[1:])
        psi1 = np.linalg.norm(z_rev[1:])
        assert psi1 < psi0 - 1e-3                   # ψ actually changed
        assert abs(z_rev[1] - z_rev[2]) <= 1e-5     # the equal split

    def test_min_norm_end_to_end_preserves_golden_solution(self):
        """solve() under MIN_NORM reproduces the simple_bilevel golden
        point, and a direct QEP step under MIN_NORM routes through the
        full-GAVI path (no potential fast path) and runs the revision hook."""
        import numpy as np
        import qpn_tpu as qt
        from qpn_tpu.options import SharedVariableMode
        from qpn_tpu.utils.metrics import METRICS

        qpn = qt.setup("simple_bilevel", gen_solution_map=True)
        qpn.options.shared_variable_mode = SharedVariableMode.MIN_NORM
        ret = qt.solve(qpn, np.array([0.0, 1.0, 0.0, 0.0]))
        assert ret.solved
        assert np.allclose(ret.x_opt[2:], [0.5, 0.5], atol=1e-4)

        # deterministic QEP step (the solve above may route through the
        # chain sweep, which needs no QEP iteration at all): leader with a
        # child solution graph, MIN_NORM set -> revision must run
        c0 = METRICS.counters.get("min_norm_revised", 0)
        f0 = METRICS.counters.get("qep_potential_fastpath", 0)
        x = np.array([1.0, 2.0, 0.0, 0.0])
        S = {1: Poly(np.array([[0.0, 0.0, 1.0, -1.0]]), [0.0], [0.0])}
        x_opt = solve_qep(qpn, [2], x, S)
        assert np.allclose(x_opt[2:], [1.5, 1.5], atol=1e-6)
        assert METRICS.counters.get("min_norm_revised", 0) > c0
        assert METRICS.counters.get("qep_potential_fastpath", 0) == f0
