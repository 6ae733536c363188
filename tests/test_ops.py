"""Unit tests for the batched QP (OSQP-role) and AVI (PATH-role) kernels."""

import numpy as np
import pytest

from qpn_tpu.ops import batch_qp
from qpn_tpu.ops.avi import (AVI, GAVI, Status, convert_gavi, solve_avi,
                             solve_gavi, solve_avi_batch, check_avi_solution,
                             relax_gavi, find_closest_feasible)


# ------------------------------ QP kernel ---------------------------------

def test_qp_projection():
    c = np.array([2.0, -1.0, 0.5])
    sol = batch_qp.solve_qp_np(np.eye(3), -c, np.eye(3),
                               np.zeros(3), np.ones(3))
    assert sol.status in (1, 2)
    assert np.allclose(sol.x, np.clip(c, 0, 1), atol=1e-6)


def test_lp_vertex():
    sol = batch_qp.solve_qp_np(
        np.zeros((2, 2)), np.array([-1.0, -1.0]),
        np.array([[1.0, 0], [0, 1.0], [1.0, 1.0]]),
        np.array([0.0, 0.0, -np.inf]), np.array([np.inf, np.inf, 1.0]))
    assert sol.status in (1, 2)
    assert abs(sol.obj + 1.0) < 1e-6


def test_badly_scaled_lp():
    """The certificate LP from robust_avoid_simple stalled pre-Ruiz; the
    equilibrated kernel must solve rows with norms spanning 1..10."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((10, 3)) * np.array([1.0, 5.0, 10.0])
    x0 = rng.standard_normal(3)
    b = A @ x0
    sol = batch_qp.solve_qp_np(np.zeros((3, 3)), np.array([0, 0, 1.0]),
                               A, b - 1.0, b + 1.0)
    assert sol.status in (1, 2), sol.status
    assert sol.prim_res < 1e-6 and sol.dual_res < 1e-6


def test_infeasible_certificate():
    sol = batch_qp.solve_qp_np(np.zeros((1, 1)), np.zeros(1),
                               np.array([[1.0], [1.0]]),
                               np.array([-np.inf, 1.0]),
                               np.array([0.0, np.inf]))
    assert sol.status == batch_qp.PRIMAL_INFEASIBLE


def test_unbounded_certificate():
    sol = batch_qp.solve_qp_np(np.zeros((1, 1)), np.array([1.0]),
                               np.array([[1.0]]), np.array([-np.inf]),
                               np.array([0.0]))
    assert sol.status == batch_qp.DUAL_INFEASIBLE


def test_batch_random_qps(rng):
    B, n, m = 32, 5, 8
    Ps, qs, As, ls, us = [], [], [], [], []
    for _ in range(B):
        G = rng.standard_normal((n, n))
        Ps.append(G @ G.T + 0.5 * np.eye(n))
        As.append(rng.standard_normal((m, n)))
        x0 = rng.standard_normal(n)
        s = As[-1] @ x0
        ls.append(s - rng.random(m))
        us.append(s + rng.random(m))
        qs.append(rng.standard_normal(n))
    sol = batch_qp.solve_qp_batch(np.array(Ps), np.array(qs), np.array(As),
                                  np.array(ls), np.array(us),
                                  np.ones((B, m), dtype=bool))
    st = np.asarray(sol.status)
    assert np.all((st == 1) | (st == 2))
    assert float(np.asarray(sol.prim_res).max()) < 1e-6
    # KKT check: P x + q + A' y = 0
    for b in range(B):
        kkt = Ps[b] @ np.asarray(sol.x[b]) + qs[b] \
            + np.array(As[b]).T @ np.asarray(sol.y[b])
        assert np.abs(kkt).max() < 1e-5


# ------------------------------ AVI kernel --------------------------------

def test_avi_simple_lcp():
    # z >= 0 ⟂ z + q: q=(-1, 2) -> z=(1, 0)
    avi = AVI(M=np.eye(2), N=np.zeros((2, 0)), o=np.array([-1.0, 2.0]),
              l=np.zeros(2), u=np.full(2, np.inf))
    z, status = solve_avi(avi, np.zeros(2), np.zeros(0))
    assert status == Status.SUCCESS
    assert np.allclose(z, [1.0, 0.0], atol=1e-8)


def test_avi_constructed_batch(rng):
    """Random monotone box-LCPs with constructed solutions."""
    B, n = 48, 10
    Ms, qs, ls, us, zs = [], [], [], [], []
    for _ in range(B):
        G = rng.standard_normal((n, n))
        M = G @ G.T + 0.1 * np.eye(n) + 0.2 * rng.standard_normal((n, n))
        l = np.where(rng.random(n) < 0.3, -np.inf, -rng.random(n))
        u = np.where(rng.random(n) < 0.3, np.inf, rng.random(n) + 0.5)
        z = np.clip(rng.standard_normal(n),
                    np.where(np.isinf(l), -1, l), np.where(np.isinf(u), 1, u))
        F = np.zeros(n)
        for i in range(n):
            c = rng.random()
            if c < 0.35 and np.isfinite(l[i]):
                z[i] = l[i]
                F[i] = rng.random()
            elif c < 0.55 and np.isfinite(u[i]):
                z[i] = u[i]
                F[i] = -rng.random()
        qs.append(F - M @ z)
        Ms.append(M)
        ls.append(l)
        us.append(u)
        zs.append(z)
    res = solve_avi_batch(np.array(Ms), np.array(qs), np.array(ls),
                          np.array(us), np.zeros((B, n)),
                          np.ones((B, n), dtype=bool))
    conv = np.asarray(res.converged)
    assert conv.mean() >= 0.95


def test_lp_kkt_avi():
    """Skew-symmetric LP-KKT AVI — the class plain Newton stalls on; the
    hybrid Newton/extragradient solver must crack it."""
    rng = np.random.default_rng(5)
    m, n = 8, 3
    A = rng.standard_normal((m, n)) * np.array([1.0, 3.0, 9.0])
    x0 = rng.standard_normal(n)
    b = A @ x0
    c = np.array([0.0, 0.0, 1.0])
    # KKT: [0 -A'; A 0] [x; lam] + [c; 0] with lam ⟂ b-1 <= Ax <= b+1
    g = GAVI(M=np.hstack([np.zeros((n, n)), -A.T]), N=np.zeros((n, 0)), o=c,
             l1=np.full(n, -np.inf), u1=np.full(n, np.inf),
             A=np.hstack([A, np.zeros((m, m))]), B=np.zeros((m, 0)),
             l2=b - 1.0, u2=b + 1.0)
    z, status = solve_gavi(g, np.zeros(n + m), np.zeros(0))
    assert status == Status.SUCCESS
    sol = batch_qp.solve_qp_np(np.zeros((n, n)), c, A, b - 1.0, b + 1.0)
    assert np.isclose(c @ z[:n], float(sol.obj), atol=1e-6)


def test_gavi_qp_kkt_equivalence():
    P = np.array([[2.0, 0.3], [0.3, 1.0]])
    qv = np.array([-1.0, -2.0])
    A = np.array([[1.0, 0], [0, 1.0], [1.0, 1.0]])
    lo = np.array([0.0, 0.0, -np.inf])
    hi = np.array([np.inf, np.inf, 1.5])
    g = GAVI(M=np.hstack([P, -A.T]), N=np.zeros((2, 0)), o=qv,
             l1=np.full(2, -np.inf), u1=np.full(2, np.inf),
             A=np.hstack([A, np.zeros((3, 3))]), B=np.zeros((3, 0)),
             l2=lo, u2=hi)
    z, status = solve_gavi(g, np.zeros(5), np.zeros(0))
    assert status == Status.SUCCESS
    sol = batch_qp.solve_qp_np(P, qv, A, lo, hi)
    assert np.allclose(z[:2], np.asarray(sol.x), atol=1e-6)


def test_check_avi_solution():
    avi = AVI(M=np.eye(2), N=np.zeros((2, 0)), o=np.array([-1.0, 2.0]),
              l=np.zeros(2), u=np.full(2, np.inf))
    ok, deg, _ = check_avi_solution(avi, np.array([1.0, 0.0]), np.zeros(0))
    assert ok
    bad, deg, _ = check_avi_solution(avi, np.array([5.0, 1.0]), np.zeros(0))
    assert not bad


def test_relax_gavi_shapes():
    g = GAVI(M=np.zeros((2, 3)), N=np.zeros((2, 4)), o=np.zeros(2),
             l1=np.zeros(2), u1=np.ones(2),
             A=np.zeros((1, 3)), B=np.zeros((1, 4)),
             l2=np.zeros(1), u2=np.ones(1))
    rg = relax_gavi(g, [1, 3])
    assert rg.M.shape == (4, 5)
    assert rg.N.shape == (4, 2)
    assert rg.A.shape == (1, 5)


def test_convert_gavi_roundtrip():
    """A GAVI solution embeds as a solution of the converted box AVI."""
    g = GAVI(M=np.array([[2.0, -1.0]]), N=np.zeros((1, 0)),
             o=np.array([-1.0]),
             l1=np.array([-np.inf]), u1=np.array([np.inf]),
             A=np.array([[1.0, 0.0]]), B=np.zeros((1, 0)),
             l2=np.array([0.0]), u2=np.array([2.0]))
    z, status = solve_gavi(g, np.zeros(2), np.zeros(0))
    assert status == Status.SUCCESS
    avi = convert_gavi(g)
    s = g.A @ z
    ok, _, _ = check_avi_solution(avi, np.concatenate([z, s]), np.zeros(0))
    assert ok


def test_natural_residual_np():
    from qpn_tpu.ops.avi import natural_residual_np
    M = np.eye(2)[None]
    q = np.array([[-1.0, 2.0]])
    l = np.zeros((1, 2))
    u = np.full((1, 2), np.inf)
    r_sol = natural_residual_np(M, q, l, u, np.array([[1.0, 0.0]]))
    r_bad = natural_residual_np(M, q, l, u, np.array([[0.0, 0.0]]))
    assert r_sol[0] < 1e-12
    assert r_bad[0] > 0.5


def test_structured_kkt_route(rng):
    """solve_kkt_avi_batch must agree with the generic solver on structured
    ensembles (AVI-residual-audited)."""
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.ops.avi import solve_kkt_avi_batch, natural_residual_np
    b = scenario_batch_gavis(num_scenarios=8, T=1, num_obj=1,
                             num_poly_faces=3, seed=0)
    assert "structure" in b
    res = solve_kkt_avi_batch(b["M"], b["q"], b["l"], b["u"], b["mask"],
                              b["structure"], tol=1e-8)
    assert res.converged.all()
    r = natural_residual_np(b["M"], b["q"], b["l"], b["u"], res.z, b["mask"])
    assert r.max() <= 1e-8
