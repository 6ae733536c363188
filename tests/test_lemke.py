"""Tests for the batched Lemke complementary-pivot engine (ops/lemke.py).

The engine is the batched counterpart of PATH's pivoting core
(reference: avi.jl:63-77; prior art deprecated/avi_scratch.jl:17-134).
Covers: random box-LCP classes (PD, nonsymmetric, monotone-degenerate),
free/pinned/one-sided bounds, batch padding, the host/JAX agreement, and
the proximal escalation on saddle (LP-KKT) systems where the start basis
is structurally singular.
"""

import numpy as np
import pytest

from qpn_tpu.ops.lemke import (LEMKE_SUCCESS, lemke_escalate, solve_lemke_batch,
                               solve_lemke_batch_padded, solve_lemke_np)


def nat_res(M, q, l, u, z):
    F = M @ z + q
    with np.errstate(invalid="ignore"):
        proj = np.clip(z - F, l, u)
    return np.abs(z - proj).max()


def random_box_avi(rng, n, kind):
    R = rng.standard_normal((n, n))
    if kind == 0:        # strongly monotone PD symmetric
        M = R @ R.T + np.eye(n) * 0.5
    elif kind == 1:      # PD nonsymmetric
        S = rng.standard_normal((n, n))
        S = S - S.T
        M = R @ R.T + 0.1 * np.eye(n) + S
    elif kind == 2:      # monotone, nearly degenerate (PSD + skew + tiny reg)
        W = rng.standard_normal((n, max(1, n // 2)))
        S = rng.standard_normal((n, n))
        S = S - S.T
        M = W @ W.T + S + 1e-6 * np.eye(n)
    else:                # diagonally dominant P-matrix
        M = R * 0.1
        M[range(n), range(n)] = np.abs(R).sum(1) + 0.5
    q = rng.standard_normal(n) * 2
    l = np.full(n, -np.inf)
    u = np.full(n, np.inf)
    for i in range(n):
        c = rng.integers(0, 5)
        if c == 0:
            l[i] = rng.standard_normal()
        elif c == 1:
            u[i] = rng.standard_normal()
        elif c == 2:
            l[i] = rng.standard_normal()
            u[i] = l[i] + abs(rng.standard_normal())
        elif c == 3:
            l[i] = u[i] = rng.standard_normal()   # pinned (equality)
        # c == 4: free row (equation)
    return M, q, l, u


class TestHostLemke:
    def test_random_classes(self):
        rng = np.random.default_rng(0)
        for trial in range(80):
            n = int(rng.integers(2, 25))
            M, q, l, u = random_box_avi(rng, n, trial % 4)
            z, status, piv = solve_lemke_np(M, q, l, u, tol=1e-9)
            assert status == LEMKE_SUCCESS, f"trial {trial}: status {status}"
            assert nat_res(M, q, l, u, z) < 1e-7, f"trial {trial}"

    def test_warm_start_vertex_zero_pivots(self):
        """A start at a vertex solution terminates without pivoting."""
        n = 6
        M = np.eye(n)
        q = np.full(n, -2.0)
        l = np.zeros(n)
        u = np.ones(n)                      # solution: z = u (w = -1 ≤ 0)
        z, status, piv = solve_lemke_np(M, q, l, u, z0=np.ones(n))
        assert status == LEMKE_SUCCESS and piv == 0
        np.testing.assert_allclose(z, 1.0)

    def test_warm_start_still_solves(self):
        rng = np.random.default_rng(3)
        M, q, l, u = random_box_avi(rng, 12, 0)
        z, status, piv = solve_lemke_np(M, q, l, u)
        z2, status2, piv2 = solve_lemke_np(M, q, l, u, z0=z)
        assert status2 == LEMKE_SUCCESS
        assert nat_res(M, q, l, u, z2) < 1e-7

    def test_all_equations_linear_system(self):
        """Free-everywhere AVI is just the linear system M z = -q."""
        rng = np.random.default_rng(4)
        n = 8
        M = rng.standard_normal((n, n)) + 3 * np.eye(n)
        q = rng.standard_normal(n)
        l = np.full(n, -np.inf)
        u = np.full(n, np.inf)
        z, status, piv = solve_lemke_np(M, q, l, u)
        assert status == LEMKE_SUCCESS
        np.testing.assert_allclose(M @ z + q, 0.0, atol=1e-8)

    def test_unsolvable_avi_detected_by_audit(self):
        """M=−I, q=0, l=1, u=∞ has NO solution (needs z at a +∞ bound).

        With synthetic big-M boxes the pivot path terminates at a spurious
        boundary solution instead of a ray; the contract is that the
        *true-bounds* natural-residual audit rejects it — exactly how
        lemke_escalate decides acceptance."""
        n = 3
        M = -np.eye(n)
        q = np.zeros(n)
        l = np.ones(n)
        u = np.full(n, np.inf)
        z, status, piv = solve_lemke_np(M, q, l, u)
        assert nat_res(M, q, l, u, z) > 1e-3   # audit must reject


class TestBatchedLemke:
    def test_matches_host_oracle(self):
        rng = np.random.default_rng(1)
        n, B = 14, 32
        data = [random_box_avi(rng, n, b % 4) for b in range(B)]
        M = np.stack([d[0] for d in data])
        q = np.stack([d[1] for d in data])
        l = np.stack([d[2] for d in data])
        u = np.stack([d[3] for d in data])
        z0 = np.zeros((B, n))
        mask = np.ones((B, n), dtype=bool)
        mask[0, 10:] = False       # exercise padding lanes
        mask[1, 8:] = False
        z, status, piv = map(np.asarray,
                             solve_lemke_batch(M, q, l, u, z0, mask))
        for b in range(B):
            Mb = np.where(np.outer(mask[b], mask[b]), M[b], np.eye(n))
            qb = np.where(mask[b], q[b], 0.0)
            lb = np.where(mask[b], l[b], 0.0)
            ub = np.where(mask[b], u[b], 0.0)
            assert status[b] == LEMKE_SUCCESS, f"lane {b}: {status[b]}"
            assert nat_res(Mb, qb, lb, ub, z[b]) < 1e-7, f"lane {b}"
            assert np.all(z[b][~mask[b]] == 0.0)

    def test_padded_wrapper(self):
        rng = np.random.default_rng(2)
        n, B = 11, 5           # awkward shapes force bucket padding
        data = [random_box_avi(rng, n, k) for k in range(B)]
        M = np.stack([d[0] for d in data])
        q = np.stack([d[1] for d in data])
        l = np.stack([d[2] for d in data])
        u = np.stack([d[3] for d in data])
        z, status, piv = solve_lemke_batch_padded(
            M, q, l, u, np.zeros((B, n)), np.ones((B, n), dtype=bool))
        assert z.shape == (B, n)
        for b in range(B):
            assert status[b] == LEMKE_SUCCESS
            assert nat_res(M[b], q[b], l[b], u[b], z[b]) < 1e-7


class TestProximalEscalation:
    def test_saddle_kkt_system(self):
        """LP-KKT saddle AVI: zero free/free block → singular start basis;
        the δ-proximal tier must still crack it to 1e-10."""
        rng = np.random.default_rng(5)
        for trial in range(10):
            nx, m = 6, 4
            A = rng.standard_normal((m, nx))
            c = rng.standard_normal(nx)
            b_lo = -np.abs(rng.standard_normal(m)) - 1.0
            b_hi = np.abs(rng.standard_normal(m)) + 1.0
            # KKT of  min c'x  s.t. b_lo <= A x <= b_hi,  x in [-5, 5]:
            #   rows x:  c - A'λ ⟂ -5 ≤ x ≤ 5
            #   rows λ:  A x     ⟂ b_lo ≤ Ax ≤ b_hi  → slack form
            n = nx + 2 * m
            M = np.zeros((n, n))
            M[:nx, nx:nx + m] = -A.T
            M[nx:nx + m, :nx] = A
            M[nx:nx + m, nx + m:] = -np.eye(m)
            M[nx + m:, nx:nx + m] = np.eye(m)
            q = np.concatenate([c, np.zeros(2 * m)])
            l = np.concatenate([np.full(nx, -5.0), np.full(m, -np.inf), b_lo])
            u = np.concatenate([np.full(nx, 5.0), np.full(m, np.inf), b_hi])
            z0 = np.zeros(n)
            z, r = lemke_escalate(M[None], q[None], l[None], u[None],
                                  z0[None], np.ones((1, n), dtype=bool),
                                  tol=1e-10)
            assert r[0] <= 1e-9, f"trial {trial}: resid {r[0]:.2e}"

    def test_escalate_leaves_converged_lanes_alone(self):
        rng = np.random.default_rng(6)
        M, q, l, u = random_box_avi(rng, 10, 0)
        z, status, _ = solve_lemke_np(M, q, l, u)
        zs = np.stack([z, np.zeros(10)])
        Ms = np.stack([M, M])
        qs = np.stack([q, q])
        ls = np.stack([l, l])
        us = np.stack([u, u])
        zo, ro = lemke_escalate(Ms, qs, ls, us, zs,
                                np.ones((2, 10), dtype=bool), tol=1e-9)
        np.testing.assert_allclose(zo[0], z)     # untouched
        assert ro[1] <= 1e-9                     # solved


class TestLemkeLPEngine:
    def test_matches_admm_on_random_lps(self):
        from qpn_tpu.ops import batch_qp
        from qpn_tpu.ops.lemke import solve_lp_lemke_batch
        rng = np.random.default_rng(7)
        B, m, n = 24, 10, 6
        A = rng.standard_normal((B, m, n))
        c = rng.standard_normal((B, n))
        x0 = rng.standard_normal((B, n))
        Ax0 = np.einsum("bmn,bn->bm", A, x0)
        l = Ax0 - np.abs(rng.standard_normal((B, m))) - 0.1
        u = Ax0 + np.abs(rng.standard_normal((B, m))) + 0.1
        # make bounded: add box rows |x_i| <= 5 via extra constraints
        eye = np.tile(np.eye(n)[None], (B, 1, 1))
        A2 = np.concatenate([A, eye], axis=1)
        l2 = np.concatenate([l, np.full((B, n), -5.0)], axis=1)
        u2 = np.concatenate([u, np.full((B, n), 5.0)], axis=1)
        mask = np.ones((B, m + n), dtype=bool)
        sol = solve_lp_lemke_batch(c, A2, l2, u2, mask)
        ref = batch_qp.solve_qp_batch_padded(
            np.zeros((B, n, n)), c, A2, l2, u2, mask, _no_lemke=True)
        for b in range(B):
            assert sol.status[b] == batch_qp.SOLVED
            assert np.asarray(ref.status)[b] in (batch_qp.SOLVED,
                                                 batch_qp.SOLVED_INACCURATE)
            np.testing.assert_allclose(sol.obj[b], np.asarray(ref.obj)[b],
                                       atol=1e-5)
            # stationarity with the returned duals: c + A'y = 0
            g = c[b] + A2[b].T @ np.asarray(sol.y[b])
            np.testing.assert_allclose(g, 0.0, atol=1e-7)

    def test_detects_unbounded_and_infeasible(self):
        from qpn_tpu.ops import batch_qp
        from qpn_tpu.ops.lemke import solve_lp_lemke_batch
        n = 3
        # lane 0: unbounded (min x_0, only lower bounds on rows)
        # lane 1: infeasible (x_0 >= 1 and x_0 <= -1)
        A = np.zeros((2, 2, n))
        A[0, 0, 0] = 1.0
        A[0, 1, 1] = 1.0
        A[1, 0, 0] = 1.0
        A[1, 1, 0] = 1.0
        c = np.zeros((2, n))
        c[0, 0] = 1.0
        l = np.array([[-np.inf, -1.0], [1.0, -np.inf]])
        u = np.array([[5.0, 1.0], [np.inf, -1.0]])
        mask = np.ones((2, 2), dtype=bool)
        sol = solve_lp_lemke_batch(c, A, l, u, mask)
        assert sol.status[0] == batch_qp.DUAL_INFEASIBLE
        assert sol.status[1] == batch_qp.PRIMAL_INFEASIBLE


class TestHullDegeneracy:
    def test_collinear_cloud_no_spurious_facets(self):
        from qpn_tpu.geometry.vertices import hull_of_points
        # square + collinear midpoints: degenerate triples must be skipped
        pts = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0],
                        [0.5, 0.0], [0.5, 1.0]])
        h = hull_of_points(pts)
        # hull is the unit square: 4 facets after simplify; every input
        # point inside, and exterior points excluded
        assert h.contains(np.array([0.5, 0.5]), tol=1e-8)
        for p in pts:
            assert h.contains(p, tol=1e-6)
        assert not h.contains(np.array([1.2, 0.5]), tol=1e-6)
        assert not h.contains(np.array([0.5, -0.2]), tol=1e-6)


class TestLemkeLPEngineEndToEnd:
    def test_lp_engine_optin_end_to_end(self):
        """The exact-pivot LP engine solves a full model when opted in."""
        import qpn_tpu as qt
        from qpn_tpu.config import CONFIG
        old = CONFIG.lp_engine
        CONFIG.lp_engine = "lemke"
        try:
            qpn = qt.setup("simple_bilevel", gen_solution_map=True)
            ret = qt.solve(qpn, np.array([0.0, 1.0, 0.0, 0.0]))
            assert ret.solved
            np.testing.assert_allclose(ret.x_opt[2:], [0.5, 0.5], atol=1e-4)
            assert len(list(ret.Sol[2])) >= 1
        finally:
            CONFIG.lp_engine = old


def test_ray_pivot_count_parity_with_oracle():
    """On RAY/SINGULAR termination no pivot is performed: the numpy oracle
    returns before its `pivots += 1`, and the batched XLA engine must agree
    lane-for-lane (it previously over-counted the terminating iteration)."""
    from qpn_tpu.ops.lemke import (solve_lemke_np, solve_lemke_batch,
                                   LEMKE_RAY)
    rng = np.random.default_rng(7)
    n, B = 6, 64
    Ms, qs = [], []
    for b in range(B):
        if b % 2:
            v = rng.standard_normal((n, 1))
            Mb = v @ v.T                      # rank-1
        else:
            G = rng.standard_normal((n, n))
            Mb = -(G @ G.T) / n - 0.1 * np.eye(n)   # negative definite
        Ms.append(Mb)
        qs.append(rng.standard_normal(n))
    M, q = np.stack(Ms), np.stack(qs)
    l = np.full((B, n), -np.inf)
    u = np.full((B, n), np.inf)
    z0 = np.zeros((B, n))
    mask = np.ones((B, n), dtype=bool)
    zB, stB, pvB = map(np.asarray, solve_lemke_batch(M, q, l, u, z0, mask))
    n_ray = 0
    for b in range(B):
        z1, st1, pv1 = solve_lemke_np(M[b], q[b], l[b], u[b], z0[b])
        assert st1 == stB[b], f"lane {b}: status {st1} vs {stB[b]}"
        assert pv1 == pvB[b], f"lane {b}: pivots {pv1} vs {pvB[b]}"
        n_ray += int(st1 == LEMKE_RAY)
    # the sweep must actually exercise the ray path
    assert n_ray >= 1
