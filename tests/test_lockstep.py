"""Lockstep scenario-ensemble driver (parallel/lockstep.py).

the WHOLE equilibrium loop must run as a multi-chip
scenario ensemble, not just the leaf AVI batch.  These tests drive full
``solve()`` ensembles through the wave-fusing broker — serial-path
agreement, kernel-wave fusion, and the 8-device virtual mesh sharding.

Note on determinism: per-lane math inside a vmapped kernel is independent of
batchmates (vmapped while_loops freeze finished lanes), but XLA fuses
different *batch shapes* differently, so cross-path agreement is float-ulp
level rather than bitwise; the contract asserted here is ≤1e-9.
"""

import numpy as np
import pytest

import qpn_tpu as qt
from qpn_tpu.parallel.lockstep import LockstepBroker, solve_many_lockstep


def _scenarios():
    ws = [np.array([0.0, 1.0]), np.array([1.0, 1.5]), np.array([-1.0, 0.5])]
    qpns = [qt.setup("simple_bilevel") for _ in ws]
    x0s = [np.concatenate([w, [0.0, 0.0]]) for w in ws]
    return qpns, x0s, ws


class TestLockstep:
    def test_matches_serial_path(self):
        qpns, x0s, ws = _scenarios()
        serial = []
        for w, x0 in zip(ws, x0s):
            ret = qt.solve(qt.setup("simple_bilevel"), x0)
            assert ret.solved
            serial.append(np.asarray(ret.x_opt))
        outs, broker = solve_many_lockstep(qpns, x0s)
        assert broker.waves >= 1          # kernel waves actually fused
        for s, o in zip(serial, outs):
            assert o.solved
            np.testing.assert_allclose(np.asarray(o.x_opt), s, atol=1e-9)

    def test_mesh_sharded_waves(self):
        from qpn_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(8)
        qpns, x0s, ws = _scenarios()
        outs, broker = solve_many_lockstep(qpns, x0s, mesh=mesh)
        assert broker.waves >= 1
        for o, w in zip(outs, ws):
            assert o.solved
            # follower response of simple_bilevel: x = clip(w, -1, 1)-ish
            np.testing.assert_allclose(np.asarray(o.x_opt)[:2], w, atol=1e-6)

    def test_error_isolation(self):
        """One failing scenario must not poison the others."""
        broker = LockstepBroker()

        def good():
            ret = qt.solve(qt.setup("simple_bilevel"),
                           np.array([0.0, 1.0, 0.0, 0.0]))
            return ret

        def bad():
            raise ValueError("scenario exploded")

        with pytest.raises(ValueError, match="scenario exploded"):
            broker.run([good, bad])


class TestBrokerRobustness:
    def test_dispatch_failure_wakes_workers(self, monkeypatch):
        """A failed fused dispatch must propagate to the parked workers
        (raising in submit) instead of stranding them in event.wait."""
        from qpn_tpu.ops import batch_qp

        def boom(*a, **k):
            raise RuntimeError("fused dispatch failure (simulated)")

        monkeypatch.setattr(batch_qp, "solve_qp_batch_padded", boom)
        broker = LockstepBroker()

        def job():
            return broker.submit(
                "qp", np.zeros((1, 2, 2)), np.zeros((1, 2)),
                np.zeros((1, 1, 2)), np.zeros((1, 1)), np.ones((1, 1)),
                np.ones((1, 1), bool))

        with pytest.raises(RuntimeError, match="simulated"):
            broker.run([job])

    def test_lp_and_qp_requests_do_not_fuse(self):
        """A pure-LP request (P == 0) must not share a fused dispatch with
        a QP of identical shapes: the exact-LP route gates on the whole
        concatenated batch being LP."""
        broker = LockstepBroker()
        seen = []
        orig = broker._dispatch_wave

        def spy(requests):
            seen.append([not np.asarray(r.args[0]).any() for r in requests])
            return orig(requests)

        broker._dispatch_wave = spy
        P_qp = np.eye(2)[None]
        P_lp = np.zeros((1, 2, 2))
        q = np.array([[1.0, 1.0]])
        A = np.ones((1, 1, 2))
        l, u = np.array([[0.0]]), np.array([[1.0]])
        rm = np.ones((1, 1), bool)

        def job(P):
            return lambda: broker.submit("qp", P, q, A, l, u, rm)

        out = broker.run([job(P_qp), job(P_lp)])
        assert all(o is not None for o in out)
        # both requests arrived in one wave but must have been split into
        # two dispatch groups by the is_lp key — verify via the group key
        # logic directly (spy sees the wave pre-grouping)
        assert sorted(seen[0]) == [False, True]
        from qpn_tpu.parallel.lockstep import _Request
        reqs = [_Request("qp", (P_qp, q, A, l, u, rm), {}),
                _Request("qp", (P_lp, q, A, l, u, rm), {})]
        keys = set()
        for r in reqs:
            is_lp = not np.asarray(r.args[0]).any()
            keys.add((r.kind, is_lp))
        assert len(keys) == 2


class TestHostLPParking:
    """host-engine geometry LPs must also park at the
    broker (fusing OpenMP batches across scenarios) instead of bypassing
    the waves entirely."""

    def test_host_lp_requests_fuse_and_match_direct(self):
        from qpn_tpu.utils.native import native_available
        if not native_available():
            pytest.skip("native host engine unavailable")
        from qpn_tpu.ops.lemke import solve_lp_host_batch
        from qpn_tpu.utils.metrics import METRICS

        rng = np.random.default_rng(3)
        jobs_args = []
        for _ in range(3):
            c = rng.standard_normal((2, 3))
            A = rng.standard_normal((2, 4, 3))
            l = -np.ones((2, 4)) - rng.random((2, 4))
            u = np.ones((2, 4)) + rng.random((2, 4))
            rm = np.ones((2, 4), bool)
            jobs_args.append((c, A, l, u, rm))
        direct = [solve_lp_host_batch(*a, _no_broker=True)
                  for a in jobs_args]
        assert all(d is not None for d in direct)

        waves0 = METRICS.counters.get("broker_lp_host_waves", 0)
        broker = LockstepBroker()
        outs = broker.run([
            (lambda a=a: solve_lp_host_batch(*a)) for a in jobs_args])
        assert METRICS.counters.get("broker_lp_host_waves", 0) > waves0
        for o, d in zip(outs, direct):
            np.testing.assert_allclose(np.asarray(o.x), np.asarray(d.x),
                                       atol=1e-9)
            np.testing.assert_allclose(np.asarray(o.obj), np.asarray(d.obj),
                                       atol=1e-9)

    def test_remove_subsets_parks_host_lps(self):
        """remove_subsets — the production dedup entry inside solve() — runs
        its support/containment LPs through the host engine; under a broker
        those LPs must park and fuse across scenario workers."""
        from qpn_tpu.utils.native import native_available
        from qpn_tpu.config import CONFIG
        if not native_available() or CONFIG.support_engine != "host":
            pytest.skip("host support engine not in play")
        from qpn_tpu.geometry.poly import PolyUnion, random_polys_of_dim
        from qpn_tpu.geometry.setops import remove_subsets
        from qpn_tpu.geometry.query_cache import CACHE
        from qpn_tpu.utils.metrics import METRICS

        def union(seed):
            rng = np.random.default_rng(seed)
            return PolyUnion(random_polys_of_dim(rng, 6, 3))

        CACHE.clear()
        direct = [[p.m for p in remove_subsets(union(s)).polys]
                  for s in (7, 8)]
        CACHE.clear()
        waves0 = METRICS.counters.get("broker_lp_host_waves", 0)
        broker = LockstepBroker()
        outs = broker.run([
            (lambda s=s: remove_subsets(union(s))) for s in (7, 8)])
        assert METRICS.counters.get("broker_lp_host_waves", 0) > waves0
        # decision parity with the direct path
        for o, d in zip(outs, direct):
            assert [p.m for p in o.polys] == d
