"""Shared-matrix scenario-ensemble solver (ops/shared_kkt.py).

The robust_avoid scenario ensembles share one KKT matrix across lanes
(models/robust_avoid.py scenario_batch_gavis); at trajectory scale the
structured solve routes through GEMM extragradient + f32-LU/f64-refinement
instead of per-lane Lemke tableaus.  These tests pin (a) exact agreement
with the Lemke route at small n, (b) the escalation ladder on degenerate
lanes, (c) the production routing gate, (d) the FLOP ledger contract.
"""

import numpy as np
import pytest

from qpn_tpu.models.robust_avoid import scenario_batch_gavis
from qpn_tpu.ops.shared_kkt import solve_kkt_avi_shared


@pytest.fixture(scope="module")
def small_batch():
    return scenario_batch_gavis(num_scenarios=24, T=2, num_obj=1,
                                num_poly_faces=4, seed=0)


class TestSharedRoute:
    def test_matches_lemke_route(self, small_batch):
        b = small_batch
        from qpn_tpu.ops.avi import solve_kkt_avi_batch
        stats = {}
        res = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                   tol=1e-8, stats=stats)
        assert bool(np.asarray(res.converged).all())
        ref = solve_kkt_avi_batch(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                  {k: v for k, v in b["structure"].items()
                                   if k != "shared_M"}, tol=1e-8)
        assert bool(np.asarray(ref.converged).all())
        # both engines land the SAME complementary solution to ~f64 level
        np.testing.assert_allclose(np.asarray(res.z), np.asarray(ref.z),
                                   atol=1e-8)

    def test_accepts_2d_and_3d_matrix(self, small_batch):
        b = small_batch
        r3 = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                  tol=1e-8)
        r2 = solve_kkt_avi_shared(b["M"][0], b["q"], b["l"], b["u"],
                                  b["mask"], tol=1e-8)
        np.testing.assert_array_equal(np.asarray(r3.z), np.asarray(r2.z))

    def test_rejects_padded_masks(self, small_batch):
        b = small_batch
        mask = np.asarray(b["mask"]).copy()
        mask[0, -1] = False
        with pytest.raises(ValueError, match="unpadded"):
            solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], mask)

    def test_stats_ledger(self, small_batch):
        b = small_batch
        stats = {}
        solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                             tol=1e-8, stats=stats)
        for key in ("eg_iters", "lu_factored", "refine_gemms",
                    "host_solves", "device_flops", "device_bytes"):
            assert key in stats
        assert stats["device_flops"] > 0
        # the fused round 0 always LU-factorizes every lane on device
        # (the ≤24-lane host tail applies to rounds ≥ 1 only)
        assert stats["lu_factored"] >= 24

    def test_degenerate_lanes_escalate_to_conv(self):
        """T=8/num_obj=4 ensembles contain lanes whose EG classification is
        singular (measured); the ladder (wider band -> host f64 lstsq ->
        generic) must still certify every lane at 1e-8."""
        b = scenario_batch_gavis(num_scenarios=16, T=8, num_obj=4,
                                 num_poly_faces=4, seed=0)
        res = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                   tol=1e-8, eg_budget=30000)
        assert bool(np.asarray(res.converged).all())
        assert float(np.asarray(res.resid).max()) <= 1e-8


class TestProductionRouting:
    def test_structured_solve_routes_shared_at_scale(self):
        """solve_kkt_avi_batch dispatches shared_M ensembles above
        config.shared_kkt_min_n to the shared route (metrics counter), and
        keeps small ensembles on the Lemke tableau route."""
        from qpn_tpu.config import CONFIG
        from qpn_tpu.ops.avi import solve_kkt_avi_batch
        from qpn_tpu.utils.metrics import METRICS

        small = scenario_batch_gavis(num_scenarios=8, T=2, num_obj=1,
                                     num_poly_faces=4, seed=0)
        n_small = small["M"].shape[1]
        assert n_small < CONFIG.shared_kkt_min_n   # zoo configs stay Lemke
        c0 = METRICS.counters.get("kkt_shared_route", 0)
        res = solve_kkt_avi_batch(small["M"], small["q"], small["l"],
                                  small["u"], small["mask"],
                                  small["structure"], tol=1e-8)
        assert METRICS.counters.get("kkt_shared_route", 0) == c0
        assert bool(np.asarray(res.converged).all())

        big = scenario_batch_gavis(num_scenarios=6, T=8, num_obj=4,
                                   num_poly_faces=4, seed=1)
        assert big["M"].shape[1] >= CONFIG.shared_kkt_min_n
        assert big["structure"]["shared_M"]
        res = solve_kkt_avi_batch(big["M"], big["q"], big["l"], big["u"],
                                  big["mask"], big["structure"], tol=1e-8)
        assert METRICS.counters.get("kkt_shared_route", 0) == c0 + 6
        assert bool(np.asarray(res.converged).all())


class TestDeterminism:
    def test_straggler_population_identical_across_repeats(self):
        """Variance CI gate: at a fixed seed the
        route's escalation-lane population, per-lane iteration counts, and
        solutions must be IDENTICAL across repeated solves — the r4 record
        showed host_solves 0 vs 105 between two runs of the same HEAD, and
        PATH's boring determinism (avi.jl:63-77) is the reference bar."""
        from qpn_tpu.utils.metrics import METRICS
        b = scenario_batch_gavis(num_scenarios=24, T=8, num_obj=4,
                                 num_poly_faces=4, seed=2)
        runs = []
        for _ in range(3):
            c0 = {k: METRICS.counters.get(k, 0)
                  for k in ("shared_kkt_chip_admm_rung",
                            "shared_kkt_admm_escalation",
                            "shared_kkt_generic_escalation")}
            stats = {}
            res = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"],
                                       b["mask"], tol=1e-8, stats=stats,
                                       structure=b["structure"])
            deltas = {k: METRICS.counters.get(k, 0) - v
                      for k, v in c0.items()}
            runs.append((np.asarray(res.z).copy(),
                         np.asarray(res.iters).copy(),
                         stats["host_solves"], deltas))
            assert bool(np.asarray(res.converged).all())
        z0, it0, hs0, d0 = runs[0]
        for z, it, hs, d in runs[1:]:
            assert (it == it0).all()          # same per-lane work
            assert hs == hs0                  # same host-solve population
            assert d == d0                    # same rung populations
            assert (z == z0).all()            # bit-identical solutions


class TestDesignScale:
    """Coverage at the scale the route exists for: the production
    configuration is T=8 / n=608 / S=1024, while the other tests top out at
    T=2 / n=38."""

    def test_trajectory_scale_regression_T8_n608(self):
        """CPU regression at the full trajectory dimension (small S):
        every lane certifies at 1e-8 and the ladder stays in its cheap
        rungs — no generic escalation (counter pinned), bounded basis
        rounds."""
        from qpn_tpu.utils.metrics import METRICS
        b = scenario_batch_gavis(num_scenarios=8, T=8, num_obj=4,
                                 num_poly_faces=4, seed=3)
        n = b["M"].shape[1]
        assert n >= 600   # the crash-config dimension class
        c0 = METRICS.counters.get("shared_kkt_generic_escalation", 0)
        stats = {}
        res = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                   tol=1e-8, eg_budget=30000, stats=stats,
                                   structure=b["structure"])
        assert bool(np.asarray(res.converged).all())
        assert float(np.asarray(res.resid).max()) <= 1e-8
        # degenerate stragglers may use the structured ADMM rung, but the
        # generic hybrid must stay cold
        assert METRICS.counters.get("shared_kkt_generic_escalation", 0) == c0
        # per-lane iters are real accounting now (eg iters + basis rounds),
        # not a faked broadcast of eg_iters (round-3 shared_kkt.py:331)
        it = np.asarray(res.iters)
        assert (it >= stats["eg_iters"]).all()
        assert (it > stats["eg_iters"]).any()   # basis rounds counted

    def test_trajectory_scale_T16_n1216(self):
        """Double-horizon regression (T=16, n≈1216 — the module docstring's
        upper trajectory class): the fused round-0 + ladder certify every
        lane at 1e-8 with no generic escalation."""
        from qpn_tpu.utils.metrics import METRICS
        b = scenario_batch_gavis(num_scenarios=8, T=16, num_obj=4,
                                 num_poly_faces=4, seed=7)
        assert b["M"].shape[1] >= 1200
        c0 = METRICS.counters.get("shared_kkt_generic_escalation", 0)
        res = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                   tol=1e-8, structure=b["structure"])
        assert bool(np.asarray(res.converged).all())
        assert float(np.asarray(res.resid).max()) <= 1e-8
        assert METRICS.counters.get("shared_kkt_generic_escalation", 0) == c0

    def test_hard_seed_degenerate_class_via_admm_rung(self):
        """Seed-2 ensembles are degenerate-heavy (the δ-ladder certifies
        ~0 of their stuck lanes); the structured-QP rung must absorb them —
        every lane certifies through the CHIP-bulk rung (f32 device ADMM +
        active-set host polish), and both the host-pinned f64 ADMM fallback
        and the generic rung stay cold."""
        from qpn_tpu.utils.metrics import METRICS
        b = scenario_batch_gavis(num_scenarios=32, T=8, num_obj=4,
                                 num_poly_faces=4, seed=2)
        c0 = METRICS.counters.get("shared_kkt_chip_admm_rung", 0)
        a0 = METRICS.counters.get("shared_kkt_admm_escalation", 0)
        g0 = METRICS.counters.get("shared_kkt_generic_escalation", 0)
        res = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                   tol=1e-8, structure=b["structure"])
        assert bool(np.asarray(res.converged).all())
        assert float(np.asarray(res.resid).max()) <= 1e-8
        assert METRICS.counters.get("shared_kkt_chip_admm_rung", 0) > c0
        assert METRICS.counters.get("shared_kkt_admm_escalation", 0) == a0
        assert METRICS.counters.get("shared_kkt_generic_escalation", 0) == g0

    def test_escalation_rung_runs_and_certifies(self, monkeypatch):
        """The generic-escalation rung solves lanes the cheap rungs were
        denied: disable the
        Newton/host rungs and check escalation alone certifies the batch,
        bumping the metrics counter."""
        import qpn_tpu.ops.shared_kkt as sk
        from qpn_tpu.utils.metrics import METRICS
        b = scenario_batch_gavis(num_scenarios=6, T=2, num_obj=1,
                                 num_poly_faces=4, seed=5)

        def _poisoned(Zc, Fc, l, u, band):   # every classification garbage
            at_l = np.zeros_like(Zc, dtype=bool)
            return at_l, at_l
        monkeypatch.setattr(sk, "_classify", _poisoned)
        c0 = METRICS.counters.get("shared_kkt_generic_escalation", 0)
        res = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                   tol=1e-8, eg_budget=2000, newton_rounds=1)
        assert METRICS.counters.get("shared_kkt_generic_escalation", 0) > c0
        assert bool(np.asarray(res.converged).all())

    def test_escalation_pinned_off_accelerator(self, monkeypatch):
        """When the default backend is an accelerator, the escalation rung
        selects a LOCAL CPU device (placement policy, ROADMAP C4)."""
        import qpn_tpu.ops.shared_kkt as sk
        monkeypatch.setattr(sk.jax, "default_backend", lambda: "gpu")
        dev = sk._escalation_device()
        assert dev is not None and dev.platform == "cpu"
        # and on a CPU-default process it is a no-op (no double indirection)
        monkeypatch.setattr(sk.jax, "default_backend", lambda: "cpu")
        assert sk._escalation_device() is None

    def test_property_n128_matches_generic(self, rng):
        """Random monotone shared ensembles at n=128 (mid design scale):
        shared route certifies and agrees with the generic solver."""
        from qpn_tpu.ops.avi import solve_avi_batch_adaptive
        n, S = 128, 12
        A = rng.standard_normal((n, n))
        K = rng.standard_normal((n, n))
        M0 = A @ A.T / n + (K - K.T) / np.sqrt(n) + 0.05 * np.eye(n)
        q = rng.standard_normal((S, n))
        l = np.where(rng.random((S, n)) < 0.25, -np.inf,
                     -1.0 - rng.random((S, n)))
        u = np.where(rng.random((S, n)) < 0.25, np.inf,
                     1.0 + rng.random((S, n)))
        res = solve_kkt_avi_shared(M0, q, l, u, None, tol=1e-8)
        assert bool(np.asarray(res.converged).all())
        ref = solve_avi_batch_adaptive(
            np.repeat(M0[None], S, axis=0), q, l, u, np.zeros((S, n)),
            np.ones((S, n), bool), tol=1e-8)
        assert np.asarray(ref.converged).all()
        np.testing.assert_allclose(np.asarray(res.z), np.asarray(ref.z),
                                   atol=1e-6)


class TestProxEGRung:
    def test_kernel_certifies_strongly_monotone_ensemble(self, rng):
        """The opt-in proximal-point EG rung (one device dispatch, f64
        outer refinement over f32 inner GEMMs) certifies a
        strongly-monotone shared ensemble at 1e-8 from a cold start."""
        import jax.numpy as jnp
        import qpn_tpu.ops.shared_kkt as sk
        n, S = 32, 16
        A = rng.standard_normal((n, n))
        K = rng.standard_normal((n, n))
        M0 = A @ A.T / n + (K - K.T) / np.sqrt(n) + 0.3 * np.eye(n)
        q = rng.standard_normal((S, n))
        l = -np.ones((S, n))
        u = np.ones((S, n))
        v = np.ones(n) / np.sqrt(n)
        for _ in range(30):
            w = M0.T @ (M0 @ v)
            v = w / np.linalg.norm(w)
        Lip = float(np.sqrt(np.linalg.norm(M0.T @ (M0 @ v))))
        delta = 0.05 * Lip
        z, rn, k = sk._prox_eg_rung(
            jnp.asarray(M0, jnp.float32), jnp.asarray(M0),
            jnp.asarray(q), jnp.asarray(l), jnp.asarray(u),
            jnp.asarray(np.zeros_like(q)), np.float32(delta),
            np.float32(0.9 / (Lip + delta)), 1e-8, 1000, 40)
        assert float(np.asarray(rn).max()) <= 1e-8
        # audit against the plain host natural residual too
        rh, _ = sk._nat_resid_shared(M0, q, l, u, np.asarray(z))
        assert rh.max() <= 1e-8

    def test_flag_plumbing(self, small_batch):
        b = small_batch
        res = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                   tol=1e-8, enable_prox_eg=True)
        assert bool(np.asarray(res.converged).all())

    def test_popov_method_plumbing(self, small_batch):
        """Popov's one-GEMM-per-iteration pre-pass (measured slower on the
        bench ensemble — its τ/2 step degrades label quality — but kept as
        a correct audited option)."""
        b = small_batch
        res = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                   tol=1e-8, eg_method="popov")
        assert bool(np.asarray(res.converged).all())


class TestLabelHashParity:
    def test_device_and_host_fingerprints_agree(self, rng):
        """The cycling detector mixes fingerprints from the device round-0
        hash and the host policy-loop hash — they must be the SAME
        function bit-for-bit, or an exact round-1 repeat of the EG
        classification escapes cycle detection."""
        import qpn_tpu.ops.shared_kkt as sk
        n, C = 131, 24
        at_l = rng.random((C, n)) < 0.3
        at_u = (rng.random((C, n)) < 0.3) & ~at_l
        host = sk._label_hash(at_l, at_u, sk._hash_weights(n))
        dev = np.asarray(sk._label_hash_dev(at_l, at_u))
        np.testing.assert_array_equal(host, dev)


class TestMeshSharded:
    def test_mesh_sharded_matches_single_device(self):
        """S shards over the (scenario, branch) mesh with M replicated and
        no collectives in the compute path — lane results must match the
        unsharded route exactly (same kernels, same per-lane math)."""
        import jax
        from qpn_tpu.parallel.mesh import make_mesh
        if len(jax.devices()) < 2:
            pytest.skip("needs a multi-device (virtual) mesh")
        b = scenario_batch_gavis(num_scenarios=32, T=2, num_obj=1,
                                 num_poly_faces=4, seed=2)
        ref = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                   tol=1e-8)
        mesh = make_mesh()
        res = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                   tol=1e-8, mesh=mesh)
        assert bool(np.asarray(res.converged).all())
        np.testing.assert_allclose(np.asarray(res.z), np.asarray(ref.z),
                                   atol=1e-9)

    def test_mesh_falls_back_on_indivisible_batch(self):
        import jax
        from qpn_tpu.parallel.mesh import make_mesh
        if len(jax.devices()) < 2:
            pytest.skip("needs a multi-device (virtual) mesh")
        b = scenario_batch_gavis(num_scenarios=9, T=2, num_obj=1,
                                 num_poly_faces=4, seed=2)
        res = solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], b["mask"],
                                   tol=1e-8, mesh=make_mesh())
        assert bool(np.asarray(res.converged).all())


class TestPropertyRandomSharedEnsembles:
    def test_random_strongly_monotone_matches_generic(self, rng):
        """Random shared-M ensembles (PSD + skew + δI → unique solution):
        the shared route and the generic adaptive solver must land the same
        point at 1e-8, including lanes with infinite bounds."""
        from qpn_tpu.ops.avi import solve_avi_batch_adaptive
        n, S = 24, 16
        A = rng.standard_normal((n, n))
        K = rng.standard_normal((n, n))
        M0 = A @ A.T / n + (K - K.T) / np.sqrt(n) + 0.1 * np.eye(n)
        q = rng.standard_normal((S, n))
        l = np.where(rng.random((S, n)) < 0.3, -np.inf,
                     -1.0 - rng.random((S, n)))
        u = np.where(rng.random((S, n)) < 0.3, np.inf,
                     1.0 + rng.random((S, n)))
        res = solve_kkt_avi_shared(M0, q, l, u, None, tol=1e-8)
        assert bool(np.asarray(res.converged).all())
        Mrep = np.repeat(M0[None], S, axis=0)
        ref = solve_avi_batch_adaptive(Mrep, q, l, u, np.zeros((S, n)),
                                       np.ones((S, n), bool), tol=1e-8)
        ok = np.asarray(ref.converged)
        assert ok.all()
        np.testing.assert_allclose(np.asarray(res.z), np.asarray(ref.z),
                                   atol=1e-6)
