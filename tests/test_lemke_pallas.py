"""Correctness of the fused Pallas Lemke pivot kernel and its dispatcher.

The kernel (ops/lemke_pallas.py) runs here in interpret mode; the compiled
GPU kernel is checked by the ``gpu``-marked test below on a card and by
``chip_smoke.py``.  It must follow the same almost-complementary
path discipline as the XLA while_loop engine: same status codes, same
pivot counts, and terminal complementary bases that refactorize to
machine-precision residuals on the ORIGINAL f64 data.  Degenerate lanes
may legitimately settle on a *different* complementary basis than the XLA
engine (f32 tie ordering differs between summation orders); the audit is
therefore solution-level, matching the framework's own acceptance gate
(reference: check_avi_solution, avi.jl:148-156).
"""

import numpy as np
import pytest

from qpn_tpu.ops.avi import natural_residual_np
from qpn_tpu.ops.lemke import (LEMKE_SUCCESS, lemke_engine, refactor_batch_np,
                               solve_lemke_batch_state,
                               solve_lemke_batch_state_auto)
from qpn_tpu.ops.lemke_pallas import (LEMKE_KERNEL_MAX_N, kernel_shape,
                                      solve_lemke_batch_state_pallas)


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _run_both(M, q, l, u, vm, max_pivots=1024):
    B, n = q.shape
    z0 = np.zeros((B, n), dtype=np.float32)
    args = (_f32(M), _f32(q), _f32(l), _f32(u), z0, np.asarray(vm, bool))
    kw = dict(tol=1e-6, piv_tol=1e-5, max_pivots=max_pivots)
    P = tuple(np.asarray(a) for a in
              solve_lemke_batch_state_pallas(*args, interpret=True, **kw))
    X = tuple(np.asarray(a) for a in solve_lemke_batch_state(*args, **kw))
    return P, X


def _refactor_resid(M, q, l, u, vm, basis, val):
    z, ok = refactor_batch_np(np.float64(M), np.float64(q), np.float64(l),
                              np.float64(u), basis, val,
                              np.asarray(vm, bool))
    r = natural_residual_np(M, q, l, u, z, vm)
    return z, ok, r


def test_random_pd_avis_match_xla_engine():
    rng = np.random.default_rng(3)
    B, n = 8, 12
    A = rng.standard_normal((B, n, n))
    M = np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)[None]
    q = rng.standard_normal((B, n))
    l = np.full((B, n), -np.inf)
    u = np.full((B, n), np.inf)
    l[:, :4] = 0.0
    u[:, 4:7] = 0.5          # finite boxes exercise bound flips
    l[:, 7] = u[:, 7] = 0.3  # pinned row
    vm = np.ones((B, n), dtype=bool)
    (zP, stP, pivP, basP, valP), (zX, stX, pivX, basX, valX) = \
        _run_both(M, q, l, u, vm)
    assert (stP == LEMKE_SUCCESS).all()
    np.testing.assert_array_equal(stP, stX)
    np.testing.assert_array_equal(pivP, pivX)
    _, ok, r = _refactor_resid(M, q, l, u, vm, basP, valP)
    assert ok.all()
    assert r.max() < 1e-9


def test_padding_mask_and_solved_at_start():
    rng = np.random.default_rng(7)
    B, n = 4, 10
    nv = 6                                   # last 4 vars are padding
    A = rng.standard_normal((B, nv, nv))
    M = np.zeros((B, n, n))
    M[:, :nv, :nv] = np.einsum("bij,bkj->bik", A, A) + 0.2 * np.eye(nv)
    q = np.zeros((B, n))
    q[:, :nv] = rng.standard_normal((B, nv))
    l = np.zeros((B, n))
    u = np.full((B, n), np.inf)
    # lane 0 solved at start: q >= 0 with l=0 boxes means z=0 is a solution
    q[0, :nv] = np.abs(q[0, :nv]) + 0.1
    vm = np.zeros((B, n), dtype=bool)
    vm[:, :nv] = True
    (zP, stP, pivP, basP, valP), (zX, stX, pivX, basX, valX) = \
        _run_both(M, q, l, u, vm)
    assert (stP == LEMKE_SUCCESS).all()
    assert pivP[0] == 0 and pivX[0] == 0      # solved-at-start short-circuit
    assert np.all(zP[:, nv:] == 0.0)
    _, ok, r = _refactor_resid(M, q, l, u, vm, basP, valP)
    assert ok.all() and r.max() < 1e-9


def test_kkt_scenario_ensemble_end_to_end():
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    batch = scenario_batch_gavis(num_scenarios=16, T=2, num_obj=1,
                                 num_poly_faces=4, seed=0)
    M, q, l, u = batch["M"], batch["q"], batch["l"], batch["u"]
    vm = batch["mask"]
    (zP, stP, pivP, basP, valP), (zX, stX, pivX, basX, valX) = \
        _run_both(M, q, l, u, vm)
    np.testing.assert_array_equal(stP, stX)
    np.testing.assert_array_equal(pivP, pivX)
    assert (stP == LEMKE_SUCCESS).all()
    _, ok, r = _refactor_resid(M, q, l, u, vm, basP, valP)
    assert ok.all() and r.max() < 1e-9


def test_structured_route_with_pallas_engine(monkeypatch):
    """solve_kkt_avi_batch with the kernel engine (interpreted) certifies to
    the same tolerance as the XLA engine on the scenario ensemble."""
    import qpn_tpu.ops.lemke as lemke_mod
    import qpn_tpu.ops.lemke_pallas as lp
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.ops.avi import solve_kkt_avi_batch
    from qpn_tpu.utils.metrics import METRICS
    batch = scenario_batch_gavis(num_scenarios=8, T=2, num_obj=1,
                                 num_poly_faces=4, seed=1)
    M, q, l, u = batch["M"], batch["q"], batch["l"], batch["u"]
    vm, structure = batch["mask"], batch["structure"]
    monkeypatch.setattr(lemke_mod, "lemke_engine", lambda n: "kernel")
    kernel = lp.solve_lemke_batch_state_pallas
    monkeypatch.setattr(lp, "solve_lemke_batch_state_pallas",
                        lambda *a, interpret=False, **k: kernel(
                            *a, interpret=True, **k))
    c0 = METRICS.counters.get("lemke_kernel_lanes", 0)
    res = solve_kkt_avi_batch(M, q, l, u, vm, structure, tol=1e-10)
    assert METRICS.counters.get("lemke_kernel_lanes", 0) == c0 + 8
    assert np.asarray(res.converged).all()
    assert np.asarray(res.resid).max() <= 1e-10


@pytest.mark.parametrize("n", [5, 17, 38, 64])
def test_kernel_matches_xla_and_native(n):
    """Kernel vs the XLA lane (same statuses and pivot counts) and vs the
    host f64 exact engine (same solution after the f64 refactorisation),
    across tableau paddings: n=5 -> (8, 16), 17 -> (32, 64),
    38 -> (64, 128), 64 -> (64, 256)."""
    from qpn_tpu.utils import native
    M, q, l, u, vm = _rand_psd_lcp(3, n, seed=n)
    u[:, : n // 3] = 0.5                     # boxes exercise bound flips
    P, X = _run_both(M, q, l, u, vm)
    np.testing.assert_array_equal(P[1], X[1])
    np.testing.assert_array_equal(P[2], X[2])
    assert (P[1] == LEMKE_SUCCESS).all()
    z, ok, r = _refactor_resid(M, q, l, u, vm, P[3], P[4])
    assert ok.all() and r.max() < 1e-9
    out = native.lemke_batch(M, q, l, u, tol=1e-11)
    if out is not None:                      # no compiler: nothing to check
        zN, stN, _ = out
        assert (stN == LEMKE_SUCCESS).all()
        np.testing.assert_allclose(z, zN, atol=1e-8)


@pytest.mark.parametrize("backend,n,mode,want", [
    ("gpu", 38, "auto", "kernel"),
    ("gpu", LEMKE_KERNEL_MAX_N, "auto", "kernel"),
    ("gpu", LEMKE_KERNEL_MAX_N + 1, "auto", "xla"),   # oversize tableau
    ("cpu", 38, "auto", "xla"),
    ("gpu", 38, "xla", "xla"),                         # forced XLA lane
])
def test_engine_choice(monkeypatch, backend, n, mode, want):
    from qpn_tpu.config import CONFIG
    monkeypatch.setattr(CONFIG, "lemke_kernel", mode)
    assert lemke_engine(n, backend) == want


def test_kernel_size_bound_is_one_sm():
    """The largest kernel tableau (f32) is at most a quarter of one SM's
    256 KB register file; the next n doubles its rows past that."""
    NP, WP = kernel_shape(LEMKE_KERNEL_MAX_N)
    assert NP * WP * 4 <= (256 << 10) // 4
    NP2, WP2 = kernel_shape(LEMKE_KERNEL_MAX_N + 1)
    assert NP2 * WP2 * 4 > (256 << 10) // 4


def test_kernel_failure_raises(monkeypatch):
    """A kernel failure surfaces to the caller: no silent fallback to the
    XLA lane."""
    import qpn_tpu.ops.lemke_pallas as lp

    def boom(*a, **k):
        raise RuntimeError("kernel compile failure (simulated)")
    monkeypatch.setattr(lp, "solve_lemke_batch_state_pallas", boom)
    M, q, l, u, vm = _rand_psd_lcp(4, 6, seed=0)
    with pytest.raises(RuntimeError, match="simulated"):
        solve_lemke_batch_state_auto(
            _f32(M), _f32(q), _f32(l), _f32(u), np.zeros((4, 6), np.float32),
            vm, tol=1e-6, piv_tol=1e-5, max_pivots=256, engine="kernel")


def test_kernel_rejects_what_it_cannot_run():
    M, q, l, u, vm = _rand_psd_lcp(2, LEMKE_KERNEL_MAX_N + 1, seed=1)
    z0 = np.zeros_like(q)
    with pytest.raises(ValueError, match="n <="):
        solve_lemke_batch_state_pallas(_f32(M), _f32(q), _f32(l), _f32(u),
                                       _f32(z0), vm, interpret=True)
    with pytest.raises(TypeError, match="float32"):
        solve_lemke_batch_state_pallas(M[:, :4, :4], q[:, :4], l[:, :4],
                                       u[:, :4], z0[:, :4], vm[:, :4],
                                       interpret=True)


@pytest.mark.gpu
def test_compiled_kernel_on_gpu(gpu):
    """The compiled kernel on the card agrees with the XLA lane."""
    import jax
    M, q, l, u, vm = _rand_psd_lcp(64, 38, seed=11)
    args = [jax.device_put(a, gpu) for a in
            (_f32(M), _f32(q), _f32(l), _f32(u), np.zeros((64, 38),
                                                          np.float32), vm)]
    kw = dict(tol=1e-6, piv_tol=1e-5, max_pivots=1024)
    P = [np.asarray(a) for a in solve_lemke_batch_state_pallas(*args, **kw)]
    X = [np.asarray(a) for a in solve_lemke_batch_state(*args, **kw)]
    assert (P[1] == LEMKE_SUCCESS).all() and (X[1] == LEMKE_SUCCESS).all()
    _, ok, r = _refactor_resid(M, q, l, u, vm, P[3], P[4])
    assert ok.all() and r.max() < 1e-9


def _rand_psd_lcp(B, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    M = np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)[None]
    q = rng.standard_normal((B, n))
    l = np.zeros((B, n))
    u = np.full((B, n), np.inf)
    vm = np.ones((B, n), bool)
    return M, q, l, u, vm


def test_non_power_of_two_batch_pads():
    """Batch sizes of any count (one program per lane) give the XLA
    engine's results lane-for-lane."""
    for B in (3, 13, 33):
        M, q, l, u, vm = _rand_psd_lcp(B, 7, seed=B)
        P, X = _run_both(M, q, l, u, vm)
        zP, stP, pivP, basisP, valP = P
        zX, stX, pivX, basisX, valX = X
        assert zP.shape == (B, 7)
        assert (stP == LEMKE_SUCCESS).all()
        np.testing.assert_array_equal(stP, stX)
        np.testing.assert_array_equal(pivP, pivX)
        _, ok, r = _refactor_resid(M, q, l, u, vm, basisP, valP)
        assert ok.all() and r.max() <= 1e-10


def test_pivot_budget_parity_with_xla():
    """Budget-limited lanes must agree with the XLA engine: same pivot
    counts and the same LEMKE_MAX statuses (both engines execute at most
    max_pivots-1 body iterations)."""
    M, q, l, u, vm = _rand_psd_lcp(8, 12, seed=7)
    for mp in (4, 8, 1024):
        P, X = _run_both(M, q, l, u, vm, max_pivots=mp)
        _, stP, pivP, _, _ = P
        _, stX, pivX, _, _ = X
        np.testing.assert_array_equal(stP, stX)
        np.testing.assert_array_equal(pivP, pivX)
        assert (pivP <= mp).all()
