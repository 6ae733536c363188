"""Sequence-parallel (cyclic reduction) and ring-frontier tests."""

import numpy as np
import pytest

import jax

from qpn_tpu.ops import banded


def test_cyclic_reduction_matches_dense():
    for T, k in [(4, 3), (8, 2), (13, 4), (32, 3)]:
        A, B, C, b = banded.horizon_kkt_blocks(T, k,
                                               np.random.default_rng(T))
        x = np.asarray(banded.solve_block_tridiag(
            np.asarray(A), np.asarray(B), np.asarray(C), np.asarray(b)))
        M = banded.dense_from_blocks(A, B, C)
        x_ref = np.linalg.solve(M, b.reshape(-1)).reshape(T, k)
        assert np.allclose(x, x_ref, atol=1e-8), (T, k)


def test_cyclic_reduction_batched():
    rng = np.random.default_rng(0)
    batch = [banded.horizon_kkt_blocks(8, 3, rng) for _ in range(5)]
    A = np.stack([b[0] for b in batch])
    B = np.stack([b[1] for b in batch])
    C = np.stack([b[2] for b in batch])
    bb = np.stack([b[3] for b in batch])
    X = np.asarray(banded.solve_block_tridiag_batch(A, B, C, bb))
    for i in range(5):
        M = banded.dense_from_blocks(A[i], B[i], C[i])
        x_ref = np.linalg.solve(M, bb[i].reshape(-1)).reshape(8, 3)
        assert np.allclose(X[i], x_ref, atol=1e-8)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_ring_duplicate_mask():
    from qpn_tpu.parallel.mesh import make_mesh
    from qpn_tpu.parallel.ring import ring_duplicate_mask
    mesh = make_mesh(8)
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 5, size=(16, 3)).astype(np.int32)
    # candidates: half are copies of reference rows, half fresh
    cand = np.concatenate([ref[::2], 99 + np.arange(24).reshape(8, 3)
                           .astype(np.int32)])
    hit = np.asarray(ring_duplicate_mask(mesh, cand, ref))
    assert hit[:8].all()          # copies found somewhere in the ring
    assert not hit[8:].any()      # fresh signatures unmatched


def test_cr_factor_solve_matches_dense():
    """factor/solve split: one factorization, many RHS (the production ADMM
    reuse pattern), each matching the dense solve."""
    import jax.numpy as jnp
    from qpn_tpu.ops.banded import (cr_factor, cr_solve, dense_from_blocks,
                                    horizon_kkt_blocks)
    rng = np.random.default_rng(3)
    A, B, C, _ = horizon_kkt_blocks(16, 4, rng)
    fac = cr_factor(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C))
    M = dense_from_blocks(A, B, C)
    for _ in range(3):
        b = rng.standard_normal((16, 4))
        x = np.asarray(cr_solve(fac, jnp.asarray(b)))
        np.testing.assert_allclose(M @ x.flatten(), b.flatten(), atol=1e-8)


def test_banded_admm_matches_dense():
    """banded_k routes the ADMM x-update through cyclic reduction; results
    must match the dense-Cholesky route on trajectory-structured QPs."""
    from qpn_tpu.ops import batch_qp
    from qpn_tpu.ops.banded import dense_from_blocks, horizon_kkt_blocks
    rng = np.random.default_rng(5)
    T, k, B = 8, 4, 4
    n = T * k
    Ps, qs, As, ls, us = [], [], [], [], []
    for bi in range(B):
        A_, B_, C_, g = horizon_kkt_blocks(T, k, rng)
        Q = dense_from_blocks(A_, B_, C_)
        Q = 0.5 * (Q + Q.T) + 0.5 * np.eye(n)
        Ps.append(Q)
        qs.append(g.flatten())
        As.append(np.eye(n))
        ls.append(np.full(n, -2.0))
        us.append(np.full(n, 2.0))
    args = tuple(np.stack(a) for a in (Ps, qs, As, ls, us))
    mask = np.ones((B, n), dtype=bool)
    dense = batch_qp.solve_qp_batch(*args, mask)
    banded = batch_qp.solve_qp_batch(*args, mask, banded_k=k)
    assert np.all(np.asarray(banded.status) == batch_qp.SOLVED)
    np.testing.assert_allclose(np.asarray(banded.x), np.asarray(dense.x),
                               atol=1e-6)


def test_detect_banded_k():
    """Structure auto-detection: finds the true block size of trajectory
    KKT patterns, returns 0 for dense ones."""
    from qpn_tpu.ops.banded import detect_banded_k
    rng = np.random.default_rng(7)
    T, k = 16, 6
    n = T * k
    P = np.zeros((n, n))
    for t in range(T):
        G = rng.standard_normal((k, k))
        P[t * k:(t + 1) * k, t * k:(t + 1) * k] = G @ G.T
    F = rng.standard_normal((k, k))
    A = np.zeros(((T - 1) * k, n))
    for t in range(T - 1):
        A[t * k:(t + 1) * k, (t + 1) * k:(t + 2) * k] = np.eye(k)
        A[t * k:(t + 1) * k, t * k:(t + 1) * k] = -F
    assert detect_banded_k(P, A, min_blocks=8) == k
    # batched inputs: the union pattern must hold for every lane
    assert detect_banded_k(np.repeat(P[None], 3, 0),
                           np.repeat(A[None], 3, 0), min_blocks=8) == k
    # a dense matrix has no qualifying block size
    assert detect_banded_k(rng.standard_normal((n, n)), A,
                           min_blocks=8) == 0
    # one long-range coupling row kills bandedness
    A_bad = A.copy()
    A_bad[0, -1] = 1.0
    assert detect_banded_k(P, A_bad, min_blocks=8) == 0
    # min_blocks gate: T=16 blocks < min_blocks=32 -> no detection
    assert detect_banded_k(P, A, min_blocks=32) == 0


def test_banded_auto_route_production_entry():
    """solve_qp_batch_padded must auto-detect trajectory structure, route
    the x-update through cyclic reduction (banded_route counter), and
    return results identical to the dense route."""
    from qpn_tpu.config import CONFIG
    from qpn_tpu.ops import batch_qp
    from qpn_tpu.utils.metrics import METRICS
    rng = np.random.default_rng(11)
    T, k, B = 16, 6, 4
    n = T * k
    P = np.zeros((n, n))
    for t in range(T):
        G = rng.standard_normal((k, k))
        P[t * k:(t + 1) * k, t * k:(t + 1) * k] = G @ G.T / k + np.eye(k)
    F = 0.3 * rng.standard_normal((k, k))
    A = np.zeros(((T - 1) * k, n))
    for t in range(T - 1):
        A[t * k:(t + 1) * k, (t + 1) * k:(t + 2) * k] = np.eye(k)
        A[t * k:(t + 1) * k, t * k:(t + 1) * k] = -F
    c = 0.1 * rng.standard_normal((T - 1) * k)
    q = rng.standard_normal(n)
    Pb = np.repeat(P[None], B, 0)
    qb = np.repeat(q[None], B, 0)
    Ab = np.repeat(A[None], B, 0)
    lb = np.repeat(c[None], B, 0)
    mask = np.ones((B, A.shape[0]), dtype=bool)
    old_auto, old_cpu = CONFIG.banded_auto, CONFIG.banded_min_blocks_cpu
    try:
        CONFIG.banded_auto = False
        dense = batch_qp.solve_qp_batch_padded(Pb, qb, Ab, lb, lb.copy(),
                                               mask)
        CONFIG.banded_auto = True
        CONFIG.banded_min_blocks_cpu = 8      # exercise the route on CPU
        METRICS.reset()
        routed = batch_qp.solve_qp_batch_padded(Pb, qb, Ab, lb, lb.copy(),
                                                mask)
    finally:
        CONFIG.banded_auto = old_auto
        CONFIG.banded_min_blocks_cpu = old_cpu
    assert METRICS.counters.get("banded_route", 0) == B
    assert np.all(np.asarray(routed.status) == batch_qp.SOLVED)
    np.testing.assert_allclose(np.asarray(routed.x), np.asarray(dense.x),
                               atol=1e-8)


def _subset_zoo(n_centers, rng):
    from qpn_tpu.geometry.poly import Poly, PolyUnion
    polys = []
    for i in range(n_centers):
        c = rng.uniform(-5, 5, 2)
        w = rng.uniform(0.5, 1.5, 2)
        polys.append(Poly(np.eye(2), c - w, c + w))
        if i % 3 == 0:
            polys.append(Poly(np.eye(2), c - w, c + w))          # duplicate
        if i % 5 == 0:
            polys.append(Poly(np.eye(2), c - 0.3 * w, c + 0.3 * w))  # subset
    return PolyUnion(polys)


def test_remove_subsets_large_path_matches_pairwise():
    """Above prune_dedup_threshold, remove_subsets must switch to the
    signature-dedup (mesh-sharded with >1 device) + blockwise-screen path
    and return the EXACT piece set of the pairwise path."""
    from qpn_tpu.config import CONFIG
    from qpn_tpu.geometry import setops
    from qpn_tpu.utils.metrics import METRICS
    pu = _subset_zoo(40, np.random.default_rng(0))
    old = CONFIG.prune_dedup_threshold
    try:
        CONFIG.prune_dedup_threshold = 10 ** 9
        small = setops.remove_subsets(pu)
        CONFIG.prune_dedup_threshold = 8
        METRICS.reset()
        large = setops.remove_subsets(pu)
    finally:
        CONFIG.prune_dedup_threshold = old
    assert METRICS.counters.get("prune_dedup_dropped", 0) > 0
    if len(jax.devices()) > 1:
        assert METRICS.counters.get("prune_dedup_sharded", 0) == len(pu)
    sig = setops.piece_signature
    assert sorted(s.tobytes() for s in map(sig, small.polys)) == \
        sorted(s.tobytes() for s in map(sig, large.polys))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_remove_subsets_ring_regime():
    """≥RING_PRUNE_THRESHOLD pieces route the dedup stage through the
    ring-rotated prune (O(shard) memory) and the outcome still matches the
    host dedup mask."""
    from qpn_tpu.config import CONFIG
    from qpn_tpu.geometry.poly import Poly, PolyUnion
    from qpn_tpu.geometry import setops
    from qpn_tpu.parallel.sharded import RING_PRUNE_THRESHOLD
    rng = np.random.default_rng(2)
    # disjoint unit boxes on a grid, every 4th a duplicate: dedup does all
    # the work, the geometric stage sees pieces with disjoint interiors
    N = RING_PRUNE_THRESHOLD + 64
    polys = []
    for i in range(N):
        base = i - (i % 4 == 3)          # every 4th duplicates its neighbor
        c = np.array([3.0 * (base % 128), 3.0 * (base // 128)])
        polys.append(Poly(np.eye(2), c, c + 1.0))
    pu = PolyUnion(polys)
    out = setops.remove_subsets(pu)
    assert len(out) == N - N // 4
    from qpn_tpu.utils.metrics import METRICS
    assert METRICS.counters.get("prune_dedup_sharded", 0) >= N


def test_ring_fn_cached_and_multi_axis_rejected():
    """The jitted ring sweep must be reused across calls (jit caches on
    function identity — rebuilding the closure per call would recompile the
    shard_map every time), and >2-axis meshes must be rejected loudly (the
    rotation ring never crosses the third axis, so silent wrong answers)."""
    import pytest
    from jax.sharding import Mesh
    import jax
    from qpn_tpu.parallel.mesh import make_mesh
    from qpn_tpu.parallel import ring

    mesh = make_mesh(8)
    rng = np.random.default_rng(1)
    ref = rng.integers(0, 5, size=(16, 3)).astype(np.int32)
    cand = rng.integers(0, 5, size=(16, 3)).astype(np.int32)
    ring._ring_fn.cache_clear()
    ring.ring_duplicate_mask(mesh, cand, ref)
    ring.ring_duplicate_mask(mesh, cand + 1, ref + 1)
    info = ring._ring_fn.cache_info()
    assert info.misses == 1 and info.hits == 1

    devs = np.array(jax.devices()[:8]).reshape(2, 2, 2)
    mesh3 = Mesh(devs, ("a", "b", "c"))
    with pytest.raises(ValueError, match="1-D and 2-D"):
        ring.ring_duplicate_mask(mesh3, cand, ref)


def test_ring_prune_matches_all_gather_prune():
    """The ring-rotated prune must produce the SAME keep-mask as the
    all_gather prune (it replaces it above RING_PRUNE_THRESHOLD), including
    the strict lexicographic (quantized resid, index) tie-break."""
    from qpn_tpu.parallel.mesh import make_mesh
    from qpn_tpu.parallel.ring import ring_containment_prune
    from qpn_tpu.parallel.sharded import sharded_containment_prune
    mesh = make_mesh(8)
    rng = np.random.default_rng(3)
    B, k = 64, 5
    act = rng.integers(0, 3, size=(B, k)).astype(np.int32)
    act[1] = act[0]                    # exact duplicate group
    act[10] = act[0]
    resid = rng.random(B)
    resid[1] = resid[0]                # tie inside the group -> index breaks
    keep_ag = np.asarray(sharded_containment_prune(mesh, act, resid))
    keep_ring = np.asarray(ring_containment_prune(mesh, act, resid))
    np.testing.assert_array_equal(keep_ring, keep_ag)
    # exactly one survivor per duplicate group
    group = [0, 1, 10]
    assert keep_ring[group].sum() == 1
