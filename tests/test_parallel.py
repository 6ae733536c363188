"""Multi-device tests on the virtual 8-device CPU mesh: sharded batched AVI
solves, collective piece pruning, and the full equilibrium superstep."""

import numpy as np
import pytest

import jax


requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@requires_multidevice
def test_mesh_shapes():
    from qpn_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(8)
    assert np.prod(list(mesh.shape.values())) == 8
    assert set(mesh.axis_names) == {"scenario", "branch"}


@requires_multidevice
def test_sharded_avi_matches_single_device(rng):
    from qpn_tpu.parallel.mesh import make_mesh
    from qpn_tpu.parallel.sharded import sharded_avi_solve
    from qpn_tpu.ops.avi import solve_avi_batch
    B, n = 16, 6
    Ms, qs = [], []
    for _ in range(B):
        G = rng.standard_normal((n, n))
        Ms.append(G @ G.T + 0.5 * np.eye(n))
        qs.append(rng.standard_normal(n))
    M = np.array(Ms)
    q = np.array(qs)
    l = np.zeros((B, n))
    u = np.full((B, n), np.inf)
    z0 = np.zeros((B, n))
    mask = np.ones((B, n), dtype=bool)
    mesh = make_mesh(8)
    res_sh = sharded_avi_solve(mesh, M, q, l, u, z0, mask, tol=1e-10)
    res_1 = solve_avi_batch(M, q, l, u, z0, mask, tol=1e-10)
    assert np.asarray(res_sh.converged).all()
    assert np.allclose(np.asarray(res_sh.z), np.asarray(res_1.z), atol=1e-8)


@requires_multidevice
def test_containment_prune_deterministic():
    """Duplicate signatures: exactly one survivor per group, lowest index wins
    regardless of device placement (the reference's serial tie-break)."""
    from qpn_tpu.parallel.mesh import make_mesh
    from qpn_tpu.parallel.sharded import sharded_containment_prune
    mesh = make_mesh(8)
    act = np.array([[1, 0], [1, 0], [2, 2], [1, 0], [3, 1], [2, 2],
                    [0, 0], [0, 0]], dtype=np.int32)
    resid = np.zeros(8)
    keep = np.asarray(sharded_containment_prune(mesh, act, resid))
    assert keep.tolist() == [True, False, True, False, True, False,
                             True, False]


@requires_multidevice
def test_equilibrium_superstep():
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.parallel.mesh import make_mesh
    from qpn_tpu.parallel.sharded import equilibrium_superstep
    mesh = make_mesh(8)
    batch = scenario_batch_gavis(num_scenarios=16, T=1, num_obj=1,
                                 num_poly_faces=3, seed=0)
    out = equilibrium_superstep(mesh, batch, tol=1e-6, max_iter=420)
    assert np.isfinite(np.asarray(out["z"])).all()
    assert np.asarray(out["keep"]).shape == (16,)


@requires_multidevice
def test_equilibrium_superstep_routes_shared_at_trajectory_scale():
    """The superstep routes trajectory-scale shared-matrix ensembles
    through the shared GEMM route on the same mesh — the
    generic per-lane Newton kernel at n≥600 is slower."""
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.parallel.mesh import make_mesh
    from qpn_tpu.parallel.sharded import equilibrium_superstep
    from qpn_tpu.utils.metrics import METRICS
    mesh = make_mesh(8)
    batch = scenario_batch_gavis(num_scenarios=16, T=8, num_obj=4,
                                 num_poly_faces=4, seed=0)
    assert batch["M"].shape[1] >= 600
    c0 = METRICS.counters.get("shared_kkt_solves", 0)
    out = equilibrium_superstep(mesh, batch, tol=1e-8)
    assert float(np.asarray(out["converged_frac"])) == 1.0
    assert METRICS.counters.get("shared_kkt_solves", 0) > c0
    assert np.asarray(out["keep"]).shape == (16,)


@requires_multidevice
@pytest.mark.slow
def test_equilibrium_superstep_64():
    """The 64-scenario configuration through the sharded step."""
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.parallel.mesh import make_mesh
    from qpn_tpu.parallel.sharded import equilibrium_superstep
    mesh = make_mesh(8)
    batch = scenario_batch_gavis(num_scenarios=64, T=1, num_obj=1,
                                 num_poly_faces=3, seed=0)
    out = equilibrium_superstep(mesh, batch, tol=1e-8, max_iter=840)
    conv = float(out["converged_frac"])
    assert conv >= 0.9
    assert np.asarray(out["keep"]).shape == (64,)


def test_level_sweep_scan_matches_recursion():
    """SURVEY §2.3 row 6 (PP analogue): the bottom-up level pipeline as ONE
    lax.scan must reproduce the host-recursive solve on a chain network."""
    import qpn_tpu as qt
    from qpn_tpu.parallel.sharded import level_sweep_scan, stack_chain_avis
    qpn = qt.setup("deep_synthetic", levels=8, width=1)
    ret = qt.solve(qpn)
    assert ret.solved
    M, Nc, o, l, u, nd, owns = stack_chain_avis(qpn)
    carry, zs, resids = level_sweep_scan(M, Nc, o, l, u, nd, np.zeros(nd))
    assert float(np.max(np.asarray(resids))) < 1e-9
    x_sweep = np.zeros(qpn.num_vars)
    for lvl, own in enumerate(owns):
        x_sweep[own] = np.asarray(zs)[lvl, :nd]
    np.testing.assert_allclose(x_sweep, ret.x_opt, atol=1e-8)


def test_chain_sweep_routed_in_solve():
    """solve() routes chain networks through the level_sweep_scan warm start
   : the sweep counter fires, ZERO QEP solves remain,
    and the equilibrium + returned solution graphs are identical to the
    host-recursive route."""
    import qpn_tpu as qt
    import qpn_tpu.algorithm as alg
    from qpn_tpu.utils.metrics import METRICS
    qpn = qt.setup("deep_synthetic", levels=6, width=1)
    ret = qt.solve(qpn)
    assert ret.solved
    assert METRICS.counters.get("chain_sweep", 0) == 1
    assert METRICS.counters.get("qep_solves", 0) == 0
    x_sweep = ret.x_opt
    pieces_sweep = {k: len(v) for k, v in ret.Sol.items() if v is not None}
    orig = alg._chain_sweep_warmstart
    alg._chain_sweep_warmstart = lambda q: None
    try:
        ret2 = qt.solve(qt.setup("deep_synthetic", levels=6, width=1))
    finally:
        alg._chain_sweep_warmstart = orig
    assert ret2.solved
    np.testing.assert_allclose(x_sweep, ret2.x_opt, atol=1e-8)
    assert pieces_sweep == {k: len(v) for k, v in ret2.Sol.items()
                            if v is not None}
    # non-chain networks must not take the sweep (class checks fail loudly
    # inside stack_chain_avis and the fallback kicks in)
    qpn3 = qt.setup("simple_bilevel")
    assert alg._chain_sweep_warmstart(qpn3) is None


def test_level_sweep_scan_sharded_ensemble():
    """The level sweep vmaps over a scenario ensemble and shards over the
    mesh: vary the targets (the o vector) per scenario."""
    import functools
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P, NamedSharding
    import qpn_tpu as qt
    from qpn_tpu.parallel.mesh import make_mesh, scenario_sharding
    from qpn_tpu.parallel.sharded import level_sweep_scan, stack_chain_avis
    qpn = qt.setup("deep_synthetic", levels=4, width=1)
    M, Nc, o, l, u, nd, owns = stack_chain_avis(qpn)
    S = 16
    rng = np.random.default_rng(0)
    o_batch = np.repeat(o[None], S, axis=0)
    o_batch[:, :, :nd] += 0.1 * rng.standard_normal((S, o.shape[0], nd))
    mesh = make_mesh(8)
    sh = scenario_sharding(mesh)
    fn = jax.jit(jax.vmap(
        lambda ob: level_sweep_scan(M, Nc, ob, l, u, nd, np.zeros(nd))))
    carry, zs, resids = fn(jax.device_put(jnp.asarray(o_batch), sh))
    assert float(jnp.max(resids)) < 1e-8
    assert np.asarray(zs).shape[:2] == (S, M.shape[0])


def test_containment_prune_tiebreak_is_transitive():
    """A chain of pieces each within float-noise of the next must keep
    EXACTLY ONE per duplicate group (the epsilon-fuzzy comparison was
    non-transitive and could drop all of them)."""
    import numpy as np
    from qpn_tpu.parallel.mesh import make_mesh
    from qpn_tpu.parallel.sharded import sharded_containment_prune
    mesh = make_mesh(8)
    B = 8
    act = np.zeros((B, 3), dtype=np.int32)   # all identical signatures
    resid = np.array([2e-13, 1e-13, 0.0, 5e-14, 1.5e-13,
                      0.5e-13, 2.5e-13, 1e-14])
    keep = np.asarray(sharded_containment_prune(mesh, act, resid))
    assert keep.sum() == 1, f"expected exactly one survivor, got {keep}"
    # all resids quantize equal (within 1e-12): the lowest INDEX survives —
    # a deterministic, sharding-independent choice
    assert keep[0]


def test_checkpoint_save_is_atomic(tmp_path):
    """save_state must tmp+rename: it overwrites the previous checkpoint
    every outer iteration, and a kill mid-write must not destroy it."""
    import numpy as np
    from qpn_tpu.utils.checkpoint import load_state, save_state
    path = str(tmp_path / "ck")
    save_state(path, np.arange(3.0))
    x1 = load_state(path)["x"]
    # second save over the first; no .tmp leftovers; still loadable
    save_state(path, np.arange(3.0) + 1)
    import os
    leftovers = [f for f in os.listdir(tmp_path) if ".tmp" in f]
    assert not leftovers
    x2 = load_state(path)["x"]
    np.testing.assert_allclose(x2, x1 + 1)
