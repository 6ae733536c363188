"""Two-process jax.distributed dryrun.

Spawns 2 CPU processes (4 virtual devices each) joined by
``jax.distributed.initialize``; each runs one sharded equilibrium superstep
and a lockstep solve() ensemble over the global 8-device mesh, and the
results must match the single-process 8-device reference computed in this
process.  This is the ≥2-hosts north star (SURVEY §2.3 row 8) exercised as
far as a single machine allows: real cross-process collectives over the
distributed runtime, same math.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_superstep_and_lockstep_parity(tmp_path):
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "_multihost_worker.py")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    outs = [str(tmp_path / f"w{i}.npz") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(i), outs[i]],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for pp in procs:
                pp.kill()
            raise
        logs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-4000:]}"

    # single-process 8-device reference
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.parallel.mesh import make_mesh
    from qpn_tpu.parallel.sharded import equilibrium_superstep
    import qpn_tpu as qt
    mesh = make_mesh(8)
    batch = scenario_batch_gavis(num_scenarios=16, T=2, num_obj=1,
                                 num_poly_faces=4, seed=0)
    ref = equilibrium_superstep(mesh, batch, tol=1e-8)
    z_ref = np.asarray(ref["z"])
    keep_ref = np.asarray(ref["keep"])
    frac_ref = float(np.asarray(ref["converged_frac"]))

    ws = [np.array([0.0, 1.0]), np.array([1.0, 1.5])]
    x_ref = []
    for w in ws:
        r = qt.solve(qt.setup("simple_bilevel"),
                     np.concatenate([w, [0.0, 0.0]]))
        assert r.solved
        x_ref.append(np.asarray(r.x_opt))
    x_ref = np.stack(x_ref)

    # single-process shared-route reference over an 8-device mesh
    # (the trajectory-scale shared route across a
    # process boundary, lane-exact)
    from qpn_tpu.ops.shared_kkt import solve_kkt_avi_shared
    sb = scenario_batch_gavis(num_scenarios=4096, T=2, num_obj=1,
                              num_poly_faces=4, seed=0)
    sref = solve_kkt_avi_shared(sb["M"][0], sb["q"], sb["l"], sb["u"],
                                None, tol=1e-8,
                                structure=sb["structure"], mesh=mesh)
    assert bool(np.asarray(sref.converged).all())

    for i, path in enumerate(outs):
        d = np.load(path)
        assert d["process_index"] == i
        np.testing.assert_allclose(d["z"], z_ref, atol=1e-9,
                                   err_msg=f"superstep z, worker {i}")
        np.testing.assert_array_equal(d["keep"], keep_ref)
        assert abs(float(d["frac"]) - frac_ref) < 1e-12
        np.testing.assert_allclose(d["x_opts"], x_ref, atol=1e-9,
                                   err_msg=f"lockstep x_opt, worker {i}")
        assert int(d["waves"]) >= 1
        assert bool(d["shared_conv"].all()), f"shared route, worker {i}"
        np.testing.assert_allclose(
            d["shared_z"], np.asarray(sref.z), atol=1e-9,
            err_msg=f"shared-route z, worker {i}")
        np.testing.assert_array_equal(d["shared_iters"],
                                      np.asarray(sref.iters))
        assert float(d["shared_wall"]) > 0.0
