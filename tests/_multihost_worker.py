"""Worker process for the two-process jax.distributed dryrun
(tests/test_multihost.py).  Run as:

    python tests/_multihost_worker.py <coordinator_port> <process_id> <out.npz>

Each of the 2 processes exposes 4 virtual CPU devices; after
jax.distributed.initialize the global mesh has 8 devices spanning both.
The worker runs (a) one sharded equilibrium superstep — real cross-process
collectives — and (b) a lockstep solve() ensemble with its kernel waves
sharded over the SAME global mesh (SPMD: both processes issue identical
fused dispatches thanks to the broker's canonical wave ordering), then
writes its view of the results for the parent to compare against the
single-process reference.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax                                              # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np                                      # noqa: E402


def main():
    port, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    from qpn_tpu.parallel import multihost
    multihost.init(coordinator_address=f"localhost:{port}",
                   num_processes=2, process_id=pid)
    info = multihost.process_info()
    assert info["process_count"] == 2, info
    assert info["global_devices"] == 8, info

    mesh = multihost.global_mesh()

    # (a) sharded equilibrium superstep across both processes
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.parallel.sharded import equilibrium_superstep
    batch = scenario_batch_gavis(num_scenarios=16, T=2, num_obj=1,
                                 num_poly_faces=4, seed=0)
    step = equilibrium_superstep(mesh, batch, tol=1e-8)
    from qpn_tpu.parallel.sharded import _fetch_global
    z_full = _fetch_global(step["z"])
    keep = _fetch_global(step["keep"])
    frac = float(_fetch_global(step["converged_frac"]))

    # (b) lockstep solve() ensemble, kernel waves sharded over the global
    # mesh — every process runs the same scenarios (SPMD replication of the
    # host control flow; device dispatches are collective)
    import qpn_tpu as qt
    from qpn_tpu.parallel.lockstep import solve_many_lockstep
    ws = [np.array([0.0, 1.0]), np.array([1.0, 1.5])]
    qpns = [qt.setup("simple_bilevel") for _ in ws]
    x0s = [np.concatenate([w, [0.0, 0.0]]) for w in ws]
    outs, broker = solve_many_lockstep(qpns, x0s, mesh=mesh)
    for o in outs:
        assert o.solved, getattr(o, "error", None) or vars(o)
    x_opts = np.stack([np.asarray(o.x_opt) for o in outs])

    # (c) trajectory-scale shared-KKT route over the SAME process-spanning
    # mesh: S=4096 scenarios shard across both
    # processes' devices; the EG pre-pass and fused round 0 are global SPMD
    # dispatches (allgather fetches), the policy rounds / rungs replicate
    # host-side — lane outcomes must be EXACTLY the single-process ones.
    import time
    from qpn_tpu.ops.shared_kkt import solve_kkt_avi_shared
    sb = scenario_batch_gavis(num_scenarios=4096, T=2, num_obj=1,
                              num_poly_faces=4, seed=0)
    t0 = time.perf_counter()
    res = solve_kkt_avi_shared(sb["M"][0], sb["q"], sb["l"], sb["u"], None,
                               tol=1e-8, structure=sb["structure"],
                               mesh=mesh)
    shared_wall = time.perf_counter() - t0

    np.savez(out_path, z=z_full, keep=keep, frac=frac, x_opts=x_opts,
             waves=broker.waves, process_index=info["process_index"],
             shared_z=np.asarray(res.z), shared_iters=np.asarray(res.iters),
             shared_conv=np.asarray(res.converged),
             shared_wall=shared_wall)
    print("WORKER_OK", pid, flush=True)


if __name__ == "__main__":
    main()
