"""Scaling-efficiency measurement for the sharded equilibrium superstep and
the lockstep full-solve ensemble broker (SURVEY §2.3 row 8; target: ≥80%
scaling efficiency).

The measurement runs on VIRTUAL devices (host CPU scaling; the GPU mesh is
exercised by ``chip_smoke.py --devices 4``): one process
per device count D ∈ {1, 2, 4, 8} with
``--xla_force_host_platform_device_count=D`` on the CPU backend.  Virtual
devices share the machine's physical cores (4 here), so the meaningful
ceiling for compute-bound work is ``ideal(D) = min(D, ncores)``; efficiency
is reported against that core-limited ideal — at D ≤ ncores this is plain
strong-scaling efficiency, above it it measures sharding overhead under
oversubscription (the collectives, layout, and dispatch cost of the mesh
path, which is what transfers to real multi-chip meshes).

Usage: python benchmarks/scaling_bench.py [--quick]
Prints a table plus one JSON line with the efficiency ladder.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

NCORES = os.cpu_count() or 1

_WORKER = r"""
import os, sys, time, json
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from qpn_tpu.parallel.mesh import make_mesh
from qpn_tpu.parallel.sharded import equilibrium_superstep
from qpn_tpu.models.robust_avoid import scenario_batch_gavis

mode, S, reps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
D = len(jax.devices())
batch = scenario_batch_gavis(num_scenarios=S, T=2, num_obj=1,
                             num_poly_faces=4, seed=0)
mesh = make_mesh()

if mode == "superstep":
    run = lambda: equilibrium_superstep(mesh, batch, tol=1e-8)
    out = run()                     # compile + warm
    np.asarray(out["keep"])
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
        np.asarray(out["keep"])
    dt = (time.perf_counter() - t0) / reps
    conv = float(np.asarray(out["converged_frac"]))
elif mode == "shared":
    # shared-matrix trajectory route, scenario axis sharded over the mesh
    # (GEMM-extragradient-dominated at large S: the compute-bound batch
    # the efficiency north star is about)
    from qpn_tpu.ops.shared_kkt import solve_kkt_avi_shared
    run = lambda: solve_kkt_avi_shared(
        batch["M"], batch["q"], batch["l"], batch["u"], batch["mask"],
        tol=1e-8, mesh=mesh if D > 1 else None,
        structure=batch["structure"])
    out = run()                     # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    dt = (time.perf_counter() - t0) / reps
    conv = float(np.asarray(out.converged).mean())
elif mode == "procpool":
    # process-per-worker FULL solve() ensembles (parallel/procpool.py):
    # D is the worker count; startup (spawn + import + per-worker compile)
    # is deliberately inside the measurement — it is the real cost a user
    # pays, amortized over the ensemble
    from qpn_tpu.parallel.procpool import solve_many_processes
    import qpn_tpu as qt
    qpns = [qt.setup("robust_avoid_simple") for _ in range(S)]
    t0 = time.perf_counter()
    rets = solve_many_processes(qpns, n_workers=D)
    dt = (time.perf_counter() - t0) / 1
    conv = float(np.mean([r.solved for r in rets]))
else:
    from qpn_tpu.parallel.lockstep import solve_many_lockstep
    import qpn_tpu as qt
    qpns = [qt.setup("simple_bilevel", gen_solution_map=False)
            for _ in range(S)]
    x0s = [np.array([0.1 * i, 1.0, 0.0, 0.0]) for i in range(S)]
    solve_many_lockstep(qpns, x0s, mesh=mesh)   # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        rets, _ = solve_many_lockstep(qpns, x0s, mesh=mesh)
    dt = (time.perf_counter() - t0) / reps
    conv = float(np.mean([r.solved for r in rets]))

print(json.dumps({"devices": D, "wall_s": dt, "throughput": S / dt,
                  "conv": conv}))
"""


def measure(mode: str, devices: int, S: int, reps: int,
            pin_cores: bool = False) -> dict:
    """Run one (mode, device-count) point in a fresh subprocess.

    ``pin_cores`` pins the subprocess to ``min(devices, NCORES)`` physical
    cores (taskset).  This is the honest strong-scaling control for
    GEMM-dominated modes: XLA:CPU's intra-op threadpool already spreads a
    single virtual device's matmuls across every core, so an unpinned D=1
    baseline is secretly an NCORES-wide run and the ladder under-reports
    the sharding efficiency that transfers to real one-device-per-chip
    meshes."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # drop any inherited device-count flag (tests set one globally in
    # conftest) — LAST flag wins in XLA, so appending isn't enough
    inherited = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    env["XLA_FLAGS"] = (
        f"{inherited} --xla_force_host_platform_device_count={devices}"
    ).strip()
    if pin_cores:
        # one compute thread per virtual device: otherwise each device
        # still spawns an NCORES-wide intra-op pool that time-slices the
        # pinned cores (measured ~11% thrash at D=1, which would deflate
        # the baseline and flatter the ladder)
        env["XLA_FLAGS"] += " --xla_cpu_multi_thread_eigen=false"
    cmd = [sys.executable, "-c", _WORKER, mode, str(S), str(reps)]
    if pin_cores:
        import shutil
        if shutil.which("taskset"):
            cores = ",".join(str(i) for i in range(min(devices, NCORES)))
            cmd = ["taskset", "-c", cores] + cmd
        # no taskset (non-Linux): fall back to an unpinned run — the
        # ladder then under-reports efficiency rather than erroring
    out = subprocess.run(
        cmd, capture_output=True, text=True, env=env, timeout=1800,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if out.returncode != 0:
        raise RuntimeError(f"{mode}@{devices}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def ladder(mode: str, S: int, reps: int, counts=(1, 2, 4, 8),
           pin_cores: bool = False) -> dict:
    rows = {}
    base = None
    for d in counts:
        r = measure(mode, d, S, reps, pin_cores=pin_cores)
        if base is None:
            base = r["throughput"]
        ideal = min(d, NCORES)
        r["speedup"] = r["throughput"] / base
        r["efficiency_vs_core_ideal"] = r["speedup"] / ideal
        rows[d] = r
        print(f"{mode:10s} D={d}  wall={r['wall_s']:.3f}s  "
              f"thr={r['throughput']:.1f}/s  speedup={r['speedup']:.2f}  "
              f"eff(vs min(D,{NCORES}))={r['efficiency_vs_core_ideal']:.2f}",
              flush=True)
    return rows


def main():
    quick = "--quick" in sys.argv
    S = 128 if quick else 512
    reps = 2 if quick else 3
    print(f"ncores={NCORES}  S={S}  reps={reps}")
    result = {
        "ncores": NCORES,
        "superstep": ladder("superstep", S, reps),
        "shared": ladder("shared", 1024 if quick else 4096, reps,
                         counts=(1, 2, 4), pin_cores=True),
        "procpool": ladder("procpool", 24 if quick else 96, 1,
                           counts=(1, NCORES)),
        "lockstep": ladder("lockstep", 8 if quick else 16, 1),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
