"""End-to-end scenario-ensemble equilibrium benchmark.

Runs ONE full sharded equilibrium superstep at trajectory scale — the
workload class the reference explicitly cannot run ("Medium and Large-scale
problems may be difficult or impossible", reference README.md:6): S=1024
robust_avoid certificate-game equilibria at T=8 / num_obj=4 (n=608 KKT
each), solved to a 1e-8 audited natural residual through the production
router (shared GEMM + policy-iteration route), followed by the collective
active-set signature prune (the ensemble-level solution-map dedup).

Every lane is a complete equilibrium problem of the deepest level of the
robust_avoid network; the superstep is the framework's "training step"
analogue (parallel/sharded.py).  The multilevel zoo class with per-model
solution graphs stays host-glue-bound by design — THIS class is where the
card is supposed to dominate, so the artifact records fresh-process cold
and warm walls for direct GPU-vs-CPU ratios.

    python benchmarks/e2e_ensemble_bench.py out.json [--cpu] [S] [T]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    out_path = sys.argv[1]
    if "--cpu" in sys.argv:
        import jax
        jax.config.update("jax_platforms", "cpu")
    pos = [a for a in sys.argv[2:] if not a.startswith("-")]
    S = int(pos[0]) if pos else 1024
    T = int(pos[1]) if len(pos) > 1 else 8
    import jax
    backend = jax.default_backend()
    from qpn_tpu.config import CONFIG
    CONFIG.small_qp_on_cpu = False          # same-device comparison
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.parallel.mesh import make_mesh
    from qpn_tpu.parallel.sharded import equilibrium_superstep

    mesh = make_mesh(len(jax.devices()))
    batch = scenario_batch_gavis(num_scenarios=S, T=T, num_obj=4,
                                 num_poly_faces=4, seed=0)
    n = batch["M"].shape[1]

    t0 = time.perf_counter()
    step = equilibrium_superstep(mesh, batch, tol=1e-8)
    frac = float(np.asarray(step["converged_frac"]))
    cold = time.perf_counter() - t0

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step = equilibrium_superstep(mesh, batch, tol=1e-8)
        frac = float(np.asarray(step["converged_frac"]))
        walls.append(time.perf_counter() - t0)
    keep = np.asarray(step["keep"])
    rec = {
        "config": f"robust_avoid certificate ensemble T={T} num_obj=4 "
                  f"S={S} n={n}, full superstep (solve + signature prune)",
        "backend": backend,
        "devices": len(jax.devices()),
        "converged_frac": round(frac, 4),
        "unique_pieces_kept": int(keep.sum()),
        "wall_cold_s": round(cold, 2),
        "wall_warm_s": round(float(np.median(walls)), 2),
        "wall_warm_min_s": round(min(walls), 2),
        "wall_warm_max_s": round(max(walls), 2),
        "ensembles_per_sec_warm": round(S / float(np.median(walls)), 1),
    }
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
