"""Round-5 diagnostic: run the large shared-route row once in THIS process
and dump per-lane outcome fingerprints so two fresh-process runs can be
diffed (host_solves went 0->105 at fixed seed between
the builder's and the driver's runs of the same HEAD).

Usage:  python benchmarks/diag_large.py out.json [S] [T]
"""
import hashlib
import json
import sys
import time

import numpy as np


def main():
    out_path = sys.argv[1]
    S = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    T = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    import jax
    backend = jax.devices()[0].platform
    from qpn_tpu.config import CONFIG
    CONFIG.small_qp_on_cpu = False
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.ops import shared_kkt
    from qpn_tpu.ops.shared_kkt import solve_kkt_avi_shared

    big = scenario_batch_gavis(num_scenarios=S, T=T, num_obj=4,
                               num_poly_faces=4, seed=0)

    # wrap _eg_run to capture the EG output fingerprint (where divergence
    # would first enter)
    orig = shared_kkt._eg_run
    capture = {}

    def wrapped(*a, **k):
        r = orig(*a, **k)
        Z, _, at_l, at_u, kk = r
        Zh = np.asarray(Z, dtype=np.float32)
        capture["eg_chunks"] = int(kk)
        capture["eg_z_sha"] = hashlib.sha256(Zh.tobytes()).hexdigest()[:16]
        capture["eg_z_sum"] = float(np.float64(Zh.sum()))
        lab = np.asarray(at_l).astype(np.int8) + 2 * np.asarray(
            at_u).astype(np.int8)
        capture["eg_lab_sha"] = hashlib.sha256(lab.tobytes()).hexdigest()[:16]
        capture["eg_nlab"] = [int(lab.sum()), int((lab == 1).sum()),
                              int((lab == 2).sum())]
        return r
    shared_kkt._eg_run = wrapped

    stats = {}
    r = solve_kkt_avi_shared(big["M"][0], big["q"], big["l"], big["u"],
                             None, tol=1e-8, stats=stats,
                             structure=big["structure"])  # warm/compile
    warm_iters = np.asarray(r.iters).copy()
    capture_warm = dict(capture)
    stats = {}
    capture.clear()
    t0 = time.perf_counter()
    r = solve_kkt_avi_shared(big["M"][0], big["q"], big["l"], big["u"],
                             None, tol=1e-8, stats=stats,
                             structure=big["structure"])
    wall = time.perf_counter() - t0
    z = np.asarray(r.z)
    rec = {
        "backend": backend, "S": S, "T": T, "wall": round(wall, 3),
        "conv": float(np.asarray(r.converged).mean()),
        "host_solves": stats.get("host_solves"),
        "eg_iters": stats.get("eg_iters"),
        "lu_factored": stats.get("lu_factored"),
        "phase_t": stats.get("phase_t"),
        "z_sha": hashlib.sha256(
            np.round(z, 9).tobytes()).hexdigest()[:16],
        "iters_sha": hashlib.sha256(
            np.asarray(r.iters).tobytes()).hexdigest()[:16],
        "warm_eq_timed_iters": bool(
            (warm_iters == np.asarray(r.iters)).all()),
        "eg_capture_warm": capture_warm,
        "eg_capture_timed": dict(capture),
    }
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
