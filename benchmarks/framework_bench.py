"""Framework-level benchmark: full-equilibrium wall-clock across the model
zoo, plus solver-phase counters.

Unlike the driver's /root/repo/bench.py (single JSON line, kernel-level AVI
throughput), this prints a human-readable table of end-to-end solve times —
run it on the CPU or the GPU:

    python benchmarks/framework_bench.py [--cpu]
"""

import os
import sys
import time

import numpy as np

# runnable as a plain script from anywhere: the package lives at the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


CONFIGS = [
    ("simple_bilevel", dict(gen_solution_map=True),
     lambda: np.array([0.0, 1.0, 0.0, 0.0])),
    ("shepherd_sheep", dict(), None),
    ("toll_setting", dict(), None),
    ("rock_paper_scissors", dict(bilevel=True), None),
    ("trilevel_escape", dict(), None),
    ("four_player_matrix_game", dict(edge_list=[(1, 2), (3, 4)], seed=2),
     lambda: np.zeros(8)),
    ("robust_avoid_simple", dict(num_obj=1), None),
    ("chainstore", dict(num_towns=3), None),
    ("deep_synthetic", dict(levels=8, width=1), None),
    ("robust_avoid", dict(T=2, num_obj=1, num_poly_faces=3), None),
]


def main():
    if "--cpu" in sys.argv:
        import jax
        jax.config.update("jax_platforms", "cpu")
    json_path = None
    for a in sys.argv[1:]:
        if a.startswith("--json="):
            json_path = a[len("--json="):]
    import jax
    import qpn_tpu as qt

    print(f"backend: {jax.default_backend()}")
    print(f"{'model':34s} {'solved':7s} {'wall[s]':>8s} "
          f"{'qep':>4s} {'fast':>4s} {'pieces':>7s}")
    total = 0.0
    rows = {}
    for name, kwargs, x0 in CONFIGS:
        qpn = qt.setup(name, **kwargs)
        t0 = time.perf_counter()
        ret = qt.solve(qpn, None if x0 is None else x0())
        dt = time.perf_counter() - t0
        total += dt
        c = qpn.metrics.counters
        rows[name] = {
            "solved": bool(ret.solved), "wall_s": round(dt, 2),
            "qep": int(c.get("qep_solves", 0)),
            "fastpath": int(c.get("qep_potential_fastpath", 0)),
            "pieces": int(c.get("pieces_projected", 0)),
        }
        print(f"{name:34s} {str(bool(ret.solved)):7s} {dt:8.2f} "
              f"{int(c.get('qep_solves', 0)):4d} "
              f"{int(c.get('qep_potential_fastpath', 0)):4d} "
              f"{int(c.get('pieces_projected', 0)):7d}")
    print(f"{'TOTAL':34s} {'':7s} {total:8.2f}")
    if json_path:
        import json
        with open(json_path, "w") as fh:
            json.dump({"backend": jax.default_backend(),
                       "total_s": round(total, 2), "models": rows}, fh,
                      indent=1)


if __name__ == "__main__":
    main()
