"""Process-pool strong-scaling ladder on the DEGENERATE trajectory class
1/2/4 pinned workers over seed-2 robust_avoid T=8 certificate-ensemble
solves — the hard class, not a benign zoo model.

Each job is a complete shared-route solve (EG pre-pass, fused round 0,
structured-QP rung, audited 1e-8) of an S-lane seed-2 ensemble
(models/robust_avoid.hard_chunk_job).  Workers are one-core-pinned spawned
CPU processes (parallel/procpool.map_processes), and the 1-worker baseline
runs pinned too — equal cores PER WORKER, the same control as
benchmarks/scaling_bench.py.

    python benchmarks/procpool_hard_bench.py [n_jobs] [S_per_job]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NCORES = os.cpu_count() or 1


def measure(n_workers: int, n_jobs: int = 4, S: int = 8, warm: bool = True):
    """Wall-clock of ``n_jobs`` hard-class solves on ``n_workers`` pinned
    worker processes.

    ``warm=True`` first runs one uncounted job per worker ON THE SAME POOL
    (workers import jax + trace the kernels there), then times the real
    batch — the sustained-throughput measurement.  The per-worker one-time
    cost is real but amortizes over any production-size ensemble (measured:
    48 cold jobs → batch eff 0.76 at 4 workers vs 0.90 marginal)."""
    import multiprocessing as mp
    from qpn_tpu.models.robust_avoid import hard_chunk_job
    from qpn_tpu.parallel import procpool
    job = (hard_chunk_job, (S, 8, 4, 4, 2, 1e-8))
    ctx = mp.get_context("spawn")
    counter = ctx.Value("i", 0)
    with ctx.Pool(processes=n_workers, initializer=procpool._proc_init,
                  initargs=(counter, True)) as pool:
        if warm:
            pool.map(procpool._call_job, [job] * n_workers, chunksize=1)
        t0 = time.perf_counter()
        out = pool.map(procpool._call_job, [job] * n_jobs, chunksize=1)
        wall = time.perf_counter() - t0
    convs = [o[0] for o in out]
    sums = {o[2] for o in out}
    assert all(c == 1.0 for c in convs), convs
    assert len(sums) == 1, f"worker results diverged: {sums}"
    return dict(workers=n_workers, jobs=n_jobs, wall=wall,
                jobs_per_sec=n_jobs / wall, checksum=out[0][2])


def main():
    n_jobs = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    S = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    rows = []
    for w in (1, 2, 4):
        if w > NCORES:
            break
        r = measure(w, n_jobs, S)
        rows.append(r)
        base = rows[0]["jobs_per_sec"]
        eff = (r["jobs_per_sec"] / base) / r["workers"]
        print(f"workers={w} wall={r['wall']:.1f}s "
              f"jobs/s={r['jobs_per_sec']:.3f} eff={eff:.2f}", flush=True)


if __name__ == "__main__":
    main()
