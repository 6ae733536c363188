"""Process-parallel full-solve ensembles (parallel/procpool.py): host-core
scaling of the OUTER equilibrium loop, the leg the GIL denies the lockstep
broker (its lockstep ladder measured ~1.05x at any D)."""

import numpy as np
import pytest

import qpn_tpu as qt
from qpn_tpu.parallel.procpool import solve_many_processes


@pytest.mark.slow
def test_procpool_matches_serial():
    qpns = [qt.setup("simple_bilevel") for _ in range(6)]
    x0s = [np.array([0.25 * i - 0.5, 1.0, 0.0, 0.0]) for i in range(6)]
    rets = solve_many_processes(qpns, x0s, n_workers=3)
    ser = qt.solve_many(qpns, x0s)
    assert all(r.solved for r in rets)
    for a, b in zip(rets, ser):
        np.testing.assert_allclose(a.x_opt, b.x_opt, atol=1e-10)


def test_procpool_single_worker_is_serial_loop():
    qpns = [qt.setup("simple_bilevel") for _ in range(2)]
    x0s = [np.array([0.0, 1.0, 0.0, 0.0])] * 2
    rets = solve_many_processes(qpns, x0s, n_workers=1)
    assert all(r.solved for r in rets)


def test_procpool_rejects_mismatched_inits():
    qpns = [qt.setup("simple_bilevel") for _ in range(2)]
    with pytest.raises(ValueError, match="length"):
        solve_many_processes(qpns, [None])


def test_map_processes_generic():
    """map_processes ships a module-level fn to pinned spawned workers and
    preserves job order."""
    from qpn_tpu.parallel.procpool import map_processes
    from qpn_tpu.models.robust_avoid import hard_chunk_job
    out = map_processes(hard_chunk_job, [(2, 2, 1, 3, 0, 1e-8)] * 2,
                        n_workers=2)
    assert len(out) == 2
    assert all(o[0] == 1.0 for o in out)
    assert out[0] == out[1]          # identical jobs, identical results


@pytest.mark.slow
def test_procpool_hard_class_ladder():
    """Strong-scaling ladder on the DEGENERATE trajectory class: seed-2
    robust_avoid T=8 certificate ensembles through the shared route, 1/2/4 one-core-pinned workers, warm pools (one uncounted
    job per worker).  Gates carry the measured hardware margin: a pure
    single-thread GEMM control on this box loses ~9% per core at all-core
    load (turbo/memory clock), and the warm 12-job ladder measured
    0.92 @ 2 / 0.75 @ 4 (benchmarks/procpool_hard_bench.py)."""
    import os
    sys_cores = os.cpu_count() or 1
    if sys_cores < 4:
        pytest.skip("ladder needs 4 cores")
    from benchmarks.procpool_hard_bench import measure
    eff2 = eff4 = 0.0
    jobs = 8
    for attempt in range(2):
        r1 = measure(1, jobs, 8)
        r2 = measure(2, jobs, 8)
        r4 = measure(4, jobs, 8)
        eff2 = max(eff2, (r2["jobs_per_sec"] / r1["jobs_per_sec"]) / 2)
        eff4 = max(eff4, (r4["jobs_per_sec"] / r1["jobs_per_sec"]) / 4)
        assert r1["checksum"] == r2["checksum"] == r4["checksum"]
        if eff2 >= 0.85 and eff4 >= 0.62:
            break
        jobs = 16
    assert eff2 >= 0.85, f"hard-class procpool eff@2={eff2:.2f}"
    assert eff4 >= 0.62, f"hard-class procpool eff@4={eff4:.2f}"
