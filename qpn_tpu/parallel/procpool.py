"""Process-parallel full-solve ensembles: host-core scaling of solve().

The equilibrium OUTER loop (levels, piece enumeration, geometry pruning,
cycling checks) is host-side Python by nature — the reference runs it
serially and even its threading was disabled for correctness
(sets.jl:889-894).  The in-process options here both hit walls on
zoo-scale models:

* :mod:`.lockstep` fuses the ensemble's KERNEL waves but runs the host
  logic in threads — the GIL serializes it (measured ~1.05× at any device
  count);
* :func:`qpn_tpu.algorithm.solve_many` is the plain serial loop.

This module is the third leg: one OS process per worker, each solving
whole scenarios end-to-end on the host CPU backend.  No GIL, no shared
state, results bit-identical to the serial loop (same code path per
scenario; scenarios are independent).  QPNets and solve() payloads are
plain picklable data, and workers share the on-disk AOT kernel cache, so
compile cost is paid ~once across the pool.

This is deliberately the *host* analogue of scenario data-parallelism:
each worker is its own single-device JAX process on the CPU backend
(never the accelerator — a second JAX process on the card finds most of
its memory reserved by the first; accelerator-side scenario parallelism
is the sharded superstep's job, parallel/sharded.py).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

__all__ = ["solve_many_processes", "map_processes"]


def _proc_init(counter=None, pin: bool = False):
    # runs in the child BEFORE any qpn_tpu/numpy import.
    if pin and counter is not None:
        # one core per worker: the serial parent already spreads each
        # kernel over every core via XLA/BLAS intra-op threads, so an
        # unpinned pool oversubscribes ncores x nworkers threads and LOSES
        # to the serial loop (measured 0.7x at 4 workers / 4 cores)
        with counter.get_lock():
            idx = counter.value
            counter.value += 1
        ncores = os.cpu_count() or 1
        try:
            os.sched_setaffinity(0, {idx % ncores})
        except (AttributeError, OSError):  # pragma: no cover - non-Linux
            pass
        for var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS",
                    "MKL_NUM_THREADS"):
            os.environ[var] = "1"
    # the host CPU platform only, with every GPU hidden
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import jax
    jax.config.update("jax_platforms", "cpu")


def _proc_solve(job):
    qpn, x0, seed = job
    from qpn_tpu.algorithm import solve
    return solve(qpn, x0, seed=seed)


def solve_many_processes(qpns: Sequence, x_inits: Optional[Sequence] = None,
                         seed: int = 1,
                         n_workers: Optional[int] = None) -> List:
    """Solve a scenario ensemble with one process per worker.

    Same contract as :func:`qpn_tpu.algorithm.solve_many` (list of
    per-scenario solve() payloads, input order preserved); scenarios are
    distributed over ``n_workers`` (default: the machine's core count,
    capped at the ensemble size) OS processes running the CPU backend.
    Falls back to the serial loop for a single worker or a single
    scenario.
    """
    import multiprocessing as mp

    qpns = list(qpns)
    if x_inits is None:
        x_inits = [None] * len(qpns)
    x_inits = list(x_inits)
    if len(x_inits) != len(qpns):
        raise ValueError("x_inits length must match qpns")
    if n_workers is None:
        n_workers = min(os.cpu_count() or 1, len(qpns))
    n_workers = max(1, min(n_workers, len(qpns)))
    if n_workers == 1 or len(qpns) <= 1:
        from ..algorithm import solve_many
        return solve_many(qpns, x_inits, seed=seed)

    # spawn, not fork: the parent's JAX runtime (possibly holding a GPU
    # client) must not be duplicated into children
    ctx = mp.get_context("spawn")
    counter = ctx.Value("i", 0)
    jobs = [(qpn, x0, seed) for qpn, x0 in zip(qpns, x_inits)]
    with ctx.Pool(processes=n_workers, initializer=_proc_init,
                  initargs=(counter, True)) as pool:
        return pool.map(_proc_solve, jobs, chunksize=1)


def _call_job(job):
    fn, args = job
    return fn(*args)


def map_processes(fn, jobs: Sequence, n_workers: Optional[int] = None,
                  pin: bool = True) -> List:
    """Generic process-parallel map for host-side solver work.

    ``fn`` must be a module-level (picklable-by-reference) callable; each
    element of ``jobs`` is an argument tuple.  Workers are spawned CPU-only
    JAX processes with the same core-pinning discipline as
    :func:`solve_many_processes` (``pin=True``: one core per worker — an
    unpinned pool oversubscribes XLA/BLAS intra-op threads and LOSES to
    serial, measured).  ``n_workers=1`` runs in-process — with ``pin`` it
    still restricts THIS process to one core for the duration, so a
    1-vs-W ladder is an equal-cores-per-worker strong-scaling measurement
    (the control tests/test_scaling.py uses).
    """
    import multiprocessing as mp

    jobs = [(fn, tuple(a)) for a in jobs]
    if n_workers is None:
        n_workers = min(os.cpu_count() or 1, len(jobs))
    n_workers = max(1, min(n_workers, len(jobs)))
    if n_workers == 1 and not pin:
        return [_call_job(j) for j in jobs]
    # pinned single-worker runs in a spawned child too: pinning must land
    # BEFORE the jax/BLAS thread pools exist (re-pinning this process would
    # leave XLA's already-created intra-op threads on every core and void
    # the equal-cores control)
    ctx = mp.get_context("spawn")
    counter = ctx.Value("i", 0)
    with ctx.Pool(processes=n_workers, initializer=_proc_init,
                  initargs=(counter, pin)) as pool:
        return pool.map(_call_job, jobs, chunksize=1)
