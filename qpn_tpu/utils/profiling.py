"""Profiler integration — JAX traces for the solver phases.

The reference has no profiling at all (SURVEY.md §5).  This wraps
``jax.profiler`` so any solve can emit a TensorBoard-compatible trace, and
adds named step annotations around the major phases (they appear as ranges in
the trace viewer alongside the XLA kernels).
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile a block (default directory: ``traces/`` in the checkout)::

        from qpn_tpu.utils.profiling import trace
        with trace("traces/solve"):
            qt.solve(qpn)
    """
    import jax
    if log_dir is None:
        from ..config import CHECKOUT_DIR
        log_dir = os.path.join(CHECKOUT_DIR, "traces")
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named range inside an active trace."""
    import jax
    with jax.profiler.TraceAnnotation(name):
        yield
