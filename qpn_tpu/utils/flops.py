"""FLOP and byte accounting for the solver kernels (roofline/MFU reporting).

The reference publishes no performance model at all.  To judge single-card
quality honestly the bench
also reports *achieved* FLOP/s against the chip's peak (MFU) and the implied
HBM traffic against peak bandwidth — for these small dense systems the
binding roofline is latency/bandwidth, and the numbers make that visible
instead of hiding it behind a bare solves/s figure.

Counts are analytic per-iteration formulas (multiply+add = 2 flops), using
the iteration counts actually executed as reported by the solvers.  They
deliberately count the *useful* algorithm flops — padding lanes and padded
rows are excluded — so MFU reads as "useful work extracted from the chip".

Peak rates come from one table keyed by ``jax.Device.device_kind``; a
device that is not in it is an error, never a default.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 data sheet (SXM5 part, dense rates without sparsity; rated at
# the 700 W power limit — a card capped lower cannot hold them).  FLOP/s by
# operand type, "hbm" in bytes/s.
_H100_SXM = {
    "bf16": 989e12,
    "tf32": 495e12,
    "f32": 67e12,      # outside the tensor cores
    "f64": 67e12,      # f64 tensor cores; 34e12 on the CUDA cores
    "hbm": 3.35e12,
}
PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def device_peaks(device_kind: str) -> dict:
    """Peak FLOP/s and bytes/s of one device of this ``device_kind``."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no peak rates recorded for device kind "
                       f"{device_kind!r}; add its data-sheet rates to "
                       f"qpn_tpu.utils.flops.PEAKS") from None


def admm_flops(n: int, m: int, iters, *, ruiz_iters: int = 10,
               check_every: int = 25, adapt_every: int = 100,
               polish: bool = True) -> float:
    """FLOPs of one ADMM QP solve (ops/batch_qp._admm_solve) of n vars,
    m rows, running ``iters`` iterations. ``iters`` may be an array (batch).
    """
    iters = np.asarray(iters, dtype=np.float64)
    per_iter = (4 * m * n            # rhs assembly A'(Rz-y) and A x
                + 2 * n * n          # two triangular solves
                + 8 * (m + n))       # vector updates
    per_check = 2 * n * n + 4 * m * n
    per_adapt = 2 * m * n * n + n ** 3 / 3
    setup = (ruiz_iters * (2 * n * n + 2 * m * n)   # equilibration sweeps
             + 2 * m * n * n + n ** 3 / 3)          # A'RA + initial Cholesky
    polish_cost = (8.0 / 3.0) * (n + m) ** 3 if polish else 0.0
    return float(np.sum(setup + polish_cost
                        + iters * per_iter
                        + (iters / check_every) * per_check
                        + (iters / adapt_every) * per_adapt))


def newton_flops(n: int, iters, *, line_search: int = 8) -> float:
    """FLOPs of the semismooth-Newton polish (ops/avi._newton_polish_only):
    per iteration a ridge solve (normal equations + Cholesky) plus a batched
    line search of matvecs."""
    iters = np.asarray(iters, dtype=np.float64)
    per_iter = (2 * n ** 3           # A'A for the ridge normal equations
                + n ** 3 / 3         # Cholesky
                + 2 * n * n          # Jacobian assembly
                + line_search * 2 * n * n)
    return float(np.sum(iters * per_iter))


def lemke_flops(n: int, pivots) -> float:
    """FLOPs of the Lemke pivot loop: each pivot is a rank-1 update of the
    (n, 3n+2) tableau plus the basic-value matvec and ratio test."""
    pivots = np.asarray(pivots, dtype=np.float64)
    per_pivot = (2 * n * (3 * n + 2)      # rank-1 tableau update
                 + 2 * n * (3 * n + 1)    # basic-value recomputation
                 + n * n                  # lexicographic refinement bound
                 + 6 * n)
    return float(np.sum(pivots * per_pivot))


def admm_bytes(n: int, m: int, iters, dtype_bytes: int = 8) -> float:
    """Approximate HBM traffic of the ADMM loop: per iteration the A matrix
    is streamed twice (A'v and Ax) and the Cholesky factor once; vectors are
    negligible.  Cache residency makes this an upper bound for small shapes."""
    iters = np.asarray(iters, dtype=np.float64)
    per_iter = dtype_bytes * (2 * m * n + n * n)
    return float(np.sum(iters * per_iter))
