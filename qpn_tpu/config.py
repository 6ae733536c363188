"""Global numeric configuration for the QP-Network framework.

The reference implementation (QuadraticProgramNetworks.jl) computes everything in
Float64 on CPU (OSQP at eps 1e-8, PATH at 1e-10 -- see /root/reference/src/avi.jl:66
and sets.jl:616-618).  Accelerators run f32 several times faster than f64, so
the working dtype is configurable:

* ``dtype = float64`` (default): bit-for-bit tolerance parity with the reference.
  Used for the equilibrium core, where tolerances down to 1e-10 matter.
* ``dtype = float32``: fast screening paths (bulk emptiness pre-checks, piece
  batch filtering) that are re-verified at f64.

jax x64 must be enabled before any jax array is created, so this module is
imported first by ``qpn_tpu/__init__.py``.
"""

from __future__ import annotations

import dataclasses

import os

import jax

jax.config.update("jax_enable_x64", True)
# Every float32 product runs at full f32 precision unless its call site names
# another: on the GPU XLA would otherwise run f32 matmuls in TF32 (about
# three decimal digits), which the EG pre-pass measurably pays for in
# host-solved lanes on the trajectory-scale ensembles (PERF.md).
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the solver's while-loop kernels are expensive
# to compile, so compiled code is kept across processes.
# JAX_COMPILATION_CACHE_DIR, when set, is the only cache (JAX reads it
# itself); otherwise the cache lives at a fixed path inside the checkout, so
# every process of one checkout hits it.
CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_compile_cache_dir() -> str | None:
    """The directory this package points JAX's compile cache at: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX then uses it unaided)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT_DIR, ".jax_cache")


_CACHE_DIR = default_compile_cache_dir()
if _CACHE_DIR is not None:
    os.makedirs(_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    # 0.1s threshold: the CPU path compiles ~100 small (<1s) kernels per
    # fresh process; caching them cuts the cold-start of every zoo model
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

import jax.numpy as jnp  # noqa: E402  (after x64 flag)
import numpy as np  # noqa: E402


@dataclasses.dataclass
class NumericConfig:
    # Working dtype of the equilibrium core.
    dtype: np.dtype = np.float64
    # Screening dtype for bulk prefilters (results always re-checked at `dtype`).
    screen_dtype: np.dtype = np.float32
    # Row-count bucket sizes used when padding ragged polyhedron batches to
    # static shapes.  Deliberately COARSE: the dominant cost of the host
    # loop is jit trace+compile per distinct shape (~0.2-1s each on CPU),
    # while padding waste is only flops in a
    # lockstep loop whose padded lanes converge instantly.  Coarse ladders
    # cap the shape space at a few dozen combos per process.
    row_buckets: tuple = (16, 64, 256, 1024)
    # Dimension buckets for the variable axis.
    dim_buckets: tuple = (8, 32, 128, 256)
    # Batch-size buckets for padded ensemble calls.
    batch_buckets: tuple = (1, 8, 64, 512, 2048)
    # Large-but-finite stand-in for Inf inside kernels that cannot tolerate it.
    big: float = 1e20
    # Two-tier ADMM straggler decoupling in solve_qp_batch_padded: the
    # batched while_loop is lockstep, so one slow lane drags the whole
    # padded batch to its iteration count (measured: most lanes converge
    # in <=300 iterations, a few certificate-bound lanes run to the 4000
    # cap, inflating batch cost ~5x).  Tier 1 runs this many iterations;
    # only unconverged lanes re-solve with the full budget in a second,
    # much smaller batch.  0 disables tiering.
    admm_tier1_iters: int = 250
    # On accelerator backends, run sub-threshold padded QP/LP batches on
    # the LOCAL CPU backend: geometry/verification LPs are host-algorithm
    # glue (the reference solves them in-process with OSQP), and every
    # accelerator dispatch pays a device round-trip that dwarfs the solve.
    # The accelerator keeps the large structured AVI batches.  Threshold in
    # elements of the padded P tensor (B * n * n).  Kept as chosen for the
    # earlier accelerator; whether the GPU still wants it is ROADMAP C3.
    small_qp_on_cpu: bool = True
    small_qp_cpu_max_elems: int = 1 << 17
    # Pivot-loop engine for the batched f32 Lemke solve: "auto" (default)
    # = the fused Pallas kernel (ops/lemke_pallas.py, one program per lane)
    # on the GPU for n <= LEMKE_KERNEL_MAX_N, the XLA while_loop lane
    # otherwise (ops/lemke.lemke_engine); "xla" forces the while_loop lane
    # everywhere.  Env override: QPN_LEMKE_KERNEL.
    lemke_kernel: str = os.environ.get("QPN_LEMKE_KERNEL", "auto")
    # Engine for pure LPs (support / emptiness / membership queries):
    # "admm" (default) = the first-order OSQP-style kernel — its
    # interior-ish selection among alternative optima matches the
    # reference's OSQP trajectories; "lemke" = exact complementary pivoting
    # on the LP KKT (tens of pivots, exact duals, uncertified lanes fall
    # back to ADMM) — faster per query but returns optimal *vertices*,
    # which can steer degenerate enumeration paths differently;
    # "check" = run both and log disagreements (engine cross-validation).
    # Overridable via env QPN_LP_ENGINE (benchmark/CI convenience).
    lp_engine: str = os.environ.get("QPN_LP_ENGINE", "admm")
    # Engine for SUPPORT-VALUE queries specifically (sets.jl:377-407 role).
    # Support values are unique (unlike argmin selections), so an exact
    # pivot engine cannot steer enumeration trajectories the way a global
    # lp_engine="lemke" does.  "host" (default) = the native C++ exact-
    # shape pivot kernel (utils/native.lemke_batch; ~0.1-1 ms per LP,
    # audited, ADMM fallback); "lemke" = the bucket-padded jit pivot
    # route (~2x slower than ADMM on CPU, kept for cross-checks);
    # "admm" = the batched first-order kernel.
    support_engine: str = os.environ.get("QPN_SUPPORT_ENGINE", "host")
    # Engine for the ε-inflation exemplar/emptiness LPs (sets.jl:591-642
    # role).  The EMPTINESS verdict (ε* vs ±tol, dual-activity flags) is
    # value-determined, but the witness POINT x* is selection-dependent:
    # the pivot engine returns a vertex of the margin-optimal face where
    # ADMM lands interior-ish, and downstream enumeration steers by the
    # witness.  Measured: "host" makes most zoo models ~2x faster but
    # drives robust_avoid(T=2) into a cycling failure — so the default
    # stays "admm" (matching the reference's OSQP witness character);
    # "host" is an opt-in speed knob for models known to tolerate it.
    exemplar_engine: str = os.environ.get("QPN_EXEMPLAR_ENGINE", "admm")
    # Engine for VERDICT-ONLY emptiness/membership queries (is_empty,
    # is_empty_batch, partial-x membership): the verdict is determined by
    # the unique ε*, so the native pivot engine is trajectory-safe here;
    # its vertex witnesses are quarantined in a separate cache namespace.
    empty_engine: str = os.environ.get("QPN_EMPTY_ENGINE", "host")
    # Auto-route block-tridiagonal trajectory KKTs through the cyclic-
    # reduction x-update (ops/banded.py): production QP batches whose
    # P / A'A patterns are block-banded with >= banded_min_blocks() blocks
    # factor in O(T k^3 log T) instead of O((Tk)^3).  Detection runs only
    # above ``banded_auto_min_n`` variables — below it the dense Cholesky
    # wins regardless (measured crossovers: see banded_min_blocks_*).
    banded_auto: bool = os.environ.get("QPN_BANDED_AUTO", "1") != "0"
    banded_auto_min_n: int = 48
    # Shared-matrix scenario ensembles (structure tag shared_M) route to the
    # GEMM extragradient + f32-LU/f64-refinement solver (ops/shared_kkt)
    # from this AVI dimension up: the Lemke tableau is (B, n, 3n+2) — at
    # trajectory scale (n=608 at T=8) it stops fitting and its rank-1
    # updates are bandwidth-bound, while the shared route's per-iteration
    # work is (S, n)@(n, n) GEMMs against ONE resident matrix.
    shared_kkt_min_n: int = 192
    # per-backend block-count crossovers (dense factorization wins below).
    # On the H100 the dense factor won at every horizon measured, T = 8..64
    # (benchmarks/banded_bench.py, PERF.md), so the GPU threshold sits past
    # the measured range; the CPU crossover is ~T=64.
    banded_min_blocks_gpu: int = 128
    banded_min_blocks_cpu: int = 64
    # Above this many pieces, remove_subsets runs a signature-duplicate
    # prune first (mesh/ring-sharded when >1 device) and replaces the
    # O(N²) Python pair materialization with a blockwise exemplar screen
    # (sets.jl:889-905 hazard regime).
    prune_dedup_threshold: int = 512


import contextlib  # noqa: E402


@contextlib.contextmanager
def glue_dispatch_device():
    """Unconditional host-CPU placement for host-algorithm glue solves.

    Some call sites are latency-bound glue REGARDLESS of tensor size — the
    per-QEP multi-start ``solve_avi`` (the reference's serial PATH call,
    avi.jl:63-77): a handful of restart lanes whose accelerator dispatch
    pays a device round-trip and a fresh XLA compile per new shape.  The
    accelerator keeps the large batched ensembles, which go through the
    batched entries.  (Placement kept from the earlier accelerator; ROADMAP
    C3 re-measures it on the GPU.)

    Honors ``CONFIG.small_qp_on_cpu = False`` as the explicit
    keep-everything-on-accelerator override (bench controlled comparisons
    set it)."""
    if CONFIG.small_qp_on_cpu and jax.default_backend() != "cpu":
        try:
            cpu = jax.local_devices(backend="cpu")[0]
        except RuntimeError:
            cpu = None
        if cpu is not None:
            with jax.default_device(cpu):
                yield True
            return
    yield False


@contextlib.contextmanager
def small_dispatch_device(n_elems: int):
    """Route sub-threshold kernel dispatches to the LOCAL CPU backend when
    the default backend is an accelerator (see ``small_qp_on_cpu``).

    The host-algorithm glue solves (geometry LPs, tiny QEP AVIs) are
    latency-bound: each accelerator dispatch pays a device round-trip that
    dwarfs the math.  The
    accelerator keeps the large batched ensembles (`n_elems` above the
    threshold).  Yields True when the CPU override is active."""
    if (CONFIG.small_qp_on_cpu and n_elems <= CONFIG.small_qp_cpu_max_elems
            and jax.default_backend() != "cpu"):
        try:
            cpu = jax.local_devices(backend="cpu")[0]
        except RuntimeError:
            cpu = None
        if cpu is not None:
            with jax.default_device(cpu):
                yield True
            return
    yield False


def effective_backend() -> str:
    """The platform kernels will actually land on: jax.default_backend()
    unless a default-device override (small_dispatch_device) is active — a
    GPU kernel must never be chosen for a CPU placement."""
    backend = jax.default_backend()
    dev = getattr(jax.config, "jax_default_device", None)
    if dev is not None and getattr(dev, "platform", None):
        backend = dev.platform
    return backend


def banded_min_blocks() -> int:
    """Minimum block count for the banded route to beat dense factorization
    on the backend the kernels land on."""
    return (CONFIG.banded_min_blocks_gpu if effective_backend() == "gpu"
            else CONFIG.banded_min_blocks_cpu)


CONFIG = NumericConfig()


def bucket(n: int, buckets) -> int:
    """Smallest bucket >= n (last bucket grows by doubling if exceeded)."""
    if n <= 0:
        return buckets[0]
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


def row_bucket(n: int) -> int:
    return bucket(n, CONFIG.row_buckets)


def dim_bucket(n: int) -> int:
    return bucket(n, CONFIG.dim_buckets)


def asdtype(x):
    return jnp.asarray(x, dtype=CONFIG.dtype)
