"""Cross-process AOT kernel cache built on jax.export.

Cold-start anatomy on this framework (measured, robust_avoid_simple):
a fresh process pays ~2s of PYTHON TRACING per distinct shape bucket of
the vmapped ADMM while_loop kernel (plus <0.3s XLA compile, which the
persistent compilation cache in config.py already skips).  The reference
binary (Julia + precompiled C solvers) pays nothing — "interactive feel"
parity requires killing the tracing tax, not just the compile tax.

jax.export serializes the traced StableHLO; deserializing it in a later
process skips tracing entirely and re-uses the persistent XLA cache for
the compile.  This module memoizes exported kernels on disk keyed by
(tag, abstract signature, backend, source hash) and in memory per
process.

Export happens in a SUBPROCESS (aot_export_worker), never on a thread:
exporting on a background thread while the main thread is also tracing
corrupts the traced program (measured: artifacts whose StableHLO differs
wholesale from a clean export and segfaults XLA:CPU at execution).  The
worker additionally validates each artifact by round-tripping and
EXECUTING it before install, so a bad program can only kill the worker.

Scope: host-driver kernels with numpy in / numpy-consumed out (the
geometry/verification batch kernels).  NOT used under jit or vmap; only
active on the CPU backend, and the worker runs with the accelerator hidden
(one process per card: a second JAX process on the card would find most of
its memory reserved by the parent).

Degrades gracefully: any failure (export unsupported, version skew,
corrupt file) falls back to calling the live jitted function.  Disable
with QPN_AOT_CACHE=0.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
from typing import Callable, Optional

import numpy as np

def _default_dir() -> str:
    from ..config import CHECKOUT_DIR
    return os.path.join(CHECKOUT_DIR, ".aot_cache")


_DIR = os.environ.get("QPN_AOT_CACHE_DIR") or _default_dir()
_ENABLED = os.environ.get("QPN_AOT_CACHE", "1") != "0"
_KEY_VERSION = "v2"     # bumped when the artifact pipeline changes

_MEM: dict = {}
_LOCK = threading.Lock()
_REGISTERED = False
_SRC_HASH: Optional[str] = None

_PENDING: dict = {}              # key -> job dict (not yet handed off)
_WORKER: Optional[subprocess.Popen] = None
_WORKER_JOBFILE: Optional[str] = None


def cpu_only_env() -> dict:
    """Environment for a helper process that must stay off the accelerator:
    the CPU platform only, with every GPU hidden."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _src_hash() -> str:
    """Content hash over the kernel-defining sources: an edit to any of
    them invalidates every cached export (correctness over reuse)."""
    global _SRC_HASH
    if _SRC_HASH is None:
        import jax
        h = hashlib.sha1(jax.__version__.encode())
        root = os.path.dirname(os.path.dirname(__file__))
        for rel in ("ops/batch_qp.py", "ops/banded.py", "ops/linalg.py",
                    "ops/lemke.py"):
            p = os.path.join(root, rel)
            if os.path.exists(p):
                h.update(open(p, "rb").read())
        _SRC_HASH = h.hexdigest()[:16]
    return _SRC_HASH


def _register_types() -> None:
    global _REGISTERED
    if _REGISTERED:
        return
    from jax import export as jexport
    from ..ops.batch_qp import QPSolution
    try:
        jexport.register_namedtuple_serialization(
            QPSolution, serialized_name="qpn_tpu.QPSolution")
    except ValueError:
        pass    # already registered
    _REGISTERED = True


def _sig_of(a):
    if hasattr(a, "dtype") and hasattr(a, "shape"):
        return str(a.dtype), list(a.shape)    # no materialization
    a = np.asarray(a)
    return str(a.dtype), list(a.shape)


def _effective_backend() -> str:
    """The backend computations will actually run on: honors the
    small-dispatch CPU override (config.small_dispatch_device sets
    jax.default_device without changing default_backend), so an
    accelerator-default process reuses the CPU artifacts the CPU-only
    processes exported — the re-tracing tax would otherwise return on
    every accelerator run."""
    import jax
    dev = getattr(jax.config, "jax_default_device", None)
    if dev is not None and getattr(dev, "platform", None):
        return dev.platform
    return jax.default_backend()


def _effective_ndev(backend: str) -> int:
    import jax
    try:
        return len(jax.local_devices(backend=backend))
    except RuntimeError:
        return jax.local_device_count()


def _static_names(jit_fn) -> tuple:
    """The jit's static argnames: their VALUES are baked into an exported
    artifact (jax.export traces with statics applied and the module's
    in_tree carries only the dynamic inputs)."""
    ji = getattr(jit_fn, "_jit_info", None)
    return tuple(getattr(ji, "static_argnames", ()) or ())


def _key(tag: str, args, kwargs, static_kw=None) -> str:
    backend = _effective_backend()
    # device count matters: executing an artifact exported under a
    # 1-device runtime inside an N-virtual-device runtime (test meshes)
    # segfaults XLA:CPU — measured, not hypothetical
    ndev = _effective_ndev(backend)
    sig = ",".join("%s%s" % _sig_of(a) for a in args)
    ksig = ",".join("%s=%s%s" % ((k,) + _sig_of(v))
                    for k, v in sorted(kwargs.items()))
    if static_kw:
        # static values select DIFFERENT baked programs: key on the value
        ksig += "|st:" + repr(sorted(static_kw.items()))
    raw = (f"{_KEY_VERSION}|{tag}|{backend}|d{ndev}|{sig}|{ksig}|"
           f"{_src_hash()}")
    return hashlib.sha1(raw.encode()).hexdigest()[:24]


def call_aot(tag: str, jit_fn: Callable, *args, **kwargs):
    """Call ``jit_fn(*args, **kwargs)`` through the AOT cache.

    ``jit_fn`` must be a MODULE-LEVEL jax.jit-wrapped function (the
    export worker re-imports it by ``module:name``); array args and
    scalar kwargs become *inputs* of the exported module (scalars are
    traced, not baked, so one artifact serves every value), while the
    jit's static args are baked at export — encode their values in
    ``tag``.  First use of a signature schedules a subprocess export;
    later processes deserialize instead of re-tracing.
    """
    if not _ENABLED:
        return jit_fn(*args, **kwargs)
    # the jit's STATIC kwargs must stay Python values (normalizing them to
    # 0-d arrays makes them unhashable and the live jit call raises); they
    # are keyed by VALUE and baked into the exported artifact, which is
    # then called with the dynamic inputs only
    statics = _static_names(jit_fn)
    static_kw = {k: v for k, v in kwargs.items() if k in statics}
    # normalize dynamic scalar knobs to strong-typed numpy scalars so the
    # live trace, the cache key, and the worker-exported artifact (built
    # from dtype/shape specs) all agree on the input signature
    dyn_kw = {k: (np.asarray(v) if isinstance(v, (bool, int, float))
                  else v) for k, v in kwargs.items() if k not in statics}
    try:
        key = _key(tag, args, dyn_kw, static_kw)
    except Exception:
        return jit_fn(*args, **dyn_kw, **static_kw)
    fn = _MEM.get(key)
    if fn is None:
        with _LOCK:
            fn = _MEM.get(key)
            if fn is None:
                fn = _load_or_schedule(key, jit_fn, args, dyn_kw, static_kw)
                _MEM[key] = fn
    if fn is jit_fn:
        return jit_fn(*args, **dyn_kw, **static_kw)
    try:
        return fn.call(*args, **dyn_kw)     # statics are baked
    except Exception:
        # incompatible artifact: quarantine and go live
        _MEM[key] = jit_fn
        return jit_fn(*args, **dyn_kw, **static_kw)


_WARM = False


def _warmup_runtime() -> None:
    """Register the lazily-initialized CPU linalg FFI handlers before any
    deserialized artifact executes.  Measured failure mode: an exported
    module whose cholesky/triangular-solve lowers to a LAPACK custom call
    segfaults in any process that never lowered a linalg op through the
    live jit path (the FFI targets register during lowering); one tiny
    live compile (~0.1s, once per process) inoculates."""
    global _WARM
    if _WARM:
        return
    import jax
    import jax.numpy as jnp
    e = np.eye(2)

    def _probe(a):
        c = jnp.linalg.cholesky(a + 3 * jnp.eye(2))
        t = jax.scipy.linalg.solve_triangular(c, e, lower=True)
        qg, _ = jnp.linalg.qr(t)
        return qg

    jax.block_until_ready(jax.jit(_probe)(e))
    _WARM = True


def _subdir() -> str:
    """Artifacts are segregated by backend and virtual device count so a
    validator child never executes an artifact under a runtime different
    from the one it was exported for."""
    backend = _effective_backend()
    return os.path.join(_DIR, f"{backend}-d{_effective_ndev(backend)}")


def _load_or_schedule(key: str, jit_fn: Callable, args, kwargs,
                      static_kw=None):
    """Disk hit (validated) → deserialized artifact.  Miss → return the
    live jit NOW and schedule a subprocess export, so the first-ever run
    never pays the export's second trace; the artifact serves the next
    process once a NON-exporting process has validated it (``.ok``)."""
    from jax import export as jexport
    _register_types()
    path = os.path.join(_subdir(), key + ".stablehlo")
    if os.path.exists(path + ".ok") and os.path.exists(path):
        try:
            _warmup_runtime()
            return jexport.deserialize(open(path, "rb").read())
        except Exception:
            for p in (path, path + ".ok"):
                try:
                    os.remove(p)
                except OSError:
                    pass
    elif os.path.exists(path) or os.path.exists(path + ".bad"):
        return jit_fn    # exported-not-yet-validated or tombstoned: live
    _schedule_export(key, path, jit_fn, args, kwargs, static_kw)
    return jit_fn     # sentinel: call the live function this process


def _fn_ref(jit_fn) -> Optional[str]:
    mod = getattr(jit_fn, "__module__", None)
    name = getattr(jit_fn, "__name__", None)
    if not mod or not name:
        return None
    return f"{mod}:{name}"


def _schedule_export(key, path, jit_fn, args, kwargs,
                     static_kw=None) -> None:
    backend = _effective_backend()
    if backend != "cpu":
        return      # the CPU-only worker can't lower/validate for the GPU
    ref = _fn_ref(jit_fn)
    if ref is None:
        return
    static_kw = static_kw or {}
    if not all(isinstance(v, (bool, int, float, str, type(None)))
               for v in static_kw.values()):
        return      # non-JSON-portable static value: live jit only
    _PENDING[key] = {
        "fn": ref, "path": path,
        "args": [_sig_of(a) for a in args],
        "kwargs": {k: _sig_of(v) for k, v in kwargs.items()},
        "static_kwargs": static_kw,
        "ndev": _effective_ndev(backend),
    }
    _flush_pending()


def _flush_pending(force: bool = False) -> None:
    """Hand pending jobs to ONE low-priority worker subprocess; while a
    worker is running, later misses accumulate and flush when it exits
    (polled on the next miss) or at interpreter exit."""
    global _WORKER, _WORKER_JOBFILE
    if _WORKER is not None:
        if _WORKER.poll() is None and not force:
            return
        if _WORKER_JOBFILE:
            try:
                os.remove(_WORKER_JOBFILE)
            except OSError:
                pass
        _WORKER, _WORKER_JOBFILE = None, None
    if not _PENDING:
        return
    jobs = list(_PENDING.values())
    _PENDING.clear()
    os.makedirs(_DIR, exist_ok=True)
    fd, jobfile = tempfile.mkstemp(suffix=".json", prefix="qpn_aot_",
                                   dir=_DIR)
    with os.fdopen(fd, "w") as f:
        json.dump(jobs, f)
    try:
        # no preexec_fn: running Python between fork and exec in a
        # multithreaded parent (JAX is always multithreaded) is
        # documented-unsafe and can deadlock the child; the worker
        # re-nices ITSELF at startup instead
        _WORKER = subprocess.Popen(
            [sys.executable, "-m", "qpn_tpu.utils.aot_export_worker",
             jobfile],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env=cpu_only_env())
        _WORKER_JOBFILE = jobfile
        import atexit
        atexit.register(_drain_exports)
    except Exception:
        try:
            os.remove(jobfile)
        except OSError:
            pass
        _WORKER, _WORKER_JOBFILE = None, None


def _drain_exports(timeout: float = 120.0) -> None:
    """Flush remaining jobs and wait for the worker (tests; atexit)."""
    global _WORKER, _WORKER_JOBFILE
    while True:
        if _WORKER is not None:
            try:
                _WORKER.wait(timeout=timeout)
            except Exception:
                _WORKER.kill()
            if _WORKER_JOBFILE:
                try:
                    os.remove(_WORKER_JOBFILE)
                except OSError:
                    pass
            _WORKER, _WORKER_JOBFILE = None, None
        if not _PENDING:
            return
        _flush_pending(force=True)
