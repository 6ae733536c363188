"""Subprocess worker that exports jitted kernels to the AOT cache.

Run as:  python -m qpn_tpu.utils.aot_export_worker <jobfile.json>
     or: python -m qpn_tpu.utils.aot_export_worker --validate <dir> [ndev]

Why a subprocess: exporting (re-tracing) a kernel on a background THREAD
while the parent's main thread is also tracing corrupts the traced
program (measured: artifacts whose StableHLO differs wholesale from a
clean export and segfaults XLA:CPU at execution).

Why two-phase validation: a further measured failure mode is an artifact
that round-trips and EXECUTES fine in the process that exported it but
deterministically segfaults any OTHER process that deserializes and runs
it (op-identical MLIR; the fault is in the serialized-module execution
path).  So an artifact only becomes eligible for use when a process that
did NOT export it has deserialized and executed it — the export worker
spawns a fresh validator child per attempt; a crashing artifact kills
only that child, gets two attempts, then is deleted.  The parent process
(aot_cache) loads nothing without the ``.ok`` marker.

Job file: JSON list of
  {"fn": "module:attr", "path": "<final artifact path>",
   "args": [["float64", [1,8,8]], ...],
   "kwargs": {"max_iter": ["int64", []], ...},
   "static_kwargs": {"check_every": 25, ...}, "ndev": 1}
Dynamic argument VALUES are irrelevant for tracing; zeros are used.
``static_kwargs`` are the jit's static argnames — passed verbatim so
their values are BAKED into the exported program (the artifact is then
called with the dynamic inputs only).
"""

from __future__ import annotations

import glob
import importlib
import json
import os
import subprocess
import sys

import numpy as np


def _zero(spec):
    dtype, shape = spec
    return np.zeros(shape, dtype=np.dtype(dtype))


def export_job(job) -> None:
    from jax import export as jexport
    from . import aot_cache
    aot_cache._register_types()
    mod_name, attr = job["fn"].split(":")
    fn = getattr(importlib.import_module(mod_name), attr)
    args = [_zero(s) for s in job["args"]]
    kwargs = {k: _zero(s) for k, s in job["kwargs"].items()}
    kwargs.update(job.get("static_kwargs", {}))
    exp = jexport.export(fn)(*args, **kwargs)
    ser = exp.serialize()
    path = job["path"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(ser)
    os.replace(tmp, path)    # exists but NOT yet .ok — unusable


def validate_dir(d: str) -> None:
    """Deserialize + execute every unvalidated artifact; write ``.ok`` on
    success.  Runs in a process that exported nothing — if execution
    segfaults, only this process dies, and the ``.try`` counter ensures
    the artifact is culled after two fatal attempts."""
    import jax
    from jax import export as jexport
    from . import aot_cache
    aot_cache._register_types()
    aot_cache._warmup_runtime()
    for path in sorted(glob.glob(os.path.join(d, "*.stablehlo"))):
        if os.path.exists(path + ".ok"):
            continue
        trypath = path + ".try"
        tries = 0
        if os.path.exists(trypath):
            try:
                tries = int(open(trypath).read() or 0)
            except ValueError:
                tries = 0
        if tries >= 2:
            # two fatal attempts: cull and tombstone so the parent never
            # re-schedules an export for this signature
            with open(path + ".bad", "w") as f:
                f.write("crashed validation twice")
            for p in (path, trypath):
                try:
                    os.remove(p)
                except OSError:
                    pass
            continue
        with open(trypath, "w") as f:
            f.write(str(tries + 1))
        try:
            exp = jexport.deserialize(open(path, "rb").read())
            args = [np.zeros(a.shape, dtype=a.dtype) for a in exp.in_avals]
            # rebuild the (args, kwargs) pytree the module was exported with
            treedef = exp.in_tree
            leaves_args, leaves_kw = treedef.unflatten(args)
            out = exp.call(*leaves_args, **leaves_kw)
            jax.block_until_ready(out)
            with open(path + ".ok", "w") as f:
                f.write("ok")
            os.remove(trypath)
        except Exception:
            # non-fatal failure: leave the try marker, move on
            continue


def main() -> int:
    try:
        os.nice(10)     # low priority; parent must NOT preexec_fn this
    except OSError:
        pass
    if sys.argv[1] == "--validate":
        import jax
        jax.config.update("jax_platforms", "cpu")
        validate_dir(sys.argv[2])
        return 0

    with open(sys.argv[1]) as f:
        jobs = json.load(f)
    # match the parent's virtual device count BEFORE jax initializes
    ndev = max((int(j.get("ndev", 1)) for j in jobs), default=1)
    if ndev > 1:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={ndev}")
    import jax
    jax.config.update("jax_platforms", "cpu")   # CPU-only worker
    from . import aot_cache
    dirs = set()
    for job in jobs:
        try:
            export_job(job)
            dirs.add(os.path.dirname(job["path"]))
        except Exception:
            pass    # best-effort per job; other jobs still run
    # spawn fresh validator children (never this process — it exported);
    # each crash consumes one attempt, so bounded respawns make progress
    for d in dirs:
        for _ in range(len(jobs) + 2):
            r = subprocess.run(
                [sys.executable, "-m", "qpn_tpu.utils.aot_export_worker",
                 "--validate", d],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                env=aot_cache.cpu_only_env())
            pending = [p for p in glob.glob(os.path.join(d, "*.stablehlo"))
                       if not os.path.exists(p + ".ok")]
            if r.returncode == 0 and not pending:
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
