"""ctypes loader for the native host kernels (qpn_tpu/native/qpn_host.cpp).

Builds the shared library with g++ on first use (cached in the checkout's
``.native_build/``), and
falls back to pure-Python implementations when no compiler is available —
behavior is identical either way (tests assert it)."""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _source_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "native", "qpn_host.cpp")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    src = _source_path()
    if not os.path.exists(src):
        return None
    tag = hashlib.sha1(open(src, "rb").read()).hexdigest()[:12]
    from ..config import CHECKOUT_DIR
    cache = os.path.join(CHECKOUT_DIR, ".native_build")
    so = os.path.join(cache, f"libqpn_host_{tag}.so")
    if not os.path.exists(so):
        try:
            os.makedirs(cache, exist_ok=True)
            try:
                subprocess.run(
                    ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", src,
                     "-o", so + ".tmp"],
                    check=True, capture_output=True, timeout=120)
            except subprocess.CalledProcessError:
                # toolchains without libgomp: serial build, same semantics
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", src, "-o",
                     so + ".tmp"],
                    check=True, capture_output=True, timeout=120)
            os.replace(so + ".tmp", so)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
        lib.qpn_recipe_product.restype = ctypes.c_int64
        lib.qpn_recipe_product.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
        lib.qpn_quantize_hash.restype = None
        lib.qpn_quantize_hash.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64)]
        lib.qpn_dedupe_rows.restype = None
        lib.qpn_dedupe_rows.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
        lib.qpn_lemke_batch.restype = None
        lib.qpn_lemke_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_int64,
            ctypes.c_double, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _load() is not None


def recipe_product(label_sets: Sequence[Sequence[int]], cap: int) -> np.ndarray:
    """Cartesian product of per-row label choices as an (N, n_rows) int32
    array, truncated at ``cap`` (all_Ks, avi_solutions.jl:200-215)."""
    n_rows = len(label_sets)
    lists = [sorted(s) for s in label_sets]
    lib = _load()
    if lib is None or n_rows == 0:
        out = list(itertools.islice(itertools.product(*lists), cap))
        return np.asarray(out, dtype=np.int32).reshape(len(out), n_rows)
    flat = np.asarray([x for s in lists for x in s], dtype=np.int32)
    offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum([len(s) for s in lists], out=offsets[1:])
    out = np.empty((cap, n_rows), dtype=np.int32)
    count = lib.qpn_recipe_product(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_rows, cap,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out[:count].copy()


def quantize_hash(data: np.ndarray, digits: int = 5) -> np.ndarray:
    """Per-row FNV hash of 5-digit-rounded values (dedup currency)."""
    data = np.ascontiguousarray(data, dtype=np.float64)
    rows, cols = data.shape
    lib = _load()
    if lib is None:
        out = np.empty(rows, dtype=np.uint64)
        for r in range(rows):
            key = tuple(np.round(data[r], digits) + 0.0)
            out[r] = np.uint64(hash(key) & 0xFFFFFFFFFFFFFFFF)
        return out
    out = np.empty(rows, dtype=np.uint64)
    lib.qpn_quantize_hash(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rows, cols,
        digits, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


def lemke_batch(M, q, l, u, z0=None, tol=1e-9, piv_tol=1e-11,
                max_pivots=None, synth_scale=1e4):
    """Native batched box-AVI complementary pivoting (exact shapes).

    C++ port of the host oracle ops/lemke.py::solve_lemke_np — per-pivot
    work on these small exact-shape tableaus is microseconds, so the
    native loop beats any device dispatch for the geometry query LPs.
    Returns (z (B,n), status (B,), pivots (B,)) or None when the native
    library is unavailable (callers fall back to the JAX/numpy engines).
    """
    lib = _load()
    if lib is None:
        return None
    M = np.ascontiguousarray(M, dtype=np.float64)
    q = np.ascontiguousarray(q, dtype=np.float64)
    l = np.ascontiguousarray(l, dtype=np.float64)
    u = np.ascontiguousarray(u, dtype=np.float64)
    B, n = q.shape
    if max_pivots is None:
        max_pivots = max(400, 20 * n)
    z0p = ctypes.POINTER(ctypes.c_double)()
    if z0 is not None:
        z0 = np.ascontiguousarray(z0, dtype=np.float64)
        z0p = z0.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    z = np.empty((B, n), dtype=np.float64)
    status = np.empty(B, dtype=np.int32)
    pivots = np.empty(B, dtype=np.int64)
    lib.qpn_lemke_batch(
        M.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        l.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        z0p, B, n, tol, piv_tol, int(max_pivots), synth_scale,
        z.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pivots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return z, status, pivots


def dedupe_rows_mask(data: np.ndarray, digits: int = 5) -> np.ndarray:
    """keep[r] = True iff row r is the first occurrence of its quantized
    content (Set-of-Slice semantics, sets.jl:104-112)."""
    data = np.ascontiguousarray(data, dtype=np.float64)
    rows, cols = data.shape
    lib = _load()
    if lib is None or rows == 0:
        seen = {}
        keep = np.zeros(rows, dtype=bool)
        for r in range(rows):
            key = tuple(np.round(data[r], digits) + 0.0)
            if key not in seen:
                seen[key] = r
                keep[r] = True
        return keep
    out = np.empty(rows, dtype=np.uint8)
    lib.qpn_dedupe_rows(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rows, cols,
        digits, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)
