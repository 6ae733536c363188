"""Shared-matrix scenario-ensemble AVI solver — the GEMM route.

Scenario uncertainty ensembles (robust_avoid's T-step trajectory class,
reference `/root/reference/examples/deprecated/robust_avoid.jl:1-13`) share
ONE KKT matrix M across all S scenarios: the uncertainty enters only through
``q = N w + o`` and the separation offsets in the bounds
(`models/robust_avoid.py` `scenario_batch_gavis`).  The reference solves each
scenario's AVI one at a time in PATH; the batched Lemke tableau route
(`ops/lemke.py`) replicates M per lane, which at trajectory scale
(n = 608 at T=8, 1216 at T=16) is a (S, n, 3n+2) tableau that no longer fits
anywhere useful and whose rank-1 pivot updates are HBM-bandwidth bound.

This module instead treats the ensemble as ONE matrix problem:

1. **f32 extragradient pre-pass as (S, n) GEMMs** against the single shared
   M — Korpelevich EG converges on monotone AVIs (the stacked KKT systems are
   skew + PSD by construction) and every iteration is two
   ``(S, n) @ (n, n)`` matmuls: GEMM work with arithmetic intensity ~S,
   instead of the per-lane matvecs of the generic solver that stream S copies
   of M from HBM.  The pre-pass does not need a tight residual — only a
   stable active set — and runs as ONE device dispatch (``lax.while_loop``
   with residual / label-stability / plateau stopping on device).
2. **Fused δ=0 first policy round on device** (:func:`_round0_solve`): the
   EG labels become masks and bound values ON DEVICE, f32 batched LU +
   on-device f64 iterative refinement + f64 natural-residual audit + a
   per-lane label-fingerprint hash; the host fetches only the audited f64
   solutions (the fetch-minimising layout dates from a slow host link;
   ROADMAP C3).
3. **Host-driven proximal-δ policy rounds** (Josephy-Newton / LCP policy
   iteration, the nonsmooth-Newton core of the reference's PATH) for lanes
   round 0 leaves: classify from the natural map, solve the complementary
   basis (bucket-padded device chunks above the ~24-lane tail threshold,
   host LAPACK below), escalate a per-lane proximal-δ ladder on
   singularity or cycling (fingerprint-detected), with a stall detector
   handing chronic non-certifiers to the rungs.
4. **Structured-QP escalation, CHIP-bulk first**: round-0-singular lanes
   are the dual-degenerate class (the δ ladder certifies ~0 of them on
   hard seeds) and skip the ladder entirely; the chip rung solves their
   underlying QPs with mixed-precision batched ADMM ON DEVICE — f64
   iterates, f32 Cholesky factors inverted explicitly, split-f32
   matvecs, one while_loop dispatch per 128-lane chunk — then certifies
   through the tiny active-set host polish (:func:`_structured_polish`,
   (nd+a)² gelsy systems instead of n² basis machinery); the straggler
   resolution is deterministic (one path).  Remnants fall to the
   HOST-PINNED f64 ADMM + gelsy min-norm + generic rungs.  The 128-lane
   chunk cap and the host pinning were set for an earlier accelerator's
   faults; they are kept as they are until the GPU measurements of
   ROADMAP C4 decide.

The analytic FLOP ledger of the device phases is returned through
``stats`` (plus a per-phase wall-clock ``phase_t``) so the bench can
report achieved FLOP/s against the device's peak (utils/flops.PEAKS).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

_DEBUG = bool(os.environ.get("QPN_SHARED_DEBUG"))


def _dbg(msg):
    if _DEBUG:
        print(f"[shared_kkt +{time.perf_counter() - _T0:.2f}s] {msg}",
              flush=True)


_T0 = time.perf_counter()

from .avi import AVIResult
from ..utils.metrics import METRICS

_PREC = jax.lax.Precision.HIGHEST


# --------------------------------------------------------------------------
#  EG pre-pass: chunked fori of (S,n)@(n,n) GEMMs
# --------------------------------------------------------------------------

def _eg_steps(Mt, Q, L, U, Z, tau, steps, band, prec, method="eg"):
    """``steps`` first-order iterations + classification, shared by the
    debug chunk loop and the production while_loop (ONE body — the two
    paths must run the same numeric pipeline).

    ``method="eg"`` is Korpelevich extragradient (two GEMMs/iter,
    τ < 1/L); ``"popov"`` is Popov's optimistic method (ONE GEMM/iter at
    the leading point, τ < 1/(2L) for the monotone guarantee) — half the
    GEMM work per iteration when its iteration count doesn't grow to
    match."""

    if method == "popov":
        def body(_, carry):
            Z, Zb = carry
            F = jnp.dot(Zb, Mt, precision=prec) + Q
            Z1 = jnp.clip(Z - tau * F, L, U)
            Zb1 = jnp.clip(Z1 - tau * F, L, U)
            return Z1, Zb1
        Z, _ = jax.lax.fori_loop(0, steps, body, (Z, Z))
    else:
        def body(_, Z):
            F = jnp.dot(Z, Mt, precision=prec) + Q
            Zh = jnp.clip(Z - tau * F, L, U)
            Fh = jnp.dot(Zh, Mt, precision=prec) + Q
            return jnp.clip(Z - tau * Fh, L, U)
        Z = jax.lax.fori_loop(0, steps, body, Z)
    F = jnp.dot(Z, Mt, precision=prec) + Q
    r = jnp.max(jnp.abs(Z - jnp.clip(Z - F, L, U)), axis=1)
    s = Z - F
    at_l = jnp.isfinite(L) & (s <= L + band)
    at_u = jnp.isfinite(U) & (s >= U - band) & ~at_l
    return Z, r, at_l, at_u


@functools.partial(jax.jit, static_argnames=("steps", "prec", "method"))
def _eg_chunk(Mt, Q, L, U, Z, tau, steps, band, prev_l, prev_u,
              prec=_PREC, method="eg"):
    """One debug-mode chunk: advance ``steps`` EG iterations and report the
    residual / classification / label churn to the host (same pipeline as
    :func:`_eg_run`, one host round trip per chunk)."""
    Z, r, at_l, at_u = _eg_steps(Mt, Q, L, U, Z, tau, steps, band, prec,
                                 method)
    changed = jnp.sum((at_l != prev_l) | (at_u != prev_u))
    return Z, r, at_l, at_u, changed


@functools.partial(jax.jit,
                   static_argnames=("steps", "max_chunks", "prec", "method"))
def _eg_run(Mt, Q, L, U, Z0, tau, steps, max_chunks, band, switch,
            stable_tol, prec=_PREC, method="eg"):
    """The WHOLE extragradient pre-pass as one device dispatch: a
    ``lax.while_loop`` over ``steps``-iteration chunks with the stopping
    rule evaluated on device (residual < switch, or active-set labels
    stable across consecutive chunks — the same rule the host loop in
    :func:`_eg_chunk` mode applies).  One dispatch and one small fetch
    replace ``max_chunks`` host round trips."""

    def cond(state):
        _, _, _, _, k, stop, _ = state
        return (~stop) & (k < max_chunks)

    def body(state):
        Z, _, prev_l, prev_u, k, _, rh = state
        Z, r, at_l, at_u = _eg_steps(Mt, Q, L, U, Z, tau, steps, band,
                                     prec, method)
        changed = jnp.sum((at_l != prev_l) | (at_u != prev_u))
        rmax = jnp.max(r)
        # stopping rules, all on device: residual target; label stability
        # from the second chunk (stable_tol > 0 tolerates that many
        # flapping labels ensemble-wide — the policy rounds reclassify
        # those lanes from their own basis solutions); residual PLATEAU
        # (<10% improvement over three chunks: degenerate-heavy ensembles
        # never stabilize their labels, and burning the rest of a 60k-iter
        # budget measurably buys the terminal solve nothing)
        plateau = (k >= 3) & (rmax > 0.9 * rh[0])
        stop = ((rmax < switch)
                | ((k >= 1) & (changed <= stable_tol))
                | plateau)
        rh = jnp.stack([rh[1], rh[2], rmax])
        return Z, r, at_l, at_u, k + 1, stop, rh

    S = Q.shape[0]
    r0 = jnp.full((S,), jnp.inf, dtype=Z0.dtype)
    zeros = jnp.zeros(Q.shape, dtype=bool)
    rh0 = jnp.full((3,), jnp.inf, dtype=Z0.dtype)
    state = (Z0, r0, zeros, zeros, jnp.int32(0), jnp.bool_(False), rh0)
    Z, r, at_l, at_u, k, _, _ = jax.lax.while_loop(cond, body, state)
    return Z, r, at_l, at_u, k


@functools.partial(jax.jit, static_argnames=("inner_steps", "max_outer"))
def _prox_eg_rung(M32, M64, Q64, L64, U64, Z0, delta, tau, tol,
                  inner_steps, max_outer):
    """Batched proximal-point rung for degenerate lanes, entirely on
    device: ONE dispatch replaces the per-lane host rungs (lstsq SVDs,
    host ADMM/generic) that cost ~minutes on hard seeds.

    Outer loop (Rockafellar proximal point, convergent for monotone M):
    around the incumbent ``z_ref``, solve the STRONGLY monotone prox
    subproblem ``(M + δI) d + (M z_ref + q) ⟂ (l − z_ref) ≤ d ≤
    (u − z_ref)`` in the CORRECTION variable d with a fixed-step f32
    extragradient inner loop (linear rate — δ-strong monotonicity), then
    recenter ``z_ref += d``.  Solving for the correction is iterative
    refinement for VIs: the f32 inner's absolute error scales with ‖d‖,
    which shrinks as z_ref converges, so the f64-accumulated z_ref can
    certify at 1e-8 even though every GEMM is f32.  The outer residual is
    audited on device in f64 (the same natural-map gate as everywhere
    else); the host fetches only (z, rn)."""
    f32 = M32.dtype
    Mt32, Mt64 = M32.T, M64.T
    Z0 = jnp.clip(Z0, L64, U64)          # d = 0 must be feasible

    def cond(state):
        _, rn, k, stop = state
        return (~stop) & (k < max_outer)

    def body(state):
        zref, _, k, _ = state
        r64 = jnp.dot(zref, Mt64, precision=_PREC) + Q64
        r32 = r64.astype(f32)
        lm = (L64 - zref).astype(f32)
        um = (U64 - zref).astype(f32)

        def inner(_, d):
            Fd = jnp.dot(d, Mt32, precision=_PREC) + delta * d + r32
            dh = jnp.clip(d - tau * Fd, lm, um)
            Fh = jnp.dot(dh, Mt32, precision=_PREC) + delta * dh + r32
            return jnp.clip(d - tau * Fh, lm, um)

        d = jax.lax.fori_loop(0, inner_steps, inner,
                              jnp.zeros_like(r32))
        zref = zref + d.astype(jnp.float64)
        F = jnp.dot(zref, Mt64, precision=_PREC) + Q64
        rn = jnp.max(jnp.abs(zref - jnp.clip(zref - F, L64, U64)), axis=1)
        return zref, rn, k + 1, jnp.max(rn) <= tol

    S = Q64.shape[0]
    state = (Z0, jnp.full((S,), jnp.inf), jnp.int32(0), jnp.bool_(False))
    z, rn, k, _ = jax.lax.while_loop(cond, body, state)
    return z, rn, k


@functools.partial(jax.jit, static_argnames=("refines",))
def _round0_solve(M32, M64, at_l, at_u, Q64, L64, U64, refines):
    """Fused δ=0 first policy round, entirely on device: the EG labels
    (already device-resident from :func:`_eg_run`) become free/bound masks
    and bound values ON DEVICE, so the host ships NOTHING for the round
    that solves ~all lanes (no ~25 MB upload of f64 masks/vectors per
    full-width round).  Same math as
    :func:`_basis_solve_refine` at δ = 0; returns (z, F, rn)."""
    n = M32.shape[0]
    free = ~(at_l | at_u)
    l_fin = jnp.where(jnp.isfinite(L64), L64, 0.0)
    u_fin = jnp.where(jnp.isfinite(U64), U64, 0.0)
    bval = jnp.where(at_l, l_fin, u_fin)
    eye32 = jnp.eye(n, dtype=M32.dtype)
    A = jnp.where(free[:, :, None], M32[None], eye32)
    rhs0 = jnp.where(free, -Q64, bval).astype(M32.dtype)
    lu, piv = jax.vmap(jax.scipy.linalg.lu_factor)(A)
    z = jax.vmap(jax.scipy.linalg.lu_solve)((lu, piv),
                                            rhs0).astype(jnp.float64)
    Mt64 = M64.T

    def refine(_, z):
        Fp = jnp.dot(z, Mt64, precision=_PREC) + Q64
        r = jnp.where(free, -Fp, bval - z)
        dz = jax.vmap(jax.scipy.linalg.lu_solve)(
            (lu, piv), r.astype(M32.dtype)).astype(jnp.float64)
        good = jnp.isfinite(dz).all(axis=1)
        return jnp.where(good[:, None], z + dz, z)

    z = jax.lax.fori_loop(0, refines, refine, z)
    F = jnp.dot(z, Mt64, precision=_PREC) + Q64
    finite = jnp.isfinite(z).all(axis=1)
    rn = jnp.max(jnp.abs(z - jnp.clip(z - F, L64, U64)), axis=1)
    rn = jnp.where(finite, rn, jnp.inf)
    # per-lane label fingerprint, hashed ON DEVICE so the host fetches one
    # int32 per lane instead of the (C, n) masks — F itself is not
    # returned either: the policy loop re-derives it on host for the few
    # lanes that advance (a 66-lane GEMM) instead of fetching 5 MB
    return z, rn, _label_hash_dev(at_l, at_u)


@functools.partial(jax.jit, static_argnames=("refines",))
def _basis_solve_refine(M32, M64, free, bval, q64, l64, u64, delta, zref,
                        refines):
    """Per-lane proximal complementary-basis solve: f32 LU + on-device f64
    iterative refinement.

    Solves each lane's complementary-basis system for the PROXIMAL problem
    ``(M + δI) z + (q − δ z_ref) ⟂ l ≤ z ≤ u`` — free rows from M + δ·I,
    bound rows identity.  δ is per-lane: 0 for well-conditioned lanes (the
    raw Newton/policy step), positive for lanes whose raw basis factorization
    is singular (degenerate active sets) — M + δI is strongly monotone, so
    EVERY principal basis matrix is nonsingular, and shrinking δ with
    ``z_ref`` re-centered at the incumbent is the proximal-point iteration
    (converges for monotone M; at the fixed point the prox solution equals
    the true solution for any δ).

    The (C, n, n) basis matrices are materialized ON DEVICE from the one
    shared (n, n) matrix, so the host ships only masks and vectors, never
    O(C·n²) tensors.  Iterative refinement runs entirely on device:
    residuals are f64 GEMMs against the ORIGINAL f64 data (a few
    (C,n)@(n,n) passes, negligible next to the factorization),
    corrections reuse the f32 LU factors; non-finite
    corrections are skipped per-lane so one singular basis can't poison its
    chunk.  Returns the refined f64 solution, the ORIGINAL natural map value
    F = Mz+q (the next policy round classifies from it), and the f64
    natural residual of the ORIGINAL problem per lane.
    """
    n = M32.shape[0]
    eye32 = jnp.eye(n, dtype=M32.dtype)
    d32 = delta.astype(M32.dtype)
    Ad = M32[None] + d32[:, None, None] * eye32
    A = jnp.where(free[:, :, None], Ad, eye32)
    q_eff = q64 - delta[:, None] * zref
    rhs0 = jnp.where(free, -q_eff, bval).astype(M32.dtype)
    lu, piv = jax.vmap(jax.scipy.linalg.lu_factor)(A)
    z32 = jax.vmap(jax.scipy.linalg.lu_solve)((lu, piv), rhs0)
    z = z32.astype(jnp.float64)
    Mt64 = M64.T

    def refine(_, z):
        Fp = (jnp.dot(z, Mt64, precision=_PREC) + q_eff
              + delta[:, None] * z)
        r = jnp.where(free, -Fp, bval - z)
        dz = jax.vmap(jax.scipy.linalg.lu_solve)(
            (lu, piv), r.astype(M32.dtype)).astype(jnp.float64)
        good = jnp.isfinite(dz).all(axis=1)
        return jnp.where(good[:, None], z + dz, z)

    z = jax.lax.fori_loop(0, refines, refine, z)
    # f64 natural-residual audits on device — of the ORIGINAL problem (the
    # acceptance gate) and of the PROX subproblem (the inner policy
    # iteration's own convergence signal); non-finite z maps to +inf
    F = jnp.dot(z, Mt64, precision=_PREC) + q64
    finite = jnp.isfinite(z).all(axis=1)
    rn = jnp.max(jnp.abs(z - jnp.clip(z - F, l64, u64)), axis=1)
    rn = jnp.where(finite, rn, jnp.inf)
    Fp = F + delta[:, None] * (z - zref)
    rp = jnp.max(jnp.abs(z - jnp.clip(z - Fp, l64, u64)), axis=1)
    rp = jnp.where(finite, rp, jnp.inf)
    return z, F, rn, rp


def _host_basis_solve(M0, free, bval, qs, ls, us, delta, zref):
    """Host f64 LAPACK version of the proximal basis solve, for the
    straggler TAIL (a handful of degenerate lanes cycling through the δ
    ladder): each device dispatch at these lane counts is latency-bound,
    and exact f64
    factorization needs no refinement passes at all.  Same contract as
    :func:`_basis_solve_refine`: (z, F, rn, rp)."""
    n = M0.shape[0]
    eye = np.eye(n)
    A = np.where(free[:, :, None],
                 M0[None] + delta[:, None, None] * eye[None], eye[None])
    rhs = np.where(free, -(qs - delta[:, None] * zref), bval)
    C = free.shape[0]
    z = np.empty((C, n))
    for i in range(C):
        try:
            z[i] = np.linalg.solve(A[i], rhs[i])
        except np.linalg.LinAlgError:
            # exactly singular basis: report non-finite so the caller's δ
            # ladder escalates (an SVD min-norm solve here costs ~seconds
            # per lane at n≈600 and the post-loop lstsq rung already covers
            # the consistent-singular case once, not once per round)
            z[i] = np.nan
    with np.errstate(invalid="ignore", over="ignore"):
        F = z @ M0.T + qs
        fin = np.isfinite(z).all(axis=1) & np.isfinite(F).all(axis=1)
        rn = np.where(
            fin, np.abs(z - np.clip(z - F, ls, us)).max(axis=1), np.inf)
        Fp = F + delta[:, None] * (z - zref)
        rp = np.where(
            fin, np.abs(z - np.clip(z - Fp, ls, us)).max(axis=1), np.inf)
    return z, F, rn, rp


def _classify(Z, F, l, u, band):
    """Active set from the natural map s = z − F (see module docstring)."""
    s = Z - F
    at_l = np.isfinite(l) & (s <= l + band)
    at_u = np.isfinite(u) & (s >= u - band) & ~at_l
    return at_l, at_u


def _label_hash_dev(at_l, at_u):
    """Device-side per-lane label fingerprint (int32 wrap-around linear
    hash).  :func:`_label_hash` is its bit-equal host mirror — both feed
    the SAME cycling-fingerprint stream (parity-tested)."""
    n = at_l.shape[-1]
    w = (jax.lax.iota(jnp.int32, n) * np.int32(-1640531527)) ^ np.int32(
        0x5BD1E995)
    return (jnp.dot(at_l.astype(jnp.int32), w)
            + jnp.dot(at_u.astype(jnp.int32), w * np.int32(40503)))


def _wrap32(x):
    """Wrap int64 values to int32 two's complement (mod 2³²)."""
    return (((np.asarray(x, dtype=np.int64) + 2**31) % 2**32)
            - 2**31).astype(np.int32)


def _hash_weights(n):
    """Host copy of the per-row hash weights :func:`_round0_solve` builds
    on device (int32 wrap-around arithmetic mirrored via int64+mod), so a
    classification hashed on device and the SAME classification hashed on
    host produce the SAME fingerprint — cycling detection sees one stream."""
    w64 = np.arange(n, dtype=np.int64) * np.int64(-1640531527)
    return _wrap32(w64) ^ np.int32(0x5BD1E995)


def _label_hash(at_l, at_u, w):
    """Batched label fingerprint, bit-equal to the device hash: int32
    dot-accumulation wraps mod 2³², which an exact int64 sum wrapped once
    at the end reproduces."""
    w = w.astype(np.int64)
    h = (at_l.astype(np.int64) @ w
         + at_u.astype(np.int64) @ _wrap32(w * 40503).astype(np.int64))
    return _wrap32(h)


def _fetch(a):
    """Host copy of a possibly process-spanning device array: plain
    np.asarray in one process, a tiled process_allgather when the mesh
    spans jax.distributed processes (fetching non-addressable shards
    directly is illegal) — the same contract as parallel.sharded's
    _fetch_global, local here to keep the route import-light."""
    if (isinstance(a, jax.Array) and jax.process_count() > 1
            and not a.is_fully_addressable):
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(a, tiled=True))
    return np.asarray(a)


def _nat_resid_shared(M0, q, l, u, Z):
    F = Z @ M0.T + q
    with np.errstate(invalid="ignore"):
        proj = np.clip(Z - F, l, u)
    return np.abs(Z - proj).max(axis=1), F


def _structured_polish(M0, nd, m, q, l64, u64, x0, tol, scale):
    """Active-set KKT polish in the QP's OWN coordinates (lanes, host f64).

    The shared-KKT lanes are QPs with ``nd`` primal variables and ``m``
    rows (``z = [x; λ; s]``, models/robust_avoid.py scenario_batch_gavis);
    once a solver has located ``x`` to ~1e-5 the active set of the s-block
    is known, and the stationarity system on that active set is only
    ``(nd + a)²`` — tiny next to the n×n basis machinery (n = nd + 2m).
    Solves it min-norm (gelsy: degenerate duals give consistent singular
    systems), drops wrong-signed multipliers for up to 3 sign-refinement
    rounds (same discipline as algorithm.verify_solutions_batch), and
    audits the FULL reconstructed z against the original AVI natural
    residual — acceptance is the f64 audit, never the polish itself.

    Returns (z, rn) with rn = +inf where no band/refinement certified.
    """
    import scipy.linalg as sla
    Q = M0[:nd, :nd]
    A = M0[nd:nd + m, :nd]
    C = x0.shape[0]
    n = M0.shape[0]
    z_out = np.zeros((C, n))
    rn_out = np.full(C, np.inf)
    l2 = l64[:, nd + m:]
    u2 = u64[:, nd + m:]
    fin_l, fin_u = np.isfinite(l2), np.isfinite(u2)
    eqr = fin_l & fin_u & (u2 - l2 < 1e-12)
    stol = max(tol, 1e-9 * scale)
    for i in range(C):
        c = q[i, :nd]
        off = q[i, nd:nd + m]
        s0 = A @ x0[i] + off
        best_rn, best_z = np.inf, None
        for band in (1e-5 * scale, 1e-4 * scale, 1e-3 * scale):
            act_l = fin_l[i] & (s0 <= l2[i] + band)
            act_u = fin_u[i] & (s0 >= u2[i] - band) & ~act_l
            for _ in range(3):
                act = act_l | act_u | eqr[i]
                idx = np.flatnonzero(act)
                a = idx.size
                E = A[idx]
                b = np.where(act_l[idx] | eqr[i][idx], l2[i][idx],
                             u2[i][idx])
                K = np.zeros((nd + a, nd + a))
                K[:nd, :nd] = Q
                K[:nd, nd:] = -E.T
                K[nd:, :nd] = E
                rhs = np.concatenate([-c, b - off[idx]])
                sol = sla.lstsq(K, rhs, lapack_driver="gelsy",
                                check_finite=False)[0]
                xh, mu = sol[:nd], sol[nd:]
                lam = np.zeros(m)
                lam[idx] = mu
                bad = ((act_l & ~eqr[i] & (lam < -stol))
                       | (act_u & ~eqr[i] & (lam > stol)))
                if not bad.any():
                    break
                act_l, act_u = act_l & ~bad, act_u & ~bad
            sh = A @ xh + off
            z = np.concatenate([xh, lam, sh])
            F = M0 @ z + q[i]
            rn = np.abs(z - np.clip(z - F, l64[i], u64[i])).max()
            if np.isfinite(rn) and rn < best_rn:
                best_rn, best_z = rn, z
            if best_rn <= tol:
                break
        if best_z is not None:
            z_out[i], rn_out[i] = best_z, best_rn
    return z_out, rn_out


@functools.partial(jax.jit, static_argnames=("Cb",))
def _admm_shared_call(Q, A, c, lo, hi, x0, y0, eps, max_iter, Cb):
    """Device-side broadcast of the shared QP blocks into the batched
    mixed-precision ADMM (see :func:`_chip_admm_rung`).  ``eps`` is traced,
    so the whole eps ladder shares one compiled kernel per Cb; (x0, y0)
    warm-start from the EG iterate."""
    from . import batch_qp
    m = A.shape[0]
    QB = jnp.broadcast_to(Q[None], (Cb,) + Q.shape)
    AB = jnp.broadcast_to(A[None], (Cb,) + A.shape)
    mask = jnp.ones((Cb, m), dtype=bool)
    # polish=False: the rung certifies through _structured_polish on host
    # (measured identical certification), and the in-kernel polish's
    # (nd+m)² batched QR runs for EVERY lane under vmap — it dominated the
    # whole call at trajectory shapes (T=16)
    return batch_qp.solve_qp_batch(QB, c, AB, lo, hi, mask, eps=eps,
                                   max_iter=max_iter, mixed=True,
                                   x_init=x0, y_init=y0, polish=False)


def _chip_admm_rung(M0, q, l64, u64, todo, structure, tol, scale,
                    stats_iters):
    """Structured-QP rung with the BULK ON THE CHIP: mixed-precision
    batched ADMM on the underlying QPs (one while_loop dispatch — f64
    iterates with f32 Cholesky factors + f64 refinement; pure-f32 ADMM
    measurably stalls on this degenerate class at 0.07 constraint
    violation after 4000 iters; whether native f64 ADMM does better on the
    GPU is ROADMAP C2), then the tiny active-set host polish
    (:func:`_structured_polish`).  Replaces the host-pinned f64 ADMM rung
    (~1.7 s/lane on the host) with one device dispatch + milliseconds of
    host gelsy.

    Returns (z, ok, device_flops) for the ``todo`` lanes; ok lanes
    certified at the f64 natural-residual audit, device_flops the nominal
    flop count of the on-device ADMM work (for the MFU ledger)."""
    from . import batch_qp
    nd, m = structure["nd"], structure["m"]
    C = todo.size
    Q = M0[:nd, :nd]
    A = M0[nd:nd + m, :nd]
    Qd, Ad = jnp.asarray(Q), jnp.asarray(A)
    z_out = np.zeros((C, M0.shape[0]))
    rn_out = np.full(C, np.inf)
    pend = np.arange(C)
    dev_fl = 0.0
    # eps ladder, coarse first: most lanes' active sets identify at 1e-4
    # (half the iterations of 1e-6); polish failures retry tighter.  eps
    # and max_iter are traced inputs, so every rung shares one compiled
    # kernel per Cb.  (A 2000-iter cap on the first pass was measured
    # WORSE at T=16 — many lanes of that class genuinely need >2000
    # iterations, and capping them only moved the work into extra
    # full-budget retry chunks.)
    for eps, mi in ((1e-4, 4000), (1e-6, 4000)):
        if pend.size == 0:
            break
        x = np.empty((pend.size, nd))
        # chunk at 128 lanes: a cap set for an earlier accelerator's
        # kernel faults at larger batches, kept until the GPU measurement
        # of ROADMAP C4; the per-iteration cost is compute-bound so
        # chunking costs only the per-dispatch latency
        CHUNK = 128
        for ofs in range(0, pend.size, CHUNK):
            sel = slice(ofs, min(ofs + CHUNK, pend.size))
            csz = sel.stop - sel.start
            idx = todo[pend[sel]]
            c = q[idx, :nd]
            off = q[idx, nd:nd + m]
            l2 = l64[idx, nd + m:nd + 2 * m]
            u2 = u64[idx, nd + m:nd + 2 * m]
            # bucket-pad lanes (lane-0 copies) so counts reuse shapes
            Cb = next(b for b in (8, 16, 32, 64, 128) if b >= csz)
            pad = Cb - csz

            def _p(a):
                return (np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
                        if pad else a)
            # NO warm start: seeding the ADMM from the EG iterate was
            # measured WORSE (925 vs 775 median iterations on the hard
            # class — the inconsistent (z, y) start fights the ρ
            # adaptation), so the rung runs cold
            x0 = np.zeros((Cb, nd))
            y0 = np.zeros((Cb, m))
            # Q and A are SHARED across lanes: broadcast ON DEVICE (a
            # jit-level broadcast_to) instead of shipping Cb host replicas
            # (~35 MB at Cb=128)
            sol = jax.device_get(_admm_shared_call(
                Qd, Ad, jnp.asarray(_p(c)),
                jnp.asarray(_p(l2 - off)), jnp.asarray(_p(u2 - off)),
                jnp.asarray(x0), jnp.asarray(y0), eps, mi, Cb))
            x[sel] = np.asarray(sol.x, dtype=np.float64)[:csz]
            it_l = np.asarray(sol.iters, dtype=np.int64)
            stats_iters[idx] += it_l[:csz]
            # nominal on-device flops: per iteration two (m,nd) matvecs +
            # the Kinv apply/refinements (~5 nd² GEMVs), per 25-iter epoch
            # one f32 Cholesky + explicit inverse (4/3 nd³)
            its = float(it_l.sum())
            dev_fl += (its * (4.0 * m * nd + 10.0 * nd * nd)
                       + its / 25.0 * (4.0 / 3.0) * nd ** 3)
        ti = todo[pend]
        z, rn = _structured_polish(M0, nd, m, q[ti], l64[ti], u64[ti],
                                   x, tol, scale)
        better = rn < rn_out[pend]
        z_out[pend[better]] = z[better]
        rn_out[pend[better]] = rn[better]
        pend = pend[~(np.isfinite(rn) & (rn <= tol))]
    ok = np.isfinite(rn_out) & (rn_out <= tol)
    return z_out, ok, dev_fl


def _escalation_device():
    """Device the generic escalation rung runs on: ALWAYS a host CPU device
    when the default backend is an accelerator.

    The generic hybrid-Newton kernel at trajectory scale (n≥600) faulted an
    earlier accelerator, so its kernels are placed on the local CPU devices:
    a straggler lane runs at host speed.  The placement is kept until the
    GPU measurement of ROADMAP C4 decides.  (jax CPU devices coexist with
    the accelerator in every process; same placement policy as
    config.small_dispatch_device.)  Returns None when already on CPU.
    """
    if jax.default_backend() == "cpu":
        return None
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return None


def _escalate_generic(M0, q, l, u, z0, tol):
    """Generic adaptive escalation for shared-route straggler lanes, pinned
    off-accelerator (see :func:`_escalation_device`).  Returns
    (z, converged_mask, per-lane iters)."""
    import contextlib
    from .avi import solve_avi_batch_adaptive
    B, n = q.shape
    Mrep = np.repeat(M0[None], B, axis=0)
    dev = _escalation_device()
    ctx = jax.default_device(dev) if dev is not None else (
        contextlib.nullcontext())
    with ctx:
        res = solve_avi_batch_adaptive(
            Mrep, q, l, u, z0, np.ones((B, n), dtype=bool), tol=tol)
    zg = np.asarray(res.z)
    rg = np.asarray(res.resid)
    ok = np.asarray(res.converged) & np.isfinite(rg)
    return zg, ok, np.asarray(res.iters, dtype=np.int64)


def solve_kkt_avi_shared(M, q, l, u, var_mask, tol: float = 1e-8, *,
                         eg_budget: int = 20000, eg_chunk: int = 2000,
                         eg_stable_tol: Optional[int] = None,
                         eg_prec=jax.lax.Precision.HIGHEST,
                         eg_method: str = "eg",
                         enable_prox_eg: bool = False,
                         lane_chunk: int = 1024, newton_rounds: int = 12,
                         refine_passes: int = 1,
                         structure: Optional[dict] = None,
                         mesh=None,
                         stats: Optional[dict] = None) -> AVIResult:
    """Solve a shared-matrix AVI ensemble ``M z + q ⟂ l ≤ z ≤ u``.

    ``M`` may be (n, n) or (S, n, n) with identical lanes (caller asserts);
    q, l, u are (S, n).  Requires an all-true ``var_mask`` (scenario
    ensembles are emitted unpadded); callers with padding use the generic
    route.  Returns an audited :class:`AVIResult`; ``stats`` (if given) is
    filled with the device FLOP ledger and phase iteration counts.

    ``eg_prec`` defaults to ``Precision.HIGHEST``.  ``HIGH`` runs the EG
    GEMMs in TF32 on the GPU: on the H100 at S=1024, T=8 it stopped the
    pre-pass earlier (8000 vs 12000 iterations) but left 14 lanes to the
    host solves that HIGHEST certifies on the device (PERF.md).  The CPU
    ignores the setting.
    """
    q = np.asarray(q, dtype=np.float64)
    S, n = q.shape
    M0 = np.asarray(M, dtype=np.float64)
    if M0.ndim == 3:
        M0 = M0[0]
    l64 = np.asarray(l, dtype=np.float64)
    u64 = np.asarray(u, dtype=np.float64)
    if var_mask is not None and not np.asarray(var_mask).all():
        raise ValueError("shared route requires an unpadded ensemble")

    # EG step from the true spectral norm (power iteration on M'M — ~30 n²
    # host flops, negligible): the √(‖M‖₁‖M‖∞) bound overestimates σ_max on
    # these KKT matrices by 2-3×, which costs the same factor in iterations
    v = np.ones(n) / np.sqrt(n)
    for _ in range(30):
        w = M0.T @ (M0 @ v)
        nw = np.linalg.norm(w)
        if nw == 0.0:
            break
        v = w / nw
    Lip = float(np.sqrt(max(np.linalg.norm(M0.T @ (M0 @ v)), 1e-24)))
    # EG tolerates τ < 1/L; Popov's single-GEMM iteration needs τ < 1/(2L)
    tau = np.float32((0.45 if eg_method == "popov" else 0.9)
                     / max(Lip, 1e-12))

    if mesh is not None and S % mesh.devices.size != 0:
        _dbg(f"mesh ignored: S={S} not divisible by {mesh.devices.size}")
        mesh = None
    if mesh is not None:
        # scenario-data-parallel over the mesh: lane math is row-local
        # (per-lane GEMV rows, per-lane LU), so S shards across devices
        # with M replicated and ZERO collectives in the compute path —
        # results are lane-identical to the single-device route
        from ..parallel.mesh import replicated, scenario_sharding
        _shS, _shR = scenario_sharding(mesh), replicated(mesh)
        _putS = functools.partial(jax.device_put, device=_shS)
        _putR = functools.partial(jax.device_put, device=_shR)
    else:
        _putS = _putR = jnp.asarray

    f32 = np.float32
    Mt32 = _putR(np.asarray(M0.T, dtype=f32))
    M32_d = _putR(np.asarray(M0, dtype=f32))
    M64_d = _putR(M0)
    # the δ-ladder rounds and the escalation rungs are process-LOCAL
    # replicated host work; under a process-spanning mesh they must not
    # consume non-addressable arrays, so they get local copies of M
    if mesh is not None and jax.process_count() > 1:
        M32_l = jnp.asarray(np.asarray(M0, dtype=f32))
        M64_l = jnp.asarray(M0)
    else:
        M32_l, M64_l = M32_d, M64_d
    Q32 = _putS(np.asarray(q, dtype=f32))
    L32 = _putS(np.asarray(l64, dtype=f32))
    U32 = _putS(np.asarray(u64, dtype=f32))
    Z = jnp.clip(_putS(np.zeros((S, n), dtype=f32)), L32, U32)

    scale = 1.0 + float(np.abs(q).max())
    switch = max(tol, 1e-5 * scale)
    band32 = np.float32(1e-4 * scale)
    if eg_stable_tol is None:
        # at trajectory scale a handful of flapping labels ensemble-wide
        # shouldn't hold the whole EG pre-pass hostage (the policy rounds
        # reclassify those lanes from their own basis solutions); small
        # ensembles keep the exact-stability rule
        eg_stable_tol = max(0, S // 128)
    eg_iters = 0
    phase_t = {}
    _t = time.perf_counter()
    # f64 problem data device-resident for the fused first policy round —
    # device_put is async, so these ~15 MB overlap the EG GEMMs instead of
    # serializing a per-round upload behind them
    Q64_d = _putS(q)
    L64_d = _putS(l64)
    U64_d = _putS(u64)

    if _DEBUG:
        # chunked host loop: one round trip per chunk, but per-chunk
        # residual/stability prints for forensics
        prev_l = jnp.zeros((S, n), dtype=bool)
        prev_u = jnp.zeros((S, n), dtype=bool)
        first = True
        rhist: list = []
        while eg_iters < eg_budget:
            Z, r, prev_l, prev_u, changed = _eg_chunk(
                Mt32, Q32, L32, U32, Z, tau, eg_chunk, band32,
                prev_l, prev_u, prec=eg_prec, method=eg_method)
            eg_iters += eg_chunk
            r_host = np.asarray(r)
            rmax = float(r_host.max())
            _dbg(f"eg {eg_iters} iters, max resid {rmax:.3e} "
                 f"(switch {switch:.1e}, labels changed {int(changed)})")
            if rmax < switch:
                break
            # active-set stability is the real stopping criterion: the
            # terminal solve only needs the right classification
            if not first and int(changed) <= eg_stable_tol:
                break
            # residual plateau (mirror of _eg_run's rule)
            if len(rhist) >= 3 and rmax > 0.9 * rhist[-3]:
                break
            rhist.append(rmax)
            first = False
        at_l_d, at_u_d = prev_l, prev_u
    else:
        # production path: the whole stopping loop runs on device as ONE
        # dispatch (lax.while_loop over chunks) — same stopping rule,
        # max_chunks·(round-trip latency) less wall time
        max_chunks = max(1, eg_budget // eg_chunk)
        Z, _, at_l_d, at_u_d, k = _eg_run(
            Mt32, Q32, L32, U32, Z, tau, eg_chunk, max_chunks, band32,
            np.float32(switch), np.int32(eg_stable_tol), prec=eg_prec,
            method=eg_method)
        eg_iters = int(k) * eg_chunk

    phase_t["eg"] = time.perf_counter() - _t
    _t = time.perf_counter()
    Z64 = _fetch(Z).astype(np.float64)
    phase_t["eg_fetch"] = time.perf_counter() - _t
    _t = time.perf_counter()

    z_out = Z64.copy()
    done = np.zeros(S, dtype=bool)
    iters_out = np.full(S, eg_iters, dtype=np.int64)
    lu_factored = 0
    refine_gemms = 0
    host_solves = 0
    REFINES = refine_passes

    # finite stand-ins for ±inf bounds in bval (never selected: an infinite
    # bound can't be active)
    l_fin = np.where(np.isfinite(l64), l64, 0.0)
    u_fin = np.where(np.isfinite(u64), u64, 0.0)

    # Active-set Newton fixpoint (LCP policy iteration / Josephy-Newton —
    # the nonsmooth-Newton core of PATH), wrapped in a proximal-point outer
    # loop for the degenerate lanes these LP-KKT ensembles produce (M is
    # skew and rank-deficient — measured rank 512/608 at T=8 — so raw
    # complementary bases are frequently singular):
    #
    #   fast path (δ=0): classify → basis solve → adopt → reclassify.  The
    #     EG start classifies with a loose band (its iterate is only
    #     ~switch-accurate); basis solutions classify with a ~zero band
    #     (their free rows satisfy F=0 exactly, so the sign split IS the
    #     policy-iteration update).
    #   degenerate ladder (δ>0): on a singular factorization or a cycling
    #     classification, the lane gets a proximal δ — M+δI is strongly
    #     monotone, so every basis is nonsingular and the INNER policy
    #     iteration on the prox subproblem (δ, z_ref fixed) is well-posed;
    #     once the prox subproblem's own natural residual rp meets tol, the
    #     lane RECENTERS z_ref at the prox solution (the proximal-point
    #     outer step, convergent for monotone F) and shrinks δ.  At the
    #     fixed point the prox solution solves the original problem exactly,
    #     which the original-residual audit rn certifies.
    # Fc is filled lazily: round-0 advances write it from their own basis
    # solutions, singular round-0 lanes get a small host GEMM afterwards —
    # the full-ensemble natural-map GEMM the round-3 driver did here served
    # almost no lane that actually consumed it
    Zc, Fc = Z64.copy(), np.zeros_like(Z64)
    band_lane = np.full(S, 1e-4 * scale)
    delta_lane = np.zeros(S)
    zref = Z64.copy()
    delta0 = 1e-5 * max(Lip, 1.0)       # f32-visible relative to ‖M‖
    delta_min = 1e-6 * max(Lip, 1.0)
    seen_cls: list[set] = [set() for _ in range(S)]
    active = np.ones(S, dtype=bool)     # lanes still in the Newton loop
    rung = np.zeros(S, dtype=np.int64)
    # escalation ladder per lane: wide-band retry first (a boundary row
    # misread from the ~switch-accurate EG point is the common failure, and
    # reclassifying the SAME point with a wider band fixes it — the round-3
    # two-band behavior), then the proximal δ ladder
    _LADDER = ((1e-2, 0.0), (1e-4, 1.0), (1e-4, 30.0), (1e-3, 900.0))

    def _bump_rung(lane):
        rung[lane] += 1
        if rung[lane] > len(_LADDER):
            active[lane] = False
            return
        band_rel, dmul = _LADDER[rung[lane] - 1]
        band_lane[lane] = band_rel * scale
        delta_lane[lane] = dmul * delta0
        zref[lane] = Zc[lane]
        seen_cls[lane].clear()

    hash_w = _hash_weights(n)
    progress_rd = [0]    # last round with real progress (stall detector)

    def _absorb(sel, zc, Fchunk, rn, rp, rd):
        """Per-chunk policy-round bookkeeping: accept audited lanes, adopt
        finite solutions as the next classification point, recenter the
        prox reference where the subproblem converged, escalate singular
        factorizations."""
        ok = np.isfinite(rn) & (rn <= tol)
        z_out[sel[ok]] = zc[ok]
        done[sel[ok]] = True
        fin = np.isfinite(rn)
        # inner policy step: adopt every finite basis solution as the next
        # classification point (no descent requirement — Newton on the
        # natural map is not monotone; cycling is caught by the
        # fingerprints) and classify it with a ~zero band: its sign split
        # is exact
        adv = ~ok & fin
        Zc[sel[adv]] = zc[adv]
        Fc[sel[adv]] = Fchunk[adv]
        band_lane[sel[adv]] = 1e-9 * scale
        # outer prox step: the prox subproblem is solved (rp ≤ tol) but
        # the original residual isn't — recenter z_ref and shrink δ
        rec = adv & (rp <= max(tol, 1e-10 * scale))
        for lane_i in sel[rec]:
            zref[lane_i] = Zc[lane_i]
            seen_cls[lane_i].clear()
        delta_lane[sel[rec]] = np.maximum(
            delta_lane[sel[rec]] * 0.3, delta_min)
        # progress = a certification OR an outer prox recentering (a lane
        # legitimately descending its δ ladder must not trip the stall
        # detector even if its first rn ≤ tol is rounds away)
        if ok.any() or rec.any():
            progress_rd[0] = rd
        # singular factorization even with this δ: escalate the ladder
        for lane_i in sel[~ok & ~fin]:
            _bump_rung(lane_i)
        _dbg(f"newton rd={rd} lanes={sel.size} ok={int(ok.sum())} "
             f"adv={int(adv.sum())} recenter={int(rec.sum())} "
             f"sing={int((~ok & ~fin).sum())} "
             f"dmax={delta_lane[sel].max():.1e}")

    # --- fused first policy round (δ = 0, all lanes) -------------------
    # Labels, masks, and bound values never leave the device: the EG
    # classification feeds the basis solve directly, the host fetches only
    # the audited f64 results.  This is the round that solves ~all lanes
    # (a host-driven version would re-upload ~25 MB of f64 vectors).
    sing0: list = []
    z_out_deferred: list = []   # (sel, device z, ok mask) — async transfers
    # sharded round-0 runs as one call: each device factorizes its own S/D
    # lanes; mid-axis host chunking would break the sharding.  Scoped to
    # round 0 — later rounds re-upload small host chunks and must keep the
    # ordinary bucket ladder (a 600-lane straggler chunk padded to S would
    # waste ~7× device work per round)
    r0_chunk = S if mesh is not None else lane_chunk
    for ofs in range(0, S, r0_chunk):
        sel = np.arange(ofs, min(ofs + r0_chunk, S))
        _t0 = time.perf_counter()
        zc_d, rn_d, h_d = _round0_solve(
            M32_d, M64_d, at_l_d[ofs:ofs + sel.size],
            at_u_d[ofs:ofs + sel.size], Q64_d[ofs:ofs + sel.size],
            L64_d[ofs:ofs + sel.size], U64_d[ofs:ofs + sel.size], REFINES)
        lu_factored += sel.size
        refine_gemms += (REFINES + 1) * sel.size
        iters_out[sel] += 1
        rn = _fetch(rn_d)        # tiny fetch; blocks on the compute
        phase_t["round0_compute"] = (
            phase_t.get("round0_compute", 0.0) + time.perf_counter() - _t0)
        _t0 = time.perf_counter()
        fin = np.isfinite(rn)
        adv = fin & (rn > tol)
        if adv.any() or jax.process_count() > 1:
            # a lane will advance through the δ ladder: its basis solution
            # becomes the next classification point — fetch the chunk now
            zc, hs = _fetch(zc_d), _fetch(h_d)
            Fchunk = np.zeros_like(zc)
            Fchunk[adv] = zc[adv] @ M0.T + q[sel[adv]]
            sing0.extend(sel[~fin].tolist())
            _absorb(sel, zc, Fchunk, rn, rn, 0)  # δ=0 ⇒ prox resid = rn
        else:
            # every lane either certified or goes to the rungs: START the
            # 5 MB z transfer asynchronously and absorb it at assembly time
            # — the copy overlaps the structured-QP rung on the device
            try:
                zc_d.copy_to_host_async()
            except (AttributeError, RuntimeError):  # pragma: no cover
                pass
            hs = _fetch(h_d)
            ok = fin & (rn <= tol)
            z_out_deferred.append((sel, zc_d, ok))
            done[sel[ok]] = True
            if ok.any():
                progress_rd[0] = 0
            sing0.extend(sel[~fin].tolist())
            for lane_i in sel[~fin]:
                _bump_rung(lane_i)
            _dbg(f"newton rd=0 lanes={sel.size} ok={int(ok.sum())} adv=0 "
                 f"recenter=0 sing={int((~fin).sum())} dmax=0.0e+00 "
                 f"(z deferred)")
        phase_t["round0_fetch"] = (
            phase_t.get("round0_fetch", 0.0) + time.perf_counter() - _t0)
        # record the round-0 fingerprints so a lane re-presenting the same
        # classification later counts as cycling — the device hash and the
        # host loop's _label_hash are the SAME function (parity-tested), so
        # an exact round-1 repeat of the EG classification IS detected
        for k, lane in enumerate(sel):
            seen_cls[lane].add(int(hs[k]))
    # lanes whose round-0 factorization was singular keep the EG iterate as
    # their classification point — fill their natural map now (the full-
    # ensemble F64 host GEMM this replaces cost more than these few lanes)
    ladder = np.ones(S, dtype=bool)
    # newton_rounds from here on covers the δ-ladder only (round 0 has its
    # own round0_compute / round0_fetch entries)
    _t = time.perf_counter()
    if sing0:
        s0 = np.asarray(sing0, dtype=np.int64)
        Fc[s0] = Zc[s0] @ M0.T + q[s0]
        if structure is not None:
            # round-0-singular lanes ARE the dual-degenerate class: measured
            # on both the benign seed (11 ladder rounds certify 9/14, ADMM
            # takes the rest) and the hard seed (ladder certifies 0/82,
            # ADMM 82/82) — the δ ladder is the wrong tool for them, so
            # they skip it and go straight to the structured-QP rung
            ladder[s0] = False
            _dbg(f"{s0.size} round-0-singular lanes routed ADMM-first")

    policy_rounds = 0
    for rd in range(1, newton_rounds):
        todo = np.flatnonzero(~done & active & ladder)
        if todo.size == 0:
            break
        if rd - progress_rd[0] >= 8:
            # stall: no lane has certified for 8 consecutive rounds — the
            # remaining lanes are ladder-cyclers; hand them to the
            # escalation rungs (lstsq → structured ADMM → generic) instead
            # of paying ~20 more fruitless classify/solve rounds (measured
            # on the T=8 ensemble: past this point the ladder certifies
            # ~0 further lanes)
            _dbg(f"newton stall at rd={rd}: {todo.size} lanes to rungs")
            break
        # classify from the PROX natural map s = z − (F + δ(z − z_ref));
        # for δ=0 lanes this is the original map
        Fp = Fc[todo] + delta_lane[todo, None] * (Zc[todo] - zref[todo])
        at_l, at_u = _classify(Zc[todo], Fp, l64[todo], u64[todo],
                               band_lane[todo, None])
        free = ~(at_l | at_u)
        bval = np.where(at_l, l_fin[todo], u_fin[todo])
        # cycling inside one (δ, z_ref) context: escalate the ladder
        # (fingerprints from the same hash stream as the device round-0)
        fps = _label_hash(at_l, at_u, hash_w)
        fresh = np.ones(todo.size, dtype=bool)
        for k, lane in enumerate(todo):
            fp = int(fps[k])
            if fp in seen_cls[lane]:
                fresh[k] = False
                _bump_rung(lane)
            else:
                seen_cls[lane].add(fp)
        todo = todo[fresh]
        if todo.size == 0:
            continue
        free, bval = free[fresh], bval[fresh]
        policy_rounds += 1
        for ofs in range(0, todo.size, lane_chunk):
            sel = todo[ofs:ofs + lane_chunk]
            sl = slice(ofs, ofs + sel.size)
            if sel.size <= 24:
                # straggler TAIL on host f64 LAPACK: at these lane counts a
                # device dispatch is latency-bound and exact f64 needs no
                # refinement or f32
                # singularity handling — the δ ladder converges in fewer
                # rounds too
                zc, Fchunk, rn, rp = _host_basis_solve(
                    M0, free[sl], bval[sl], q[sel], l64[sel], u64[sel],
                    delta_lane[sel], zref[sel])
                host_solves += sel.size
                iters_out[sel] += 1
            else:
                # bucket-pad the lane count (repeat lane 0, sliced off
                # below) so shrinking rounds reuse one compiled shape
                Cb = next(b for b in (64, 128, 256, 512, lane_chunk)
                          if b >= sel.size)
                pad = Cb - sel.size

                def _p(a):
                    a = np.asarray(a)
                    return (np.concatenate(
                        [a, np.repeat(a[:1], pad, axis=0)]) if pad else a)
                args = (M32_l, M64_l, jnp.asarray(_p(free[sl])),
                        jnp.asarray(_p(bval[sl])), jnp.asarray(_p(q[sel])),
                        jnp.asarray(_p(l64[sel])),
                        jnp.asarray(_p(u64[sel])),
                        jnp.asarray(_p(delta_lane[sel])),
                        jnp.asarray(_p(zref[sel])))
                zc_d, Fc_d, rn_d, rp_d = _basis_solve_refine(*args, REFINES)
                lu_factored += sel.size
                refine_gemms += (REFINES + 1) * sel.size
                iters_out[sel] += 1
                # ONE fetch per chunk: solution, map, audited residuals
                zc, Fchunk, rn, rp = (
                    np.asarray(a)[:sel.size] for a in
                    jax.device_get((zc_d, Fc_d, rn_d, rp_d)))
            _absorb(sel, zc, Fchunk, rn, rp, rd)

    phase_t["newton_rounds"] = time.perf_counter() - _t
    _t = time.perf_counter()

    # chip-bulk structured rung FIRST: f32 ADMM on the underlying QPs as ONE
    # device dispatch (f32 Cholesky at nd) + tiny active-set host polish.
    # Certifies the
    # dual-degenerate lane class at device speed; only its remnants pay the
    # host-pinned f64 ADMM below.
    todo = np.flatnonzero(~done)
    # the chip rung (split-f32 mixed ADMM + structured polish) is first for
    # ANY straggler count: it beat the host f64 rung at every size measured
    # on the earlier accelerator, and one path keeps the straggler
    # population's resolution deterministic
    chip_admm_flops = 0.0
    if todo.size and structure is not None:
        METRICS.bump("shared_kkt_chip_admm_rung", todo.size)
        zc, ok, chip_admm_flops = _chip_admm_rung(
            M0, q, l64, u64, todo, structure, tol, scale, iters_out)
        z_out[todo[ok]] = zc[ok]
        done[todo[ok]] = True
        _dbg(f"chip ADMM rung lanes={todo.size} ok={int(ok.sum())}")
    phase_t["chip_admm_rung"] = time.perf_counter() - _t
    _t = time.perf_counter()

    # structured ADMM rung FIRST among the escalations: these ensembles
    # are QP-KKT systems, and solving the stragglers' underlying QPs with
    # the batched ADMM kernel + dual reconstruction + Newton polish (the
    # round-1 structured route) is the measured win for the degenerate
    # lane class robust_avoid produces — on a degenerate-heavy seed the
    # ladder/lstsq/prox rungs certified 0 of 82 such lanes while this rung
    # certified 82/82.  Off-accelerator per the escalation placement
    # policy (_escalation_device; ROADMAP C4).
    todo = np.flatnonzero(~done)
    if todo.size and structure is not None:
        import contextlib
        from .avi import _solve_kkt_avi_batch_impl
        METRICS.bump("shared_kkt_admm_escalation", todo.size)
        dev = _escalation_device()
        ctx = jax.default_device(dev) if dev is not None else (
            contextlib.nullcontext())
        Mrep = np.repeat(M0[None], todo.size, axis=0)
        vm = np.ones((todo.size, n), dtype=bool)
        st = {k: v for k, v in structure.items() if k != "shared_M"}
        with ctx:
            sub = _solve_kkt_avi_batch_impl(
                Mrep, q[todo], l64[todo], u64[todo], vm, st, tol, None,
                "admm")
        ok = np.asarray(sub.converged)
        z_out[todo[ok]] = np.asarray(sub.z)[ok]
        done[todo[ok]] = True
        iters_out[todo] += np.asarray(sub.iters, dtype=np.int64)
        _dbg(f"ADMM structured rung lanes={todo.size} ok={int(ok.sum())}")
    phase_t["admm_rung"] = time.perf_counter() - _t
    _t = time.perf_counter()

    # exact host f64 MIN-NORM solve for lanes whose f32 factorization
    # couldn't be refined: degenerate classifications give SINGULAR but
    # consistent basis systems (the solution face is an affine set) — lstsq
    # picks a valid point where np.linalg.solve returns garbage without
    # raising.  Two classification bands tried per lane.
    for band in (1e-4 * scale, 1e-2 * scale):
        todo = np.flatnonzero(~done)
        if todo.size == 0:
            break
        at_l, at_u = _classify(Zc[todo], Fc[todo], l64[todo], u64[todo],
                               band)
        free = ~(at_l | at_u)
        bval = np.where(at_l, l_fin[todo], u_fin[todo])
        A = np.where(free[:, :, None], M0[None], np.eye(n)[None])
        rhs = np.where(free, -q[todo], bval)
        # gelsy (pivoted QR) over the default gelsd (SVD): same min-norm
        # answer for these consistent systems at ~4× less per-lane cost
        # (measured ~2s/lane SVD at n=608 — the dominant rung cost on
        # degenerate-heavy seeds)
        import scipy.linalg as sla
        zc = np.stack([sla.lstsq(A[i], rhs[i], lapack_driver="gelsy",
                                 check_finite=False)[0]
                       for i in range(todo.size)])
        host_solves += todo.size
        iters_out[todo] += 1
        rn, _ = _nat_resid_shared(M0, q[todo], l64[todo], u64[todo], zc)
        ok = np.isfinite(rn) & (rn <= tol)
        z_out[todo[ok]] = zc[ok]
        done[todo[ok]] = True
        _dbg(f"host lstsq solve band={band:.1e} lanes={todo.size} "
             f"ok={int(ok.sum())}")

    phase_t["host_lstsq"] = time.perf_counter() - _t
    _t = time.perf_counter()

    # opt-in batched proximal-point rung ON DEVICE (one dispatch): solves
    # mildly degenerate monotone-dominant ensembles without host work, but
    # on robust_avoid's heavily skew/rank-deficient lane class it measured
    # 0 certifications in 40 outer rounds (first-order methods crawl on
    # these), so it is off the default path
    todo = np.flatnonzero(~done)
    if enable_prox_eg and todo.size >= 8:
        METRICS.bump("shared_kkt_prox_eg_rung", todo.size)
        Cb = next(b for b in (64, 128, 256, 512, 1024, 2048, 4096)
                  if b >= todo.size) if todo.size <= 4096 else todo.size
        pad = Cb - todo.size

        def _p(a):
            a = np.asarray(a)
            return (np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
                    if pad else a)
        delta_p = 0.05 * max(Lip, 1e-12)
        tau_p = np.float32(0.9 / (Lip + delta_p))
        zp_d, rnp_d, kp = _prox_eg_rung(
            M32_l, M64_l, jnp.asarray(_p(q[todo])),
            jnp.asarray(_p(l64[todo])), jnp.asarray(_p(u64[todo])),
            jnp.asarray(_p(Zc[todo])), np.float32(delta_p), tau_p,
            tol, 1000, 40)
        zp, rnp = (np.asarray(a)[:todo.size] for a in
                   jax.device_get((zp_d, rnp_d)))
        ok = np.isfinite(rnp) & (rnp <= tol)
        z_out[todo[ok]] = zp[ok]
        done[todo[ok]] = True
        iters_out[todo] += int(kp) * 1000
        _dbg(f"prox-EG rung lanes={todo.size} outers={int(kp)} "
             f"ok={int(ok.sum())}")
    phase_t["prox_eg_rung"] = time.perf_counter() - _t
    _t = time.perf_counter()

    # last resort: the generic adaptive per-lane solver (audited like
    # everything else); scenario stragglers here are genuinely hard lanes
    todo = np.flatnonzero(~done)
    if todo.size:
        METRICS.bump("shared_kkt_generic_escalation", todo.size)
        zg, ok, it_g = _escalate_generic(M0, q[todo], l64[todo], u64[todo],
                                         Z64[todo], tol)
        z_out[todo[ok]] = zg[ok]
        done[todo[ok]] = True
        iters_out[todo] += it_g
        _dbg(f"generic escalation (host) lanes={todo.size} "
             f"ok={int(ok.sum())}")

    phase_t["escalations"] = time.perf_counter() - _t
    _t = time.perf_counter()
    # absorb the deferred round-0 solutions: their host copies were started
    # asynchronously before the rungs ran, so this materialization is ~free
    # (round-0-certified lanes are disjoint from every rung's lanes)
    for sel, zc_d, ok in z_out_deferred:
        if ok.any():
            z_out[sel[ok]] = np.asarray(zc_d, dtype=np.float64)[ok]
    resid, _ = _nat_resid_shared(M0, q, l64, u64, z_out)
    phase_t["final_audit"] = time.perf_counter() - _t
    converged = resid <= tol
    METRICS.bump("shared_kkt_solves", int(converged.sum()))

    if stats is not None:
        # device FLOP ledger (host LAPACK solves and the host-pinned
        # escalation excluded — MFU reads as useful work extracted from the
        # CHIP; the on-device f64 refinement GEMMs are counted at their
        # nominal flop count)
        gemm = 2.0 * S * n * n
        eg_fl = eg_iters * 2.0 * gemm + (eg_iters / eg_chunk + 1) * gemm
        lu_fl = lu_factored * (2.0 / 3.0) * n ** 3
        tri_fl = (lu_factored + refine_gemms) * 2.0 * n * n * 2.0
        ref_fl = refine_gemms * 2.0 * n * n
        stats.update(dict(
            eg_iters=eg_iters, policy_rounds=policy_rounds,
            lu_factored=lu_factored,
            refine_gemms=refine_gemms, host_solves=host_solves,
            device_flops=eg_fl + lu_fl + tri_fl + ref_fl + chip_admm_flops,
            device_bytes=4.0 * (eg_iters * (n * n + 3.0 * S * n)
                                + lu_factored * 2.0 * n * n),
            phase_t={k: round(v, 3) for k, v in phase_t.items()},
        ))

    return AVIResult(z=z_out, resid=resid, iters=iters_out,
                     converged=converged)
