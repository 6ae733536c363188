"""Batched Lemke-style complementary pivoting for box AVIs.

The reference's equilibrium core is PATH — a *pivoting* mixed-complementarity
solver (``avi.jl:63-77``; in-repo prior art ``deprecated/avi_scratch.jl:17-134``
is a hand-rolled tableau method with ray termination).  Pivoting is what makes
PATH reliable on the degenerate LP-KKT / QEP systems where smooth Newton-type
methods stall: it terminates *exactly* on a complementary basis instead of
chasing a semismooth residual through singular Jacobians.

This module is the batched counterpart, designed from the classical theory
(Lemke's complementary pivoting with a covering vector, extended to box
constraints) rather than translated:

* The box AVI  ``M z + q ⟂ l ≤ z ≤ u``  is pivoted directly — no reduction to
  a standard LCP.  Every index ``i`` owns three candidate variables: ``z_i``
  (basic when strictly between bounds), a lower slack ``u_i ≥ 0`` (basic when
  ``z_i = l_i``) and an upper slack ``v_i ≥ 0`` (basic when ``z_i = u_i``),
  tied by the tableau equation ``M z − u + v + c·t = −q``.
* Free rows (``l = −∞, u = +∞``) keep ``z_i`` basic forever — equations.
  Pinned rows (``l = u``, incl. batch padding) make the slack sign-free.
* The artificial ``t`` enters first along a covering direction that lifts
  exactly the infeasible slack rows; Lemke's almost-complementary path is then
  followed (complement of the exiting variable enters; entering variables that
  span their whole box *bound-flip* and hand over to their opposite slack)
  until ``t`` exits (SUCCESS) or a ray is found (RAY_TERM).
* Degeneracy is resolved by the **lexicographic ratio test** using the
  ``−B⁻¹`` block that the tableau already carries in its ``u``-columns — no
  extra storage, no random perturbation, no cycling.
* The batched implementation is fixed-shape JAX: state is a ``(B, n, 3n+2)``
  tableau plus integer basis bookkeeping, advanced by rank-1 pivot updates
  inside one ``lax.while_loop`` with per-lane done masks, so hundreds of AVIs
  pivot in lockstep on one chip.

Free-variable blocks of equilibrium assemblies are often structurally singular
(saddle KKT systems: the free/free block of ``M`` can be exactly zero), which
makes the *initial* complementary basis singular.  The driver therefore
supports proximal regularization: solve ``(M + δI) z + (q − δ z_ref) ⟂ [l,u]``
— strongly monotone, hence a P-matrix problem Lemke processes without rays —
and hand the exact pivoting solution to the Newton polish on the unregularized
problem.  One or two proximal rounds recover the true active set; PATH's own
crash phase plays the same role.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_INF = np.inf
_HIGHEST = jax.lax.Precision.HIGHEST


class LemkeResult(NamedTuple):
    z: np.ndarray          # (B, n) solution estimate
    status: np.ndarray     # (B,) 1=success 2=ray 3=max_pivots 4=singular
    pivots: np.ndarray     # (B,)


LEMKE_SUCCESS = 1
LEMKE_RAY = 2
LEMKE_MAX = 3
LEMKE_SINGULAR = 4


# --------------------------------------------------------------------------
#  Host (numpy) reference implementation — the oracle for the batched kernel
#  and the fallback for host-driven single solves.
# --------------------------------------------------------------------------

def synth_bounds(l, u, z0, synth_scale):
    """Cap infinite bounds with synthetic big-M boxes centered at the start.

    With every variable boxed, the initial Lemke basis is pure slack (∓I,
    always invertible — the structurally singular free/free saddle blocks of
    equilibrium KKT systems never enter a factorization) and the PRIMAL
    iterates stay in a compact box.  Ray termination is still possible
    (rarely — measured ~3% on adversarial degenerate M): entering SLACKS
    keep an infinite upper bound, so an all-infinite ratio column can occur
    on rank-deficient/indefinite M even inside the box; callers must treat
    LEMKE_RAY as a normal failure status, never as unreachable.  A solution
    pressed against a synthetic bound is NOT a solution of the original AVI;
    callers audit against the true bounds and retry with a larger box (see
    lemke_escalate).
    """
    ref = np.clip(np.nan_to_num(np.clip(np.nan_to_num(z0), l, u)),
                  -1e12, 1e12)
    fin = np.concatenate([l[np.isfinite(l)], u[np.isfinite(u)]])
    L = synth_scale * (1.0 + np.abs(ref).max(initial=0.0)
                       + (np.abs(fin).max() if fin.size else 0.0))
    l_eff = np.where(np.isinf(l), ref - L, l)
    u_eff = np.where(np.isinf(u), ref + L, u)
    return l_eff, u_eff, L


def solve_lemke_np(M, q, l, u, z0=None, tol=1e-9, piv_tol=1e-11,
                   max_pivots=None, synth_scale=1e4, cover="viol",
                   at_lower=None):
    """Single-instance box-AVI complementary pivoting (host reference).

    Returns ``(z, status, pivots)``.  ``status == LEMKE_SUCCESS`` means an
    exact complementary basis was reached *for the synthetically boxed
    problem*; the caller should audit the natural residual against the true
    bounds (matching the reference's own ``check_avi_solution`` discipline,
    avi.jl:148-156) — a solution pressed against a synthetic bound fails it.
    """
    M = np.asarray(M, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    l_orig = np.asarray(l, dtype=np.float64)
    u_orig = np.asarray(u, dtype=np.float64)
    n = q.shape[0]
    if max_pivots is None:
        max_pivots = max(400, 20 * n)
    if z0 is None:
        z0 = np.zeros(n)
    zc = np.clip(np.nan_to_num(np.asarray(z0, dtype=np.float64)),
                 l_orig, u_orig)
    zc = np.clip(np.nan_to_num(zc), -1e12, 1e12)

    l_eff, u_eff, _L = synth_bounds(l_orig, u_orig, zc, synth_scale)
    l, u = l_eff, u_eff
    pinned = (u - l) <= 0.0

    # variable id map: z_i = i, u_i = n+i, v_i = 2n+i, t = 3n
    T_ID = 3 * n
    var_lb = np.empty(3 * n + 1)
    var_ub = np.empty(3 * n + 1)
    var_lb[:n], var_ub[:n] = l, u
    var_lb[n:2 * n] = np.where(pinned, -_INF, 0.0)   # pinned slack sign-free
    var_ub[n:2 * n] = _INF
    var_lb[2 * n:3 * n] = 0.0
    var_ub[2 * n:3 * n] = _INF
    var_lb[T_ID], var_ub[T_ID] = 0.0, _INF

    # nonbasic z start at the bound nearest to z0; slack basic = ∓row
    if at_lower is None:
        at_lower = (zc - l) <= (u - zc)
    start_val = np.where(at_lower, l, u)

    basis = np.where(at_lower, n + np.arange(n), 2 * n + np.arange(n))
    val = np.zeros(3 * n + 1)
    val[:n] = start_val

    # initial basis is ∓I — premultiplication is a row sign flip, no solve
    sign = np.where(at_lower, -1.0, 1.0)
    T = sign[:, None] * np.concatenate(
        [M, -np.eye(n), np.eye(n), np.zeros((n, 1)), -q[:, None]], axis=1)

    def basic_values():
        nb = val.copy()
        nb[basis] = 0.0
        return T[:, -1] - T[:, :3 * n + 1] @ nb

    xB = basic_values()
    blb = var_lb[basis]
    viol = np.maximum(blb - xB, 0.0)
    scale = 1.0 + np.abs(q).max(initial=0.0) + np.abs(xB).max(initial=0.0)
    if viol.max(initial=0.0) <= tol * scale:
        return _extract_np(n, basis, val, xB), LEMKE_SUCCESS, 0

    # --- first pivot: t enters along the covering direction --------------
    if cover == "all":
        s = np.ones(n)            # classic Lemke covering (different path)
    else:
        s = (viol > tol * scale).astype(np.float64)
    T[:, T_ID] = -s
    jstar = int(np.argmax(viol))
    if abs(T[jstar, T_ID]) < piv_tol:
        return zc, LEMKE_SINGULAR, 0
    exiting = int(basis[jstar])
    val[exiting] = var_lb[exiting]        # exits at the bound it violated
    _pivot_np(T, jstar, T_ID)
    basis[jstar] = T_ID
    val[T_ID] = 0.0

    entering, ent_dir, ent_val = _complement_np(exiting, val, l, u, n)

    pivots = 1
    while pivots < max_pivots:
        val[entering] = ent_val
        nb = val.copy()
        nb[basis] = 0.0
        xB = T[:, -1] - T[:, :3 * n + 1] @ nb
        d = ent_dir * T[:, entering]
        blb = var_lb[basis]
        bub = var_ub[basis]
        with np.errstate(divide="ignore", invalid="ignore"):
            theta = np.where(d > piv_tol, (xB - blb) / d,
                             np.where(d < -piv_tol, (xB - bub) / d, _INF))
        theta = np.where(np.isnan(theta), _INF, np.maximum(theta, 0.0))
        # entering variable's own range (bound flip)
        if ent_dir > 0:
            theta_e = var_ub[entering] - ent_val
        else:
            theta_e = ent_val - var_lb[entering]
        tstar = theta.min(initial=_INF)

        if not np.isfinite(tstar) and not np.isfinite(theta_e):
            return (_extract_np(n, basis, val, xB), LEMKE_RAY, pivots)

        if theta_e <= tstar:                       # bound flip
            newv = (var_ub[entering] if ent_dir > 0 else var_lb[entering])
            val[entering] = newv
            i = entering % n
            if ent_dir > 0:        # z_i reached its upper bound
                entering, ent_dir, ent_val = 2 * n + i, 1.0, 0.0
            else:                  # z_i reached its lower bound
                entering, ent_dir, ent_val = n + i, 1.0, 0.0
            pivots += 1
            continue

        # lexicographic tie-break over -B^{-1} (the u-column block)
        ties = np.nonzero(theta <= tstar + tol * (1.0 + abs(tstar)))[0]
        if len(ties) > 1:
            trow = np.nonzero(basis == T_ID)[0]
            if len(trow) and trow[0] in ties:
                jstar = int(trow[0])               # let t exit: terminate
            else:
                cand = ties
                for k in range(n):
                    key = -T[cand, n + k] / d[cand]
                    kmin = key.min()
                    cand = cand[key <= kmin + 1e-12 * (1.0 + abs(kmin))]
                    if len(cand) == 1:
                        break
                jstar = int(cand[0])
        else:
            jstar = int(ties[0])

        if abs(T[jstar, entering]) < piv_tol:
            # numerically unusable pivot: treat as ray/abort
            return (_extract_np(n, basis, val, xB), LEMKE_SINGULAR, pivots)

        exiting = int(basis[jstar])
        hit_lower = d[jstar] > 0
        val[exiting] = var_lb[exiting] if hit_lower else var_ub[exiting]
        _pivot_np(T, jstar, entering)
        basis[jstar] = entering
        val[entering] = 0.0
        pivots += 1

        if exiting == T_ID:
            xB = _refactor_np(M, q, basis, val, n)
            if xB is None:
                nb = val.copy()
                nb[basis] = 0.0
                xB = T[:, -1] - T[:, :3 * n + 1] @ nb
            return (_extract_np(n, basis, val, xB), LEMKE_SUCCESS, pivots)

        entering, ent_dir, ent_val = _complement_np(exiting, val, l, u, n)

    nb = val.copy()
    nb[basis] = 0.0
    xB = T[:, -1] - T[:, :3 * n + 1] @ nb
    return _extract_np(n, basis, val, xB), LEMKE_MAX, pivots


def _refactor_np(M, q, basis, val, n):
    """Recompute basic values from the original data at the terminal basis
    (kills accumulated rank-1 pivot drift); None if the basis is singular."""
    Bmat = np.zeros((n, n))
    for j, var in enumerate(basis):
        if var < n:
            Bmat[:, j] = M[:, var]
        elif var < 2 * n:
            Bmat[var - n, j] = -1.0
        elif var < 3 * n:
            Bmat[var - 2 * n, j] = 1.0
        else:
            return None            # t still basic
    nb = val.copy()
    nb[basis] = 0.0
    rhs = -q - M @ nb[:n] + nb[n:2 * n] - nb[2 * n:3 * n]
    try:
        xB = np.linalg.solve(Bmat, rhs)
    except np.linalg.LinAlgError:
        return None
    return xB if np.all(np.isfinite(xB)) else None


def _pivot_np(T, row, col):
    T[row, :] = T[row, :] / T[row, col]
    other = T[:, col].copy()
    other[row] = 0.0
    T -= np.outer(other, T[row, :])


def _complement_np(exiting, val, l, u, n):
    """Lemke rule: the complement of the exiting variable drives next."""
    i = exiting % n
    if exiting < n:                      # z_i exited at a bound
        at_l = abs(val[exiting] - l[i]) <= abs(val[exiting] - u[i])
        return (n + i, 1.0, 0.0) if at_l else (2 * n + i, 1.0, 0.0)
    if exiting < 2 * n:                  # u_i exited → z_i rises from l_i
        return i, 1.0, l[i]
    return i, -1.0, u[i]                 # v_i exited → z_i falls from u_i


def _extract_np(n, basis, val, xB):
    z = val[:n].copy()
    rows = np.nonzero(basis < n)[0]
    z[basis[rows]] = xB[rows]
    return z


# --------------------------------------------------------------------------
#  Batched fixed-shape JAX kernel
# --------------------------------------------------------------------------

class LemkeInit(NamedTuple):
    """Shared pre-pivot state (synthetic boxes applied, first pivot done).

    Produced by :func:`_lemke_setup`, consumed by both the XLA while_loop
    lane (:func:`_lemke_single`) and the Pallas fused kernel
    (ops/lemke_pallas.py) so the two engines follow the identical
    almost-complementary path."""
    T1: jnp.ndarray            # (n, 3n+2) tableau after t entered
    T0t: jnp.ndarray           # pre-pivot tableau, t column zeroed
    basis1: jnp.ndarray        # (n,) basis after first pivot
    basis0: jnp.ndarray        # (n,) slack start basis
    val0: jnp.ndarray          # (3n+1,) nonbasic values
    ent0: jnp.ndarray          # () entering variable id
    dir0: jnp.ndarray          # () entering direction
    ev0: jnp.ndarray           # () entering start value
    status_init: jnp.ndarray   # () 0 = keep pivoting
    solved_at_start: jnp.ndarray
    var_lb: jnp.ndarray        # (3n+1,)
    var_ub: jnp.ndarray        # (3n+1,)
    l_eff: jnp.ndarray         # (n,) synthetically boxed bounds
    u_eff: jnp.ndarray         # (n,)
    Mm: jnp.ndarray            # (n, n) padding-masked M (identity rows)
    qm: jnp.ndarray            # (n,) padding-masked q


def _lemke_setup(M, q, l, u, z0, var_mask, *, tol, synth_scale, cover):
    """Everything before the pivot loop: masking, synthetic boxes, slack
    basis, covering direction, first pivot (t enters)."""
    n = q.shape[0]
    dt = q.dtype
    T_ID = 3 * n
    eye = jnp.eye(n, dtype=dt)

    # padded variables become pinned-at-zero rows with identity diagonal
    M = jnp.where(var_mask[:, None] & var_mask[None, :], M, eye)
    q = jnp.where(var_mask, q, 0.0)
    l = jnp.where(var_mask, l, 0.0)
    u = jnp.where(var_mask, u, 0.0)

    # synthetic big-M boxes on infinite bounds (see synth_bounds): the
    # initial basis is pure slack and rays are impossible
    zc = jnp.clip(jnp.nan_to_num(jnp.clip(jnp.nan_to_num(z0), l, u)),
                  -1e12, 1e12)
    fin_mag = jnp.maximum(
        jnp.max(jnp.where(jnp.isfinite(l), jnp.abs(l), 0.0), initial=0.0),
        jnp.max(jnp.where(jnp.isfinite(u), jnp.abs(u), 0.0), initial=0.0))
    L = synth_scale * (1.0 + jnp.max(jnp.abs(zc), initial=0.0) + fin_mag)
    l = jnp.where(jnp.isinf(l), zc - L, l)
    u = jnp.where(jnp.isinf(u), zc + L, u)
    pinned = (u - l) <= 0.0

    inf = jnp.asarray(_INF, dtype=dt)
    var_lb = jnp.concatenate([l, jnp.where(pinned, -inf, 0.0),
                              jnp.zeros(n, dt), jnp.zeros(1, dt)])
    var_ub = jnp.concatenate([u, jnp.full(n, inf, dt), jnp.full(n, inf, dt),
                              jnp.full(1, inf, dt)])

    at_lower = (zc - l) <= (u - zc)
    start_val = jnp.where(at_lower, l, u)

    ar = jnp.arange(n)
    basis0 = jnp.where(at_lower, n + ar, 2 * n + ar)
    val0 = jnp.concatenate([start_val, jnp.zeros(2 * n + 1, dt)])

    # initial basis is ∓I — premultiplication is a row sign flip, no solve
    sign = jnp.where(at_lower, -1.0, 1.0)
    T0 = sign[:, None] * jnp.concatenate(
        [M, -eye, eye, jnp.zeros((n, 1), dt), -q[:, None]], axis=1)

    def basic_values(T, basis, val):
        nb = val.at[basis].set(0.0)
        return T[:, -1] - jnp.dot(T[:, :3 * n + 1], nb, precision=_HIGHEST)

    xB0 = basic_values(T0, basis0, val0)
    blb0 = var_lb[basis0]
    viol = jnp.maximum(blb0 - xB0, 0.0)
    scale = (1.0 + jnp.max(jnp.abs(q), initial=0.0)
             + jnp.max(jnp.abs(xB0), initial=0.0))
    solved_at_start = jnp.max(viol, initial=0.0) <= tol * scale

    # --- first pivot: t enters along the covering direction ----------------
    if cover == "all":
        s_cov = jnp.ones(n, dt)
    else:
        s_cov = (viol > tol * scale).astype(dt)
    T0 = T0.at[:, T_ID].set(-s_cov)
    j0 = jnp.argmax(viol)
    exiting0 = basis0[j0]
    val0 = val0.at[exiting0].set(var_lb[exiting0])
    T1 = _pivot_jax(T0, j0, jnp.asarray(T_ID))
    basis1 = basis0.at[j0].set(T_ID)

    ent0, dir0, ev0 = _complement_jax(exiting0, val0, l, u, n)

    status_init = jnp.where(solved_at_start, LEMKE_SUCCESS, 0)
    return LemkeInit(T1=T1, T0t=T0.at[:, T_ID].set(0.0), basis1=basis1,
                     basis0=basis0, val0=val0, ent0=ent0, dir0=dir0,
                     ev0=ev0, status_init=status_init,
                     solved_at_start=solved_at_start, var_lb=var_lb,
                     var_ub=var_ub, l_eff=l, u_eff=u, Mm=M, qm=q)


def _lemke_single(M, q, l, u, z0, var_mask, *, tol, piv_tol, max_pivots,
                  synth_scale, cover):
    """One lane of the batched pivot loop (vmapped by solve_lemke_batch).

    Mirrors :func:`solve_lemke_np` with masks instead of branches; every
    array is fixed-shape, the while_loop carries (T, basis, val, entering…).
    """
    n = q.shape[0]
    dt = q.dtype
    T_ID = 3 * n
    init = _lemke_setup(M, q, l, u, z0, var_mask, tol=tol,
                        synth_scale=synth_scale, cover=cover)
    # padding-masked data single-sourced from setup: the terminal QR
    # refactorization must see the same pinned-row convention the tableau
    # was pivoted on
    M, q = init.Mm, init.qm
    l, u = init.l_eff, init.u_eff
    var_lb, var_ub = init.var_lb, init.var_ub
    solved_at_start = init.solved_at_start
    T0, T1 = init.T0t, init.T1
    basis0, basis1, val0 = init.basis0, init.basis1, init.val0
    ent0, dir0, ev0 = init.ent0, init.dir0, init.ev0
    status_init = init.status_init
    inf = jnp.asarray(_INF, dtype=dt)

    def basic_values(T, basis, val):
        nb = val.at[basis].set(0.0)
        return T[:, -1] - jnp.dot(T[:, :3 * n + 1], nb, precision=_HIGHEST)

    def cond(state):
        T, basis, val, entering, ent_dir, ent_val, k, status = state
        return (status == 0) & (k < max_pivots)

    def body(state):
        T, basis, val, entering, ent_dir, ent_val, k, status = state
        val = val.at[entering].set(ent_val)
        nb = val.at[basis].set(0.0)
        xB = T[:, -1] - jnp.dot(T[:, :3 * n + 1], nb, precision=_HIGHEST)
        d = ent_dir * T[:, entering]
        blb = var_lb[basis]
        bub = var_ub[basis]
        theta = jnp.where(d > piv_tol, (xB - blb) / d,
                          jnp.where(d < -piv_tol, (xB - bub) / d, inf))
        theta = jnp.maximum(jnp.nan_to_num(theta, nan=_INF, posinf=_INF), 0.0)
        theta_e = jnp.where(ent_dir > 0, var_ub[entering] - ent_val,
                            ent_val - var_lb[entering])
        tstar = jnp.min(theta, initial=_INF)

        is_ray = ~jnp.isfinite(tstar) & ~jnp.isfinite(theta_e)
        do_flip = ~is_ray & (theta_e <= tstar)

        # ---- bound flip branch (no basis change) --------------------------
        i_e = entering % n
        flip_newval = jnp.where(ent_dir > 0, var_ub[entering],
                                var_lb[entering])
        flip_entering = jnp.where(ent_dir > 0, 2 * n + i_e, n + i_e)

        # ---- pivot branch -------------------------------------------------
        tie = theta <= tstar + tol * (1.0 + jnp.abs(tstar))
        t_row = basis == T_ID
        pick_t = jnp.any(tie & t_row)
        # lexicographic refinement over the -B^{-1} block (u-columns);
        # early-exit while_loop: the typical pivot has a unique minimum, so
        # this runs ZERO iterations instead of a fixed n-step fori_loop —
        # the dominant latency term of the pivot body
        safe_d = jnp.where(jnp.abs(d) > piv_tol, d, 1.0)

        def lex_cond(state):
            kk, cand = state
            return (jnp.sum(cand) > 1) & (kk < n)

        def lex_body(state):
            kk, cand = state
            key = jnp.where(cand, -T[:, n + kk] / safe_d, inf)
            kmin = jnp.min(key, initial=_INF)
            keep = cand & (key <= kmin + 1e-12 * (1.0 + jnp.abs(kmin)))
            return kk + 1, keep

        _, cand = jax.lax.while_loop(lex_cond, lex_body, (jnp.int32(0), tie))
        jstar = jnp.where(pick_t, jnp.argmax(tie & t_row), jnp.argmax(cand))
        piv = T[jstar, entering]
        bad_piv = jnp.abs(piv) < piv_tol

        exiting = basis[jstar]
        hit_lower = d[jstar] > 0
        exit_val = jnp.where(hit_lower, var_lb[exiting], var_ub[exiting])

        T_piv = _pivot_jax(T, jstar, entering)
        basis_piv = basis.at[jstar].set(entering)
        val_piv = val.at[exiting].set(exit_val).at[entering].set(0.0)
        t_exits = exiting == T_ID
        nent, ndir, nev = _complement_jax(exiting, val_piv, l, u, n)

        do_pivot = ~is_ray & ~do_flip & ~bad_piv
        T = jnp.where(do_pivot, T_piv, T)
        basis = jnp.where(do_pivot, basis_piv, basis)
        val = jnp.where(do_pivot, val_piv,
                        jnp.where(do_flip, val.at[entering].set(flip_newval),
                                  val))
        entering_n = jnp.where(do_pivot, nent,
                               jnp.where(do_flip, flip_entering, entering))
        dir_n = jnp.where(do_pivot, ndir, jnp.where(do_flip, 1.0, ent_dir))
        ev_n = jnp.where(do_pivot, nev, jnp.where(do_flip, 0.0, ent_val))
        status = jnp.where(is_ray, LEMKE_RAY,
                           jnp.where(~do_flip & bad_piv, LEMKE_SINGULAR,
                                     jnp.where(do_pivot & t_exits,
                                               LEMKE_SUCCESS, status)))
        # pivot-count parity with the numpy oracle / C++ port: a ray or
        # singular termination performs NO pivot, so k must not advance
        # (the oracle returns before its `pivots += 1`)
        k_n = jnp.where(is_ray | (~do_flip & bad_piv), k, k + 1)
        return (T, basis, val, entering_n, dir_n, ev_n, k_n, status)

    state0 = (T1, basis1, val0, ent0, dir0, ev0, jnp.int32(1),
              jnp.int32(status_init))
    T, basis, val, _, _, _, k, status = jax.lax.while_loop(cond, body, state0)

    # solved-at-start lanes keep their pre-pivot state
    T = jnp.where(solved_at_start, T0, T)
    basis = jnp.where(solved_at_start, basis0, basis)
    return _lemke_extract(init, basic_values(T, basis, val), basis, val, k,
                          status, var_mask)


def _lemke_extract(init, xB, basis, val, k, status, var_mask):
    """Terminal step of one lane, shared by both pivot engines: final
    status, on-device refactorisation of the basic values, and z."""
    M, q = init.Mm, init.qm
    n = q.shape[0]
    dt = q.dtype
    T_ID = 3 * n
    status = jnp.where(status == 0, LEMKE_MAX, status)
    # ---- terminal refactorization ------------------------------------
    # rank-1 pivot updates drift over ~n pivots; with t nonbasic the final
    # complementary basis is known exactly, so recompute the basic values
    # from the ORIGINAL data with one QR solve (machine-precision result,
    # no running refactorization needed)
    from .linalg import qr_solve
    bz = basis < n
    bu = (basis >= n) & (basis < 2 * n)
    col_z = M[:, jnp.clip(basis, 0, n - 1)]              # (n, n) gathered
    slack_idx = jnp.where(bu, basis - n, jnp.clip(basis - 2 * n, 0, n - 1))
    e_cols = (jnp.arange(n)[:, None] == slack_idx[None, :]).astype(dt)
    sgn = jnp.where(bu, -1.0, 1.0)
    Bmat = jnp.where(bz[None, :], col_z, sgn[None, :] * e_cols)
    val_nb = val.at[basis].set(0.0)
    rhs_exact = (-q - jnp.dot(M, val_nb[:n], precision=_HIGHEST)
                 + val_nb[n:2 * n] - val_nb[2 * n:3 * n])
    t_nonbasic = jnp.all(basis != T_ID)
    xB_exact = qr_solve(Bmat, rhs_exact)
    use_exact = (status == LEMKE_SUCCESS) & t_nonbasic & \
        jnp.all(jnp.isfinite(xB_exact))
    xB = jnp.where(use_exact, xB_exact, xB)
    # z_i = row value if z_i is basic in some row, else its nonbasic value
    in_basis = basis < n
    rowof = jnp.full(n + 1, -1, dtype=jnp.int32)
    rowof = rowof.at[jnp.where(in_basis, basis, n)].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")[:n]
    z = jnp.where(rowof >= 0, xB[jnp.clip(rowof, 0)], val[:n])
    z = jnp.where(var_mask, z, 0.0)
    k = jnp.where(init.solved_at_start, 0, k)
    return z, status, k, basis, val


def _pivot_jax(T, row, col):
    pr = T[row, :] / T[row, col]
    other = T[:, col].at[row].set(0.0)
    return (T - jnp.outer(other, pr)).at[row, :].set(pr)


def _complement_jax(exiting, val, l, u, n):
    i = exiting % n
    is_z = exiting < n
    is_u = (exiting >= n) & (exiting < 2 * n)
    at_l = jnp.abs(val[exiting] - l[i]) <= jnp.abs(val[exiting] - u[i])
    ent = jnp.where(is_z, jnp.where(at_l, n + i, 2 * n + i),
                    i)
    direction = jnp.where(is_z, 1.0, jnp.where(is_u, 1.0, -1.0))
    ev = jnp.where(is_z, 0.0, jnp.where(is_u, l[i], u[i]))
    return ent, direction, ev


def solve_lemke_batch(M, q, l, u, z0, var_mask, tol=1e-9, piv_tol=1e-11,
                      max_pivots: int = 512, synth_scale=1e4,
                      cover: str = "viol"):
    """Batched box-AVI Lemke solve.  Shapes: M (B,n,n); q/l/u/z0/mask (B,n).

    Returns ``(z, status, pivots)`` stacked over the batch.  Lanes terminate
    individually (done masks); the while_loop runs until the slowest lane
    finishes or ``max_pivots``.

    Thin view over :func:`solve_lemke_batch_state` — a separately-jitted
    copy would compile the identical vmapped pivot kernel twice per
    (shape, max_pivots) signature.
    """
    z, status, piv, _, _ = solve_lemke_batch_state(
        M, q, l, u, z0, var_mask, tol=tol, piv_tol=piv_tol,
        max_pivots=max_pivots, synth_scale=synth_scale, cover=cover)
    return z, status, piv


@functools.partial(jax.jit, static_argnames=("max_pivots", "cover"))
def solve_lemke_batch_state(M, q, l, u, z0, var_mask, tol=1e-9,
                            piv_tol=1e-11, max_pivots: int = 512,
                            synth_scale=1e4, cover: str = "viol"):
    """Like :func:`solve_lemke_batch` but also returns the terminal basis
    bookkeeping ``(basis, val)`` so the caller can refactorize the basic
    system in f64 on host (see :func:`refactor_batch_np`) — the mixed-
    precision pattern: pivot the PATH in fast f32 arithmetic, land exact
    values with one batched LAPACK solve."""
    fn = functools.partial(_lemke_single, tol=tol, piv_tol=piv_tol,
                           max_pivots=max_pivots, synth_scale=synth_scale,
                           cover=cover)
    return jax.vmap(lambda M_, q_, l_, u_, z_, vm: fn(M_, q_, l_, u_, z_,
                                                      vm))(
        M, q, l, u, z0, var_mask)


def lemke_engine(n: int, backend: str | None = None) -> str:
    """Pivot engine for a batch of n-dimensional AVIs on ``backend``.

    ``"kernel"`` (the fused Pallas pivot loop, ops/lemke_pallas.py) on the
    GPU while one lane's tableau fits one SM (``n <= LEMKE_KERNEL_MAX_N``);
    ``"xla"`` (the vmapped ``while_loop`` lane) on the CPU and for larger
    n.  ``config.lemke_kernel = "xla"`` forces the XLA route everywhere.
    """
    from ..config import CONFIG, effective_backend
    from .lemke_pallas import LEMKE_KERNEL_MAX_N
    backend = backend or effective_backend()
    if (CONFIG.lemke_kernel == "auto" and backend == "gpu"
            and n <= LEMKE_KERNEL_MAX_N):
        return "kernel"
    return "xla"


def solve_lemke_batch_state_auto(M, q, l, u, z0, var_mask, tol=1e-9,
                                 piv_tol=1e-11, max_pivots: int = 512,
                                 synth_scale=1e4, cover: str = "viol",
                                 engine: str | None = None,
                                 interpret: bool = False):
    """Engine-dispatching form of :func:`solve_lemke_batch_state`.

    ``engine`` defaults to :func:`lemke_engine`'s choice for this batch.
    ``interpret=True`` runs the kernel in the Pallas interpreter (tests
    only).  A kernel failure raises: there is no silent fallback to the
    other engine."""
    from ..utils.metrics import METRICS
    B, n = q.shape
    engine = engine or lemke_engine(n)
    kw = dict(tol=tol, piv_tol=piv_tol, max_pivots=max_pivots,
              synth_scale=synth_scale, cover=cover)
    METRICS.bump(f"lemke_{engine}_lanes", B)
    if engine == "kernel":
        from .lemke_pallas import solve_lemke_batch_state_pallas
        return solve_lemke_batch_state_pallas(M, q, l, u, z0, var_mask,
                                              interpret=interpret, **kw)
    if engine != "xla":
        raise ValueError(f"unknown Lemke engine {engine!r}")
    return solve_lemke_batch_state(M, q, l, u, z0, var_mask, **kw)


def refactor_batch_np(M, q, l, u, basis, val, var_mask):
    """Host f64 terminal refactorization for a batch of pivot outcomes.

    Rebuilds each lane's basic system from the ORIGINAL f64 data at the
    terminal complementary basis and solves it with one stacked LAPACK
    call; nonbasic z values snap to the nearest true f64 bound.  Returns
    (z, ok) — lanes with t still basic or a singular basis get ok=False.
    """
    M = np.asarray(M, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    basis = np.asarray(basis)
    val32 = np.asarray(val, dtype=np.float64)
    var_mask = np.asarray(var_mask, dtype=bool)
    B, n = q.shape
    eye = np.eye(n)
    Mm = np.where(var_mask[:, None, :] & var_mask[:, :, None], M, eye[None])
    qm = np.where(var_mask, q, 0.0)
    lm = np.where(var_mask, l, 0.0)
    um = np.where(var_mask, u, 0.0)

    # snap nonbasic z values to the true f64 bounds where they exist
    val = val32.copy()
    zval = val[:, :n]
    with np.errstate(invalid="ignore"):
        dl = np.abs(zval - np.where(np.isfinite(lm), lm, np.inf))
        du = np.abs(zval - np.where(np.isfinite(um), um, np.inf))
    snap_l = np.isfinite(lm) & ((dl <= du) | ~np.isfinite(um)) & (dl < 1e-2 * (1 + np.abs(zval)))
    snap_u = np.isfinite(um) & (du < dl) & (du < 1e-2 * (1 + np.abs(zval)))
    val[:, :n] = np.where(snap_l, lm, np.where(snap_u, um, zval))

    bz = basis < n
    bu = (basis >= n) & (basis < 2 * n)
    t_ok = np.all(basis != 3 * n, axis=1)
    # basis matrix columns: z_i -> M[:, i]; u_i -> -e_i; v_i -> +e_i
    col_idx = np.where(bz, basis, 0)
    col_z = np.take_along_axis(Mm, col_idx[:, None, :], axis=2)
    slack_idx = np.where(bu, basis - n, np.clip(basis - 2 * n, 0, n - 1))
    e_cols = (np.arange(n)[None, :, None]
              == slack_idx[:, None, :]).astype(np.float64)
    sgn = np.where(bu, -1.0, 1.0)
    Bmat = np.where(bz[:, None, :], col_z, sgn[:, None, :] * e_cols)
    nb = val.copy()
    np.put_along_axis(nb, basis, 0.0, axis=1)
    rhs = (-qm - np.einsum("bij,bj->bi", Mm, nb[:, :n])
           + nb[:, n:2 * n] - nb[:, 2 * n:3 * n])
    ok = t_ok.copy()
    xB = np.zeros((B, n))
    try:
        xB = np.linalg.solve(Bmat, rhs[..., None])[..., 0]
    except np.linalg.LinAlgError:
        for b in range(B):
            try:
                xB[b] = np.linalg.solve(Bmat[b], rhs[b])
            except np.linalg.LinAlgError:
                ok[b] = False
    bad = ~np.isfinite(xB).all(axis=1)
    ok &= ~bad
    # z_i = row value where basic, snapped nonbasic value otherwise
    z = nb[:, :n].copy()
    for b in range(B):                      # scatter basic values (small)
        sel = bz[b]
        z[b, basis[b, sel]] = xB[b, sel]
    z = np.where(var_mask, z, 0.0)
    return z, ok


def solve_lemke_batch_padded(M, q, l, u, z0, var_mask, tol=1e-9):
    """Bucket-pad batch and variable dims so ragged ensembles reuse a handful
    of compiled pivot kernels (same discipline as solve_avi_batch_padded)."""
    from ..config import bucket, CONFIG
    M = np.asarray(M, dtype=np.float64)
    B, n, _ = M.shape
    Bp = bucket(B, CONFIG.batch_buckets)
    np_ = bucket(n, CONFIG.row_buckets)
    Mp = np.zeros((Bp, np_, np_))
    Mp[:, range(np_), range(np_)] = 1.0
    Mp[:B, :n, :n] = M
    pads = []
    for a, fill in ((q, 0.0), (l, 0.0), (u, 0.0), (z0, 0.0)):
        ap = np.full((Bp, np_), fill)
        ap[:B, :n] = a
        pads.append(ap)
    mp = np.zeros((Bp, np_), dtype=bool)
    mp[:B, :n] = var_mask
    max_pivots = int(min(4096, 16 * np_ + 256))
    from ..config import small_dispatch_device
    with small_dispatch_device(Mp.size):
        z, status, piv = solve_lemke_batch(Mp, *pads, mp, tol=tol,
                                           max_pivots=max_pivots)
    return (np.asarray(z)[:B, :n], np.asarray(status)[:B],
            np.asarray(piv)[:B])


def _classify_lp_pivot(c, x, Ax, l, u, resid, status, tol, row_mask=None):
    """Shared trust-ladder classification for both LP pivot routes.

    Only certificates we can trust: SOLVED needs the audited natural
    residual; DUAL_INFEASIBLE (unbounded) needs a primal-feasible point
    pressed far into the synthetic box with a correspondingly huge
    objective.  Everything else — including apparent primal violation,
    which may just be pivot-path numerical degradation — is MAX_ITER and
    falls back to the ADMM engine with its certificates.

    NaN violations (inf-cancellation on a garbage fallback point) map to
    +inf so they FAIL the feasibility gate: a positive certificate must
    never be granted on an unverifiable point."""
    from . import batch_qp
    with np.errstate(invalid="ignore"):
        viol = np.maximum(np.maximum(
            np.where(np.isfinite(l), l, -_INF) - Ax,
            Ax - np.where(np.isfinite(u), u, _INF)), 0.0)
    viol = np.nan_to_num(viol, nan=np.inf, posinf=np.inf)
    if row_mask is not None:
        viol = np.where(row_mask, viol, 0.0)
    pviol = viol.max(axis=1, initial=0.0)
    clean = status == LEMKE_SUCCESS
    solved = clean & (resid <= tol)
    obj = np.einsum("bn,bn->b", c, x)
    huge = 1e3 * (1.0 + np.abs(np.where(np.isfinite(l), l, 0.0)).max(
        axis=1, initial=0.0)
        + np.abs(np.where(np.isfinite(u), u, 0.0)).max(axis=1, initial=0.0)
        + np.abs(c).sum(axis=1))
    unbounded = clean & ~solved & (pviol <= 1e-6) & (obj < -huge)
    st = np.where(solved, batch_qp.SOLVED,
                  np.where(unbounded, batch_qp.DUAL_INFEASIBLE,
                           batch_qp.MAX_ITER)).astype(np.int32)
    return st, pviol, obj


def solve_lp_host_batch(c, A, l, u, row_mask, *, tol=1e-7,
                        _no_broker=False):
    """Native exact-shape pivot solve for a batch of small dense LPs.

    Same KKT-AVI formulation and status discipline as
    :func:`solve_lp_lemke_batch`, but executed by the C++ port of the host
    pivot oracle (utils/native.lemke_batch) on EXACT shapes: no bucket
    padding (the jit route pads N = n+2m up ~2.5x, squaring per-pivot
    cost) and no per-iteration dispatch overhead.  For the ≤64-row LPs
    behind geometry support/emptiness queries each solve is ~0.1-1 ms —
    two orders below the batched first-order kernel on CPU.  Lanes whose
    pivot run is uncertified fall back to the ADMM engine.  Returns a
    batch_qp.QPSolution, or None when the native library is unavailable.
    """
    from . import batch_qp
    from ..utils import native
    from ..utils.metrics import METRICS
    if not native.native_available():
        return None
    if not _no_broker:
        # Under a lockstep broker the geometry LPs — the dominant kernel
        # class when support/empty engines are "host" — park and fuse with
        # other scenarios' requests into one OpenMP batch, instead of N
        # concurrent native calls oversubscribing the host cores
        from ..parallel.lockstep import active_broker
        br = active_broker()
        if br is not None:
            return br.submit("lp_host", c, A, l, u, row_mask, tol=tol)
    c = np.asarray(c, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    row_mask = np.asarray(row_mask, dtype=bool)
    B0, m0, n0 = A.shape
    x = np.zeros((B0, n0))
    y = np.zeros((B0, m0))
    obj = np.zeros(B0)
    st = np.full(B0, batch_qp.MAX_ITER, dtype=np.int32)
    piv = np.zeros(B0, dtype=np.int64)
    pviol_out = np.zeros(B0)
    resid_out = np.zeros(B0)
    acts = [np.nonzero(row_mask[b])[0] for b in range(B0)]
    groups: dict = {}
    for b in range(B0):
        groups.setdefault(len(acts[b]), []).append(b)
    for m, idxs in groups.items():
        k = len(idxs)
        N = n0 + 2 * m
        act = np.stack([acts[b] for b in idxs])            # (k, m)
        Ab = np.take_along_axis(A[idxs], act[:, :, None], axis=1)
        lb = np.take_along_axis(l[idxs], act, axis=1)
        ub = np.take_along_axis(u[idxs], act, axis=1)
        M = np.zeros((k, N, N))
        M[:, :n0, n0:n0 + m] = -Ab.transpose(0, 2, 1)
        M[:, n0:n0 + m, :n0] = Ab
        if m:
            M[:, n0:n0 + m, n0 + m:] = -np.eye(m)[None]
            M[:, n0 + m:, n0:n0 + m] = np.eye(m)[None]
        q = np.concatenate([c[idxs], np.zeros((k, 2 * m))], axis=1)
        lA = np.concatenate([np.full((k, n0 + m), -_INF), lb], axis=1)
        uA = np.concatenate([np.full((k, n0 + m), _INF), ub], axis=1)
        out = native.lemke_batch(M, q, lA, uA, tol=1e-11,
                                 max_pivots=max(400, 20 * N))
        z, stg, pg = out
        xg = z[:, :n0]
        lam = z[:, n0:n0 + m]
        # audit: natural residual of the TRUE (un-boxed) KKT AVI
        F = np.einsum("bij,bj->bi", M, z) + q
        with np.errstate(invalid="ignore"):
            proj = np.clip(z - F, lA, uA)
        resid = np.abs(z - proj).max(axis=1, initial=0.0)
        Ax = np.einsum("bmn,bn->bm", Ab, xg)
        # NOTE the resid audit here is unmasked (exact shapes on the host
        # route: every row is real), while the bucketed route masks by vm
        stl, pviol, obj_g = _classify_lp_pivot(c[idxs], xg, Ax, lb, ub,
                                               resid, stg, tol)
        bidx = np.asarray(idxs)
        x[bidx] = xg
        y_tmp = np.zeros((k, m0))
        np.put_along_axis(y_tmp, act, -lam, axis=1)
        y[bidx] = y_tmp
        obj[bidx] = obj_g
        st[bidx] = stl
        piv[bidx] = pg
        pviol_out[bidx] = pviol
        resid_out[bidx] = resid
    METRICS.bump("lp_host", B0)
    bad = st == batch_qp.MAX_ITER
    zproj = np.einsum("bmn,bn->bm", A, x)
    with np.errstate(invalid="ignore"):
        zproj = np.clip(zproj, np.where(np.isfinite(l), l, -1e20),
                        np.where(np.isfinite(u), u, 1e20))
    if bad.any():
        METRICS.bump("lp_host_fallback", int(bad.sum()))
        idx = np.nonzero(bad)[0]
        P0 = np.zeros((len(idx), n0, n0))
        sol = jax.device_get(batch_qp.solve_qp_batch_padded(
            P0, c[idx], A[idx], l[idx], u[idx], row_mask[idx],
            _no_lemke=True))
        x[idx] = np.asarray(sol.x)
        y[idx] = np.asarray(sol.y)
        zproj[idx] = np.asarray(sol.z)
        obj[idx] = np.asarray(sol.obj)
        st[idx] = np.asarray(sol.status)
    return batch_qp.QPSolution(x=x, y=y, z=zproj, obj=obj, status=st,
                               prim_res=pviol_out, dual_res=resid_out,
                               iters=piv)


def solve_lp_lemke_batch(c, A, l, u, row_mask, *, tol=1e-7,
                         max_pivots=None, _sharding=None, _min_batch=1):
    """Exact batched LP solve by complementary pivoting on the LP's KKT AVI.

    ``min c'x  s.t.  l ≤ A x ≤ u`` (variables free; bounds live in rows —
    the shape of every support / emptiness / membership LP in the geometry
    kernel).  The KKT system is the box AVI over ``z = [x; λ; s]``::

        rows x (free):  c − A'λ = 0
        rows λ (free):  A x − s = 0
        rows s:         λ  ⟂  l ≤ s ≤ u

    Pivoting terminates on an exact complementary basis in tens of pivots —
    versus thousands of ADMM iterations for the same small dense LP — and the
    duals come out exact.  Returns a batch_qp.QPSolution (same field/sign
    conventions: ``y = −λ``, so y>0 pushes on the upper bound).

    Status classification from the big-M pivot output (exactly THREE
    statuses — see _classify_lp_pivot): a certified natural residual ⇒
    SOLVED; else a primal-feasible point pressed into the synthetic box ⇒
    DUAL_INFEASIBLE (unbounded); EVERYTHING else — including apparently
    infeasible lanes, whose violation may just be pivot-path degradation —
    is MAX_ITER and falls back to the ADMM engine, which owns the
    PRIMAL_INFEASIBLE certificates.
    """
    from . import batch_qp
    from ..config import bucket, CONFIG
    c = np.asarray(c, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    row_mask = np.asarray(row_mask, dtype=bool)
    B0_, m0, n0 = A.shape
    # bucket every axis so ragged LP batches share a handful of compiled
    # pivot kernels; padded variables/rows are masked off inside the AVI
    B = bucket(max(B0_, _min_batch),
               CONFIG.batch_buckets)
    m = bucket(max(m0, 1), CONFIG.row_buckets)
    n = bucket(max(n0, 1), CONFIG.dim_buckets)
    Ap = np.zeros((B, m, n))
    Ap[:B0_, :m0, :n0] = A
    cp = np.zeros((B, n))
    cp[:B0_, :n0] = c
    lp_ = np.full((B, m), -_INF)
    up_ = np.full((B, m), _INF)
    lp_[:B0_, :m0] = l
    up_[:B0_, :m0] = u
    rm = np.zeros((B, m), dtype=bool)
    rm[:B0_, :m0] = row_mask
    xm = np.zeros((B, n), dtype=bool)
    xm[:, :n0] = True
    A, c, l, u, row_mask = Ap, cp, lp_, up_, rm

    N = n + 2 * m
    eye_m = np.eye(m)
    M = np.zeros((B, N, N))
    M[:, :n, n:n + m] = -A.transpose(0, 2, 1)
    M[:, n:n + m, :n] = A
    M[:, n:n + m, n + m:] = -eye_m[None]
    M[:, n + m:, n:n + m] = eye_m[None]
    q = np.concatenate([c, np.zeros((B, 2 * m))], axis=1)
    lA = np.concatenate([np.full((B, n), -_INF), np.full((B, m), -_INF),
                         np.where(row_mask, l, 0.0)], axis=1)
    uA = np.concatenate([np.full((B, n), _INF), np.full((B, m), _INF),
                         np.where(row_mask, u, 0.0)], axis=1)
    vm = np.concatenate([xm, row_mask, row_mask], axis=1)
    if max_pivots is None:
        max_pivots = 256
        while max_pivots < min(4096, 12 * N + 128):
            max_pivots *= 2
    args = (M, q, lA, uA, np.zeros((B, N)), vm)
    if _sharding is not None:
        args = tuple(jax.device_put(a, _sharding) for a in args)
    # one pipelined device_get (serial np.asarray fetches pay one device
    # round-trip each)
    z, status, piv = (np.asarray(a) for a in jax.device_get(
        solve_lemke_batch(*args, tol=1e-11, max_pivots=max_pivots)))

    x = z[:, :n]
    lam = np.where(row_mask, z[:, n:n + m], 0.0)
    F = np.einsum("bij,bj->bi", M, z) + q
    with np.errstate(invalid="ignore"):
        proj = np.clip(z - F, lA, uA)
    resid = np.abs(np.where(vm, z - proj, 0.0)).max(axis=1, initial=0.0)
    Ax = np.einsum("bmn,bn->bm", A, x)
    st, pviol, obj_raw = _classify_lp_pivot(c, x, Ax, l, u, resid, status,
                                            tol, row_mask=row_mask)
    # unpad to caller shapes (as writable copies), then fall back on
    # unresolved lanes
    from ..utils.metrics import METRICS
    x = np.array(x[:B0_, :n0])
    y = np.array(-lam[:B0_, :m0])
    st = np.array(st[:B0_])
    piv = np.array(piv[:B0_])
    pviol = np.array(pviol[:B0_])
    resid = np.array(resid[:B0_])
    obj = np.einsum("bn,bn->b", c[:B0_, :n0], x)
    zproj = np.clip(Ax[:B0_, :m0],
                    np.where(np.isfinite(l[:B0_, :m0]), l[:B0_, :m0], -1e20),
                    np.where(np.isfinite(u[:B0_, :m0]), u[:B0_, :m0], 1e20))
    bad = st == batch_qp.MAX_ITER
    METRICS.bump("lp_lemke", B0_)
    if bad.any():
        METRICS.bump("lp_lemke_fallback", int(bad.sum()))
        idx = np.nonzero(bad)[0]
        P0 = np.zeros((len(idx), n0, n0))
        sol = batch_qp.solve_qp_batch_padded(
            P0, c[idx, :n0], A[idx][:, :m0, :n0], l[idx, :m0], u[idx, :m0],
            row_mask[idx, :m0], _no_lemke=True)
        x[idx] = np.asarray(sol.x)
        y[idx] = np.asarray(sol.y)
        zproj[idx] = np.asarray(sol.z)
        obj[idx] = np.asarray(sol.obj)
        st[idx] = np.asarray(sol.status)
    return batch_qp.QPSolution(
        x=x, y=y, z=zproj, obj=obj, status=st,
        prim_res=pviol, dual_res=resid, iters=piv)


def lemke_escalate(M, q, l, u, z0, var_mask, *, tol=1e-10,
                   deltas=(0.0, 1e-7, 1e-4), rounds=2):
    """Proximal-Lemke escalation tier for stubborn AVI lanes.

    For each lane still above ``tol``: pivot on ``(M + δI, q − δ z_ref)`` for
    an escalating δ schedule (δ=0 is the raw problem; positive δ makes the
    subproblem strongly monotone so Lemke processes it without rays and with a
    nonsingular start basis), Newton-polish the pivot solution on the TRUE
    problem, and accept whatever lowers the natural residual.  A second round
    re-centers ``z_ref`` at the incumbent — the proximal-point iteration that
    converges for monotone problems.  Returns ``(z, resid)`` arrays.
    """
    from .avi import natural_residual_np, solve_avi_batch_polish
    M = np.asarray(M, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    z0 = np.asarray(z0, dtype=np.float64)
    var_mask = np.asarray(var_mask, dtype=bool)
    B, n = q.shape
    eye = np.eye(n)
    z_best = z0.copy()
    r_best = natural_residual_np(M, q, l, u, z0, var_mask)
    z_ref = z0.copy()
    for _ in range(rounds):
        for delta in deltas:
            idx = np.nonzero(r_best > tol)[0]
            if len(idx) == 0:
                return z_best, r_best
            Md = M[idx] + delta * eye[None, :, :]
            qd = q[idx] - delta * z_ref[idx]
            z_piv, status, _ = solve_lemke_batch_padded(
                Md, qd, l[idx], u[idx], z_ref[idx], var_mask[idx],
                tol=max(tol, 1e-11))
            # polish the pivot solution on the unregularized problem
            res = solve_avi_batch_polish(
                M[idx], q[idx], l[idx], u[idx], z_piv, var_mask[idx],
                tol=tol, max_iter=40)
            z_new = np.asarray(res.z)
            r_new = natural_residual_np(M[idx], q[idx], l[idx], u[idx],
                                        z_new, var_mask[idx])
            # the raw pivot output may itself be the better point
            r_piv = natural_residual_np(M[idx], q[idx], l[idx], u[idx],
                                        z_piv, var_mask[idx])
            use_piv = r_piv < r_new
            z_new = np.where(use_piv[:, None], z_piv, z_new)
            r_new = np.minimum(r_new, r_piv)
            better = r_new < r_best[idx]
            z_best[idx[better]] = z_new[better]
            r_best[idx[better]] = r_new[better]
        z_ref = z_best.copy()
    return z_best, r_best
