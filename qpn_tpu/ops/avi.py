"""Batched AVI / GAVI solver — the accelerator stand-in for the PATH solver.

The reference hands every equilibrium subproblem to the commercial PATH
pivoting code through ``PATHSolver.solve_mcp`` (avi.jl:63-77) at convergence
tolerance 1e-10.  Here the same box mixed complementarity problem

    find z :  M z + q ⟂ l ≤ z ≤ u        (componentwise)

is solved by a *semismooth Newton method on the natural residual*

    Φ(z) = z − clip(z − (Mz + q), l, u)

which for affine F is an active-set Newton iteration: each step solves the
linear system  ``J dz = −Φ`` with ``J = D M + (I − D)`` (D = diag of rows whose
projection is strictly inside the box), globalized by an Armijo line search on
``½‖Φ‖²`` plus a damped projection step ``z ← clip(z − γ(Mz+q), l, u)`` as an
escape hatch when Newton stalls.  Everything is fixed-shape jax (while_loop +
masking), so thousands of AVIs solve as one vmapped kernel — this is the
"batched AVI-piece throughput" axis of the benchmark.

GAVI structures and the slack-augmentation conversion mirror avi.jl:18-39 and
avi.jl:113-128; the post-hoc solution audit mirrors check_avi_solution
(avi.jl:148-156).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .linalg import ridge_solve
from . import batch_qp

_BIG = 1e20


class Status(enum.IntEnum):  # avi.jl:1-6
    SUCCESS = 1
    RAY_TERM = 2
    MAX_ITERS = 3
    FAILURE = 4


@dataclasses.dataclass
class AVI:
    """``Mz + Nw + o ⟂ l ≤ z ≤ u`` (avi.jl:10-16). Host-side numpy struct."""
    M: np.ndarray
    N: np.ndarray
    o: np.ndarray
    l: np.ndarray
    u: np.ndarray


@dataclasses.dataclass
class GAVI:
    """Generalized AVI, two condition blocks (avi.jl:18-39)::

        (M z + N w + o) ⟂ (l1 ≤ z1 ≤ u1)
        (      z2     ) ⟂ (l2 ≤ A z + B w ≤ u2),   z = [z1; z2]
    """
    M: np.ndarray
    N: np.ndarray
    o: np.ndarray
    l1: np.ndarray
    u1: np.ndarray
    A: np.ndarray
    B: np.ndarray
    l2: np.ndarray
    u2: np.ndarray

    @property
    def d1(self):
        return len(self.l1)

    @property
    def d2(self):
        return len(self.l2)


@dataclasses.dataclass
class GLCP:
    """General linear complementarity problem ``Mz + q ⟂ l ≤ Az ≤ u``
    (avi.jl:41-53; defined-but-unused in the reference, kept for API parity —
    z need not match the dimension of q/l/u)."""
    M: np.ndarray
    q: np.ndarray
    A: np.ndarray
    l: np.ndarray
    u: np.ndarray


def convert_gavi(gavi: GAVI) -> AVI:
    """Slack augmentation GAVI → box AVI (avi.jl:113-128).

    AVI unknowns ``[z1; z2; s]`` with rows::

        [M   0] z            ⟂ l1 ≤ z1 ≤ u1
        [A  -I] z + B w      = 0          (z2 rows: free s defn)
        [0 I 0] z            ⟂ l2 ≤ s ≤ u2
    """
    d1, d2 = gavi.d1, gavi.d2
    m = gavi.N.shape[1]
    M = np.zeros((d1 + 2 * d2, d1 + 2 * d2))
    M[:d1, :d1 + d2] = gavi.M
    M[d1:d1 + d2, :d1 + d2] = gavi.A
    M[d1:d1 + d2, d1 + d2:] = -np.eye(d2)
    M[d1 + d2:, d1:d1 + d2] = np.eye(d2)
    N = np.vstack([gavi.N, gavi.B, np.zeros((d2, m))])
    o = np.concatenate([gavi.o, np.zeros(d2), np.zeros(d2)])
    l = np.concatenate([gavi.l1, np.full(d2, -np.inf), gavi.l2])
    u = np.concatenate([gavi.u1, np.full(d2, np.inf), gavi.u2])
    return AVI(M, N, o, l, u)


# --------------------------------------------------------------------------
#  Core batched kernel
# --------------------------------------------------------------------------

class AVIResult(NamedTuple):
    z: jax.Array
    resid: jax.Array     # ‖Φ(z)‖∞
    iters: jax.Array
    converged: jax.Array


def _natural_residual(M, q, l, u, z):
    F = M @ z + q
    s = z - F
    proj = jnp.clip(s, l, u)
    return z - proj, F, s


def natural_residual_np(M, q, l, u, z, var_mask=None):
    """Batched ‖Φ‖∞ on host numpy (B, n) → (B,)."""
    M = np.asarray(M)
    z = np.asarray(z)
    F = np.einsum("bij,bj->bi", M, z) + np.asarray(q)
    with np.errstate(invalid="ignore"):
        proj = np.clip(z - F, np.asarray(l), np.asarray(u))
    Phi = z - proj
    if var_mask is not None:
        Phi = np.where(np.asarray(var_mask), Phi, 0.0)
    return np.abs(Phi).max(axis=1)


def _newton_solve(M, q, l, u, z0, *, tol, max_iter, var_mask):
    """Single-instance hybrid semismooth-Newton / extragradient solver.

    Semismooth Newton on the natural residual converges superlinearly near a
    solution but can stall on merely-monotone problems — LP KKT systems give
    skew-symmetric M with singular active-set Jacobians, exactly the systems
    the reference feeds to PATH.  Korpelevich's extragradient method

        z½ = Π(z − τ F(z)),  z⁺ = Π(z − τ F(z½)),   τ < 1/L

    is globally convergent for monotone Lipschitz F, but only linearly.  The
    solver therefore alternates: a Newton phase (fast, Armijo-guarded, exits
    on stall) and an unconditional extragradient sweep that walks out of the
    stall basin; the best natural-residual iterate is tracked across phases.
    All phases are fixed-shape jax, vmappable.

    ``var_mask`` marks real (non-padded) variables; padded vars are pinned to
    0 (row = identity, l=u=0)."""
    n = q.shape[0]
    dt = q.dtype
    l = jnp.where(var_mask, l, 0.0)
    u = jnp.where(var_mask, u, 0.0)
    eye = jnp.eye(n, dtype=dt)
    M0 = jnp.where(var_mask[:, None] & var_mask[None, :], M, eye)
    q0 = jnp.where(var_mask, q, 0.0)

    # ---- complementarity-preserving Ruiz equilibration -------------------
    # Row i scaled by d_i>0, variable i by e_i>0: M' = D M E, q' = D q,
    # bounds scale by 1/e — complementarity of (row i, z_i) is preserved for
    # any positive diagonals.  Balancing fixes the 1..10^k row spreads that
    # cripple both the Newton conditioning and the extragradient step size.
    def ruiz(M):
        def body(i, de):
            d, e = de
            Ms = jnp.abs(d[:, None] * M * e[None, :])
            r = jnp.max(Ms, axis=1)
            c = jnp.max(Ms, axis=0)
            d = d / jnp.sqrt(jnp.clip(r, 1e-8, 1e8))
            e = e / jnp.sqrt(jnp.clip(c, 1e-8, 1e8))
            return d, e
        return jax.lax.fori_loop(0, 8, body,
                                 (jnp.ones(n, dtype=dt), jnp.ones(n, dtype=dt)))

    d_sc, e_sc = ruiz(M0)
    Mm = d_sc[:, None] * M0 * e_sc[None, :]
    qm = d_sc * q0
    ls = jnp.where(jnp.isfinite(l), l / e_sc, l)
    us = jnp.where(jnp.isfinite(u), u / e_sc, u)
    l, u = ls, us
    # extragradient step: τ ≤ 0.9 / L with L ≈ ‖M‖_∞ (cheap Lipschitz bound)
    tau = 0.9 / (1.0 + jnp.linalg.norm(Mm, ord=jnp.inf))

    def merit_for(Mx, qx, z):
        F = Mx @ z + qx
        Phi = z - jnp.clip(z - F, l, u)
        return 0.5 * jnp.dot(Phi, Phi), Phi

    tol_m = 0.5 * tol * tol

    def newton_phase(Mx, qx, z, iters_left, stall_limit=3):
        """Semismooth Newton with batched-Armijo line search on (Mx, qx)."""
        def body(state):
            k, z, stall, best_z, best_m = state
            m0, Phi = merit_for(Mx, qx, z)
            F = Mx @ z + qx
            s = z - F
            free = (s > l) & (s < u)
            D = free.astype(dt)
            J = D[:, None] * Mx + (1.0 - D)[:, None] * eye
            # ridge handles singular active-set Jacobians (ξ-consensus rows,
            # avi.jl:356-369, and LP blocks)
            dz = ridge_solve(J, -Phi, 1e-12)
            ts = 0.5 ** jnp.arange(16, dtype=dt)
            Ztry = z[None, :] + ts[:, None] * dz[None, :]
            Ftry = Ztry @ Mx.T + qx[None, :]
            Phitry = Ztry - jnp.clip(Ztry - Ftry, l[None, :], u[None, :])
            mtry = 0.5 * jnp.sum(Phitry * Phitry, axis=1)
            ok = mtry <= (1.0 - 1e-4 * ts) * m0
            accepted = jnp.any(ok)
            first = jnp.argmax(ok)
            z_next = jnp.where(accepted, Ztry[first], z)
            stall = jnp.where(accepted, 0, stall + 1)
            m_next, _ = merit_for(Mx, qx, z_next)
            best_z = jnp.where(m_next < best_m, z_next, best_z)
            best_m = jnp.minimum(m_next, best_m)
            return k + 1, z_next, stall, best_z, best_m

        def cond(state):
            k, _, stall, _, best_m = state
            return (k < iters_left) & (best_m > tol_m) & (stall < stall_limit)

        m0, _ = merit_for(Mx, qx, z)
        k, z, _, best_z, best_m = jax.lax.while_loop(
            cond, body, (jnp.int32(0), z, jnp.int32(0), z, m0))
        return best_z, best_m, k

    def eg_phase(z, num_steps):
        """Korpelevich extragradient on the original (scaled) problem —
        globally convergent for monotone M, used as a basin hop."""
        def body(i, state):
            z, best_z, best_m = state
            F = Mm @ z + qm
            z_half = jnp.clip(z - tau * F, l, u)
            F_half = Mm @ z_half + qm
            z_new = jnp.clip(z - tau * F_half, l, u)
            m_new, _ = merit_for(Mm, qm, z_new)
            best_z = jnp.where(m_new < best_m, z_new, best_z)
            best_m = jnp.minimum(m_new, best_m)
            return z_new, best_z, best_m

        m0, _ = merit_for(Mm, qm, z)
        z, best_z, best_m = jax.lax.fori_loop(0, num_steps, body, (z, z, m0))
        return z, best_z, best_m

    z0 = jnp.clip(jnp.where(var_mask, z0 / e_sc, 0.0), l, u)
    m_init, _ = merit_for(Mm, qm, z0)

    # round = proximal step + polish + EG hop.  The proximal subproblem
    #   (M + δI) z + (q − δ z_ref)  ⟂  l ≤ z ≤ u
    # is strongly monotone (Newton cracks it even for skew LP-KKT blocks);
    # iterating z_ref is the proximal-point algorithm, convergent for any
    # monotone M; δ shrinks geometrically for a superlinear tail.
    round_cost = 40 + 30 + 60
    max_rounds = jnp.maximum(2, max_iter // round_cost).astype(jnp.int32)

    def round_body(state):
        r, z, z_ref, delta, best_z, best_m, total_k = state
        pz, _, k1 = newton_phase(Mm + delta * eye, qm - delta * z_ref, z, 40)
        # polish on the true problem from the proximal iterate
        qz, qmer, k2 = newton_phase(Mm, qm, pz, 30)
        best_z = jnp.where(qmer < best_m, qz, best_z)
        best_m = jnp.minimum(qmer, best_m)
        # EG hop to escape repeated basins (cheap matvecs)
        ez, ebz, ebm = eg_phase(qz, 60)
        best_z = jnp.where(ebm < best_m, ebz, best_z)
        best_m = jnp.minimum(ebm, best_m)
        z_next = jnp.where(best_m <= tol_m, best_z, ez)
        delta = jnp.maximum(delta * 0.25, 1e-12)
        return (r + 1, z_next, pz, delta, best_z, best_m,
                total_k + k1 + k2 + 60)

    def round_cond(state):
        r, _, _, _, _, best_m, _ = state
        return (r < max_rounds) & (best_m > tol_m)

    state = (jnp.int32(0), z0, z0, jnp.asarray(1e-2, dtype=dt), z0, m_init,
             jnp.int32(0))
    _, _, _, _, best_z, best_m, total_k = jax.lax.while_loop(
        round_cond, round_body, state)

    # final Newton polish from the overall best iterate
    pz, pm, pk = newton_phase(Mm, qm, best_z, 30)
    best_z = jnp.where(pm < best_m, pz, best_z)

    # report the residual of the UNSCALED problem
    z_out = e_sc * best_z
    Phi, _, _ = _natural_residual(M0, q0, ls * e_sc, us * e_sc, z_out)
    resid = jnp.max(jnp.abs(Phi), initial=0.0)
    return AVIResult(z=z_out, resid=resid, iters=total_k + pk,
                     converged=resid <= tol)


@jax.jit
def solve_avi_batch(M, q, l, u, z0, var_mask, tol=1e-10, max_iter=4000):
    """Batched box-AVI solve.  M (B,n,n), q/l/u/z0 (B,n), var_mask (B,n).

    ``tol`` and ``max_iter`` are traced scalars — every budget/tolerance
    combination shares ONE compiled kernel per shape."""
    fn = functools.partial(_newton_solve, tol=tol, max_iter=max_iter)
    return jax.vmap(lambda M_, q_, l_, u_, z_, vm: fn(M_, q_, l_, u_, z_,
                                                      var_mask=vm))(
        M, q, l, u, z0, var_mask)


@jax.jit
def solve_avi_batch_mixed(M, q, l, u, z0, var_mask, tol=1e-10,
                          max_iter=4000):
    """Mixed-precision batched solve: the bulk of the hybrid Newton/proximal
    iteration runs in f32 (several times the f64 rate on an accelerator),
    then a short f64 Newton polish drives the natural residual to the
    PATH-parity tolerance.  The polish warm-starts at the f32 solution, so it
    typically needs 1–3 active-set-exact steps."""
    f32 = functools.partial(jnp.asarray, dtype=jnp.float32)
    fn32 = functools.partial(_newton_solve, tol=1e-5, max_iter=max_iter)
    res32 = jax.vmap(lambda M_, q_, l_, u_, z_, vm: fn32(
        M_, q_, l_, u_, z_, var_mask=vm))(
        f32(M), f32(q), f32(l), f32(u), f32(z0), var_mask)
    z1 = res32.z.astype(M.dtype)
    fn64 = functools.partial(_newton_solve, tol=tol,
                             max_iter=jnp.maximum(520, max_iter // 8))
    res = jax.vmap(lambda M_, q_, l_, u_, z_, vm: fn64(
        M_, q_, l_, u_, z_, var_mask=vm))(M, q, l, u, z1, var_mask)
    return res


def solve_avi_batch_adaptive(M, q, l, u, z0, var_mask, *, tol=1e-10,
                             budgets=(390, 1560, 6000), mixed=True):
    """Straggler-decoupled batched solve.

    A vmapped while_loop runs until the SLOWEST lane finishes, so one hard
    LP-KKT instance stalls thousands of easy ones.  This wrapper runs the
    batch in escalating iteration budgets: most lanes converge in the cheap
    first pass; only the shrinking unconverged subset pays for the big
    budgets.  Subsets are bucket-padded so the recompile count stays bounded.
    """
    M = np.asarray(M, dtype=np.float64)
    B, n, _ = M.shape
    from ..config import small_dispatch_device
    with small_dispatch_device(M.size):
        return _solve_avi_batch_adaptive_impl(
            M, q, l, u, z0, var_mask, tol=tol, budgets=budgets, mixed=mixed)


def _solve_avi_batch_adaptive_impl(M, q, l, u, z0, var_mask, *, tol,
                                   budgets, mixed):
    B, n, _ = M.shape
    solver = solve_avi_batch_mixed if mixed else solve_avi_batch
    z_out = np.array(z0, dtype=np.float64, copy=True)
    resid_out = np.full(B, np.inf)
    iters_out = np.zeros(B, dtype=np.int64)
    conv_out = np.zeros(B, dtype=bool)
    idx = np.arange(B)
    z_cur = np.asarray(z0, dtype=np.float64)
    z_warm = z_out      # seed for the NEXT stage; may hold neighbor copies
    for bi, budget in enumerate(budgets):
        if len(idx) == 0:
            break
        sub = (M[idx], np.asarray(q)[idx], np.asarray(l)[idx],
               np.asarray(u)[idx], z_cur[idx] if bi == 0 else z_warm[idx],
               np.asarray(var_mask)[idx])
        from ..config import bucket, CONFIG
        Bp = bucket(len(idx), CONFIG.batch_buckets)
        pad = Bp - len(idx)
        padded = [np.concatenate([s, np.repeat(s[:1], pad, axis=0)], axis=0)
                  if pad else s for s in sub]
        res = jax.device_get(solver(*padded, tol=tol, max_iter=budget))
        z_i = np.asarray(res.z)[:len(idx)]
        r_i = np.asarray(res.resid)[:len(idx)]
        c_i = np.asarray(res.converged)[:len(idx)]
        k_i = np.asarray(res.iters)[:len(idx)]
        # keep a stage's result only where it improves the stored residual:
        # a straggler reseeded from a neighbor can DIVERGE in a later stage,
        # and an unconditional overwrite would discard its earlier best
        # (resid_out starts at inf, so stage 0 always lands)
        upd = r_i < resid_out[idx]
        z_out[idx[upd]] = z_i[upd]
        resid_out[idx[upd]] = r_i[upd]
        conv_out[idx] = c_i
        iters_out[idx] += k_i
        idx = idx[~c_i]
        # cross-lane warm start: scenario ensembles are perturbations of each
        # other, so seed each straggler from the nearest (by q-distance)
        # converged lane's solution before the next budget stage.  The seed
        # rides in a SEPARATE array: overwriting z_out would pair a lane's
        # returned z with a residual measured on a different iterate (and
        # discard its own best iterate).
        z_warm = z_out
        if len(idx) and conv_out.any():
            conv_idx = np.nonzero(conv_out)[0]
            qs = np.asarray(q)
            z_warm = z_out.copy()
            for i in idx:
                j = conv_idx[np.argmin(
                    np.linalg.norm(qs[conv_idx] - qs[i], axis=1))]
                if resid_out[i] > 1e-4:
                    z_warm[i] = z_out[j]
    if len(idx):
        # final escalation tier: proximal Lemke pivoting on the stragglers —
        # terminates exactly on a complementary basis where the smooth hybrid
        # chases residuals (the PATH reliability class, avi.jl:63-77)
        from .lemke import lemke_escalate
        zL, rL = lemke_escalate(
            M[idx], np.asarray(q)[idx], np.asarray(l)[idx],
            np.asarray(u)[idx], z_warm[idx], np.asarray(var_mask)[idx],
            tol=tol)
        better = rL < resid_out[idx]
        z_out[idx[better]] = zL[better]
        resid_out[idx[better]] = rL[better]
        conv_out[idx] = resid_out[idx] <= tol
    return AVIResult(z=z_out, resid=resid_out, iters=iters_out,
                     converged=conv_out)


def _newton_polish_only(M, q, l, u, z0, var_mask, tol, max_iter):
    """Plain semismooth-Newton polish (no proximal/EG rounds) — for warm
    starts already near the solution, where the full hybrid round structure
    wastes ~130 fixed iterations per lane."""
    n = q.shape[0]
    dt = q.dtype
    l = jnp.where(var_mask, l, 0.0)
    u = jnp.where(var_mask, u, 0.0)
    eye = jnp.eye(n, dtype=dt)
    Mm = jnp.where(var_mask[:, None] & var_mask[None, :], M, eye)
    qm = jnp.where(var_mask, q, 0.0)
    tol_m = 0.5 * tol * tol

    def merit(z):
        Phi, _, _ = _natural_residual(Mm, qm, l, u, z)
        return 0.5 * jnp.dot(Phi, Phi), Phi

    def body(state):
        k, z, stall, best_z, best_m = state
        m0, Phi = merit(z)
        F = Mm @ z + qm
        s = z - F
        free = (s > l) & (s < u)
        D = free.astype(dt)
        J = D[:, None] * Mm + (1.0 - D)[:, None] * eye
        dz = ridge_solve(J, -Phi, 1e-12)
        ts = 0.5 ** jnp.arange(8, dtype=dt)
        Ztry = z[None, :] + ts[:, None] * dz[None, :]
        Ftry = Ztry @ Mm.T + qm[None, :]
        Phitry = Ztry - jnp.clip(Ztry - Ftry, l[None, :], u[None, :])
        mtry = 0.5 * jnp.sum(Phitry * Phitry, axis=1)
        ok = mtry <= (1.0 - 1e-4 * ts) * m0
        accepted = jnp.any(ok)
        z_next = jnp.where(accepted, Ztry[jnp.argmax(ok)], z)
        stall = jnp.where(accepted, 0, stall + 1)
        m_next, _ = merit(z_next)
        best_z = jnp.where(m_next < best_m, z_next, best_z)
        best_m = jnp.minimum(m_next, best_m)
        return k + 1, z_next, stall, best_z, best_m

    def cond(state):
        k, _, stall, _, best_m = state
        return (k < max_iter) & (best_m > tol_m) & (stall < 4)

    z0 = jnp.where(var_mask, z0, 0.0)
    m0, _ = merit(z0)
    k, _, _, best_z, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), z0, jnp.int32(0), z0, m0))
    Phi, _, _ = _natural_residual(Mm, qm, l, u, best_z)
    resid = jnp.max(jnp.abs(Phi), initial=0.0)
    return AVIResult(z=best_z, resid=resid, iters=k, converged=resid <= tol)


@jax.jit
def solve_avi_batch_polish(M, q, l, u, z0, var_mask, tol=1e-10, max_iter=60):
    return jax.vmap(lambda M_, q_, l_, u_, z_, vm: _newton_polish_only(
        M_, q_, l_, u_, z_, vm, tol, max_iter))(M, q, l, u, z0, var_mask)


def _shared_min_n():
    from ..config import CONFIG
    return CONFIG.shared_kkt_min_n


def solve_kkt_avi_batch(M, q, l, u, var_mask, structure, tol=1e-10,
                        qp_dtype=None, method: str = "lemke"):
    """Structured solve for stacked-KKT AVIs.

    Primary route (``method="lemke"``): batched complementary pivoting on the
    KKT AVI directly — the pivot path terminates on an EXACT complementary
    basis in ~n pivots (measured: 60-80 pivots, residuals ~1e-14 on the
    scenario ensemble), with the whole batch advancing in lockstep rank-1
    tableau updates inside one while_loop.  No inner iteration budget, no
    polish pass, machine-precision residuals.

    Fallback route (and ``method="admm"``): when the ensemble is the KKT
    system of box/polyhedral QPs (``structure = {"nd": #primal, "m": #rows}``
    with layout ``z = [x; λ; s]``), solve the underlying QPs with the batched
    ADMM kernel, reconstruct ``(λ, s)``, and Newton-polish.  Lanes the pivot
    route fails to certify are re-solved here — every result is audited
    against the AVI natural residual either way, so the output contract
    matches the generic solver exactly.
    """
    M = np.asarray(M, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    B, n, _ = M.shape
    from ..config import small_dispatch_device
    with small_dispatch_device(M.size):
        return _solve_kkt_avi_batch_impl(M, q, l, u, var_mask, structure,
                                         tol, qp_dtype, method)


def _solve_kkt_avi_batch_impl(M, q, l, u, var_mask, structure, tol,
                              qp_dtype, method):
    B, n, _ = M.shape
    if (method == "lemke" and structure.get("shared_M")
            and n >= _shared_min_n()
            and np.asarray(var_mask).all()
            and (M[0] == M).all()):
        # shared-matrix trajectory-scale ensembles: the GEMM EG +
        # f32-LU/f64-refinement route (ops/shared_kkt) — the Lemke tableau
        # no longer fits at this n and its pivots are bandwidth-bound
        from .shared_kkt import solve_kkt_avi_shared
        from ..utils.metrics import METRICS
        METRICS.bump("kkt_shared_route", B)
        return solve_kkt_avi_shared(M[0], q, l, u, None, tol=tol,
                                    structure=structure)
    if method == "lemke":
        # exact-shape call: scenario/KKT ensembles have one stable (B, n) per
        # model config, so bucket padding would only inflate the tableau
        # (n -> next bucket costs (n'/n)^2 per pivot); the jit cache keys on
        # the exact shape instead
        from .lemke import solve_lemke_batch
        # power-of-two static trip bound: measurably better XLA codegen than
        # arbitrary values, and fewer distinct compilations
        max_pivots = 256
        while max_pivots < min(4096, 16 * n + 256):
            max_pivots *= 2
        # f32 pivot path: the pivot SEQUENCE only needs enough precision to
        # pick the right complementary basis; the host f64 refactorization
        # and a short f64 Newton polish then land machine-precision
        # values from the f32-accurate point.  Lanes the audit rejects
        # re-pivot in f64.
        from .lemke import refactor_batch_np, solve_lemke_batch_state_auto
        f32 = functools.partial(np.asarray, dtype=np.float32)
        l64 = np.asarray(l, dtype=np.float64)
        u64 = np.asarray(u, dtype=np.float64)
        vm = np.asarray(var_mask, dtype=bool)
        # one pipelined device_get for all five outputs: serial np.asarray
        # fetches each pay a full device->host round-trip
        z32, st32, pivL, basis32, val32 = (
            np.asarray(a) for a in jax.device_get(
                solve_lemke_batch_state_auto(
                    f32(M), f32(q), f32(l64), f32(u64),
                    np.zeros((B, n), dtype=np.float32), vm,
                    tol=1e-6, piv_tol=1e-5, max_pivots=max_pivots)))
        # host f64 refactorization of the terminal basis: one stacked
        # LAPACK solve lands machine-precision values from the f32 path
        zL, okR = refactor_batch_np(M, q, l64, u64, basis32, val32, vm)
        zL[~okR] = np.asarray(z32, dtype=np.float64)[~okR]
        residL = natural_residual_np(M, q, l, u, zL, var_mask)
        okL = residL <= tol
        pivL = np.asarray(pivL, dtype=np.int64)
        # straggler subsets are BUCKET-padded (lane-0 copies, sliced off):
        # the straggler count varies run to run and an exact-shape call
        # would recompile the vmapped kernels per distinct count — the
        # cost the padding discipline exists to prevent
        from ..config import bucket, CONFIG

        def _pad_lanes(Bp, *arrs):
            pad = Bp - arrs[0].shape[0]
            if pad <= 0:
                return arrs
            return tuple(
                np.concatenate([a, np.repeat(a[:1], pad, axis=0)], axis=0)
                for a in arrs)

        if not okL.all():
            # short f64 Newton polish only for the residual stragglers
            idxP = np.nonzero(~okL)[0]
            Bp = bucket(len(idxP), CONFIG.batch_buckets)
            pol = solve_avi_batch_polish(
                *_pad_lanes(Bp, M[idxP], q[idxP], l64[idxP], u64[idxP],
                            zL[idxP], vm[idxP]), tol=tol, max_iter=8)
            zP = np.asarray(pol.z, dtype=np.float64)[:len(idxP)]
            rP = natural_residual_np(M[idxP], q[idxP], l64[idxP], u64[idxP],
                                     zP, vm[idxP])
            better = rP < residL[idxP]
            zL[idxP[better]] = zP[better]
            residL[idxP[better]] = rP[better]
            okL = residL <= tol
        if not okL.all():
            idx32 = np.nonzero(~okL)[0]
            Bp = bucket(len(idx32), CONFIG.batch_buckets)
            z64, st64, piv64 = (np.asarray(a)[:len(idx32)] for a in
                                jax.device_get(solve_lemke_batch(
                *_pad_lanes(Bp, M[idx32], q[idx32], l64[idx32], u64[idx32],
                            np.zeros((len(idx32), n)),
                            np.asarray(var_mask, dtype=bool)[idx32]),
                tol=1e-11, max_pivots=max_pivots)))
            r64 = natural_residual_np(M[idx32], q[idx32], l64[idx32],
                                      u64[idx32], z64,
                                      np.asarray(var_mask)[idx32])
            better = r64 < residL[idx32]
            zL[idx32[better]] = z64[better]
            residL[idx32[better]] = r64[better]
            pivL = pivL.copy()
            pivL[idx32] += np.asarray(piv64, dtype=np.int64)
            okL = residL <= tol
        if okL.all():
            return AVIResult(z=zL, resid=residL, iters=np.asarray(pivL),
                             converged=okL)
        # re-solve uncertified lanes through the ADMM+polish route below
        idxF = np.nonzero(~okL)[0]
        sub = solve_kkt_avi_batch(
            M[idxF], q[idxF], np.asarray(l)[idxF], np.asarray(u)[idxF],
            np.asarray(var_mask)[idxF], structure, tol=tol,
            qp_dtype=qp_dtype, method="admm")
        z_out = zL.copy()
        z_out[idxF] = np.asarray(sub.z)
        resid_out = residL.copy()
        resid_out[idxF] = np.asarray(sub.resid)
        iters_out = np.asarray(pivL, dtype=np.int64).copy()
        iters_out[idxF] += np.asarray(sub.iters, dtype=np.int64)
        return AVIResult(z=z_out, resid=resid_out, iters=iters_out,
                         converged=resid_out <= tol)
    nd, m = structure["nd"], structure["m"]
    assert n >= nd + 2 * m
    # recover QP data from the KKT blocks:
    #   rows 0..nd:      Q x − A' λ + c = 0
    #   rows nd..nd+m:   A x − s       (+ q offset) = 0
    #   vars nd+m..:     s with bounds [l2, u2]
    Q = M[:, :nd, :nd]
    At = -M[:, :nd, nd:nd + m]
    A = M[:, nd:nd + m, :nd]
    c = q[:, :nd]
    off = q[:, nd:nd + m]          # A x − s + off = 0  →  s = A x + off
    l2 = np.asarray(l)[:, nd + m:nd + 2 * m]
    u2 = np.asarray(u)[:, nd + m:nd + 2 * m]
    # constraint on x: l2 − off ≤ A x ≤ u2 − off.  f64 is the default;
    # pass qp_dtype=float32 to trade accuracy of the bulk pass for faster
    # iterations on larger blocks (the f64 Newton polish finishes).
    if qp_dtype is None:
        qp_dtype = np.float64
    cast = lambda a: np.asarray(a, dtype=qp_dtype)
    # f32 cannot reach the f64 termination tolerance — stop the ADMM at what
    # the dtype can certify and let the f64 Newton polish finish
    eps = 1e-5 if qp_dtype == np.float32 else 1e-9
    sol = jax.device_get(batch_qp.solve_qp_batch(
        cast(Q), cast(c), cast(A), cast(l2 - off), cast(u2 - off),
        np.ones((B, m), dtype=bool), eps=eps))
    x = np.asarray(sol.x, dtype=np.float64)
    y = np.asarray(sol.y, dtype=np.float64)
    lam = -y
    s = np.einsum("bij,bj->bi", A, x) + off
    z = np.concatenate([x, lam, s], axis=1)
    if n > nd + 2 * m:             # padded tail
        z = np.concatenate([z, np.zeros((B, n - nd - 2 * m))], axis=1)
    resid = natural_residual_np(M, q, l, u, z, var_mask)
    # f64 Newton polish for lanes above tolerance: first the light
    # Newton-only pass (warm starts converge in a handful of steps), then the
    # full hybrid solver only for whatever remains
    need = resid > tol
    if need.any():
        idx = np.nonzero(need)[0]
        res = jax.device_get(solve_avi_batch_polish(
            M[idx], q[idx], np.asarray(l)[idx], np.asarray(u)[idx],
            z[idx], np.asarray(var_mask)[idx], tol=tol))
        z[idx] = np.asarray(res.z)
        resid[idx] = np.asarray(res.resid)
        need2 = resid > tol
        if need2.any():
            idx2 = np.nonzero(need2)[0]
            res2 = jax.device_get(solve_avi_batch_padded(
                M[idx2], q[idx2], np.asarray(l)[idx2], np.asarray(u)[idx2],
                z[idx2], np.asarray(var_mask)[idx2], tol=tol, max_iter=780))
            z[idx2] = np.asarray(res2.z)
            resid[idx2] = np.asarray(res2.resid)
    return AVIResult(z=z, resid=resid,
                     iters=np.asarray(sol.iters),
                     converged=resid <= tol)


def solve_avi_batch_padded(M, q, l, u, z0, var_mask, _no_broker=False,
                           _sharding=None, _min_batch=1, **kw):
    """Bucket-pad the batch and variable dimensions so ragged AVI ensembles
    reuse a handful of compiled kernels (see config.dim_buckets).

    Under a lockstep broker the call parks and fuses with other scenarios'
    requests; ``_sharding`` device-puts the padded batch over a mesh."""
    from ..config import bucket, CONFIG
    if not _no_broker:
        from ..parallel.lockstep import active_broker
        br = active_broker()
        if br is not None:
            return br.submit("avi", M, q, l, u, z0, var_mask, **kw)
    M = np.asarray(M, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    B, n, _ = M.shape
    Bp = bucket(max(B, _min_batch),
                CONFIG.batch_buckets)
    np_ = bucket(n, CONFIG.row_buckets)
    Mp = np.zeros((Bp, np_, np_))
    Mp[:, range(np_), range(np_)] = 1.0
    Mp[:B, :n, :n] = M
    qp = np.zeros((Bp, np_))
    qp[:B, :n] = q
    lp = np.zeros((Bp, np_))
    up = np.zeros((Bp, np_))
    lp[:B, :n] = l
    up[:B, :n] = u
    zp = np.zeros((Bp, np_))
    zp[:B, :n] = z0
    mp = np.zeros((Bp, np_), dtype=bool)
    mp[:B, :n] = var_mask
    if _sharding is not None:
        Mp, qp, lp, up, zp, mp = (jax.device_put(a, _sharding)
                                  for a in (Mp, qp, lp, up, zp, mp))
    res = solve_avi_batch(Mp, qp, lp, up, zp, mp, **kw)
    return AVIResult(z=res.z[:B, :n], resid=res.resid[:B],
                     iters=res.iters[:B], converged=res.converged[:B])


# --------------------------------------------------------------------------
#  Host-level single-problem wrappers (the reference's call pattern)
# --------------------------------------------------------------------------

def check_avi_solution(avi: AVI, z, w, tol: float = 1e-6):
    """Residual audit of a proposed AVI solution (avi.jl:148-156)."""
    z = np.asarray(z, dtype=np.float64)
    r = avi.M @ z + avi.N @ np.asarray(w, dtype=np.float64) + avi.o
    r_pos = r > tol
    r_neg = r < -tol
    bad = (np.sum(np.abs(z[r_pos] - avi.l[r_pos]) > tol)
           + np.sum(np.abs(z[r_neg] - avi.u[r_neg]) > tol)
           + np.sum(z - avi.l < -tol) + np.sum(z - avi.u > tol))
    return bad == 0, int(bad), r


def solve_avi(avi: AVI, z0, w, convergence_tolerance: float = 1e-10,
              num_restarts: int = 4, seed: int = 0):
    """Solve one AVI instance (avi.jl:63-77 semantics).

    Robustness via multi-start: the warm start, the origin, and scaled random
    points all solve as ONE vmapped batch (restart_limits=5 in the
    reference's PATH call plays the same role); the best converged iterate
    wins.  Returns (z, status) with SUCCESS iff the natural residual meets
    the tolerance AND the check_avi_solution audit passes."""
    w = np.asarray(w, dtype=np.float64)
    q = avi.N @ w + avi.o
    n = q.shape[0]
    rng = np.random.default_rng(seed)
    starts = [np.asarray(z0, dtype=np.float64), np.zeros(n)]
    scale = 1.0 + np.abs(np.asarray(z0)).max()
    for _ in range(max(0, num_restarts - 2)):
        starts.append(rng.standard_normal(n) * scale)
    Z0 = np.stack(starts)
    B = Z0.shape[0]
    # host-latency glue, pinned off-accelerator REGARDLESS of n (the
    # reference makes this exact call serially in-process): a handful of
    # restart lanes gains nothing from the card and pays a fresh compile per
    # new QEP shape.  Placement kept from the earlier accelerator; ROADMAP
    # C3 re-measures it on the GPU.
    from ..config import glue_dispatch_device
    with glue_dispatch_device():
        res = solve_avi_batch_padded(
            np.repeat(avi.M[None], B, axis=0), np.repeat(q[None], B, axis=0),
            np.repeat(avi.l[None], B, axis=0),
            np.repeat(avi.u[None], B, axis=0),
            Z0, np.ones((B, n), dtype=bool),
            tol=convergence_tolerance, max_iter=4000)
        res = jax.device_get(res)
        resid = np.asarray(res.resid)
        best = int(np.argmin(resid))
        z = np.asarray(res.z)[best]
        ok = bool(np.asarray(res.converged)[best])
        if not ok:
            # escalation tier: proximal Lemke pivoting — the problem class
            # where smooth methods stall (degenerate multi-player LP-KKT
            # QEPs) is exactly what the reference's PATH pivoting handles
            # (avi.jl:63-77)
            from .lemke import lemke_escalate
            zL, rL = lemke_escalate(
                avi.M[None], q[None], avi.l[None], avi.u[None], z[None],
                np.ones((1, n), dtype=bool), tol=convergence_tolerance)
            if rL[0] < resid[best]:
                z, ok = zL[0], bool(rL[0] <= convergence_tolerance)
    sol_ok, degree, _ = check_avi_solution(avi, z, w, tol=1e-6)
    status = Status.SUCCESS if (ok and sol_ok) else Status.FAILURE
    return z, status


def find_closest_feasible(gavi: GAVI, z0, w):
    """Presolve: project z0 onto the GAVI's second-block feasible set
    (avi.jl:79-99): min ‖z−z0‖² s.t. l2 ≤ Az + Bw ≤ u2."""
    n = len(z0)
    c = gavi.B @ np.asarray(w, dtype=np.float64)
    sol = batch_qp.solve_qp_np(
        np.eye(n), -np.asarray(z0, dtype=np.float64),
        gavi.A, gavi.l2 - c, gavi.u2 - c)
    if sol.status in (batch_qp.SOLVED, batch_qp.SOLVED_INACCURATE):
        return np.asarray(sol.x)
    return np.asarray(z0, dtype=np.float64)


def solve_gavi(gavi: GAVI, z0, w, presolve: bool = True,
               convergence_tolerance: float = 1e-10):
    """GAVI solve via slack augmentation (avi.jl:101-111)."""
    z0 = np.asarray(z0, dtype=np.float64)
    if presolve:
        z0 = find_closest_feasible(gavi, z0, w)
    avi = convert_gavi(gavi)
    d1, d2 = gavi.d1, gavi.d2
    s = gavi.A @ z0 + gavi.B @ np.asarray(w, dtype=np.float64)
    z0s = np.concatenate([z0, s])
    z, status = solve_avi(avi, z0s, w, convergence_tolerance)
    return z[:d1 + d2], status


def relax_gavi(gavi: GAVI, relaxable_inds) -> GAVI:
    """Promote chosen parameters to free decision variables (avi.jl:130-146)."""
    relaxable_inds = list(relaxable_inds)
    mw = gavi.N.shape[1]
    param_inds = [i for i in range(mw) if i not in set(relaxable_inds)]
    d1, d2 = gavi.d1, gavi.d2
    dr = len(relaxable_inds)
    M = np.vstack([
        np.zeros((dr, d1 + d2 + dr)),
        np.hstack([gavi.N[:, relaxable_inds], gavi.M]),
    ])
    N = np.vstack([np.zeros((dr, len(param_inds))), gavi.N[:, param_inds]])
    o = np.concatenate([np.zeros(dr), gavi.o])
    l1 = np.concatenate([np.full(dr, -np.inf), gavi.l1])
    u1 = np.concatenate([np.full(dr, np.inf), gavi.u1])
    A = np.hstack([gavi.B[:, relaxable_inds], gavi.A])
    B = gavi.B[:, param_inds]
    return GAVI(M, N, o, l1, u1, A, B, gavi.l2, gavi.u2)
