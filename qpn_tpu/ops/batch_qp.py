"""Batched dense QP/LP solver — the accelerator replacement for OSQP.

The reference calls OSQP one problem at a time from ~10 sites (emptiness
sets.jl:610, containment sets.jl:388, implicit bounds sets.jl:673, GAVI
presolve avi.jl:80, membership sets.jl:834, ...).  Here the same role is
played by ONE vmapped ADMM kernel over padded ``(B, m, n)`` batches: every
polyhedral query in the framework is phrased as a batch of small dense QPs

    min ½ x'Px + q'x   s.t.  l ≤ Ax ≤ u

and dispatched in a single XLA computation.  Iterations are fixed-shape
(``lax.while_loop`` with convergence masks), the per-iteration linear solve is
a batched Cholesky of ``P + σI + A'RA`` (small dense matmuls),
and a terminal active-set polish step recovers ~1e-10 accuracy to match the
reference's ``eps_abs=eps_rel=1e-8, polish=true`` settings (sets.jl:616-618).

Status codes mirror the OSQP codes the reference branches on
(qp_processing.jl:7, sets.jl:683-701): 1 solved, 2 solved-inaccurate,
-3 primal infeasible, -4 dual infeasible.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CONFIG
from .linalg import qr_solve

SOLVED = 1
SOLVED_INACCURATE = 2
PRIMAL_INFEASIBLE = -3
DUAL_INFEASIBLE = -4
MAX_ITER = 0

_BIG = 1e20


class QPSolution(NamedTuple):
    x: jax.Array          # (n,) primal
    y: jax.Array          # (m,) dual (y>0 pushes on upper bound, y<0 on lower)
    z: jax.Array          # (m,) projected Ax
    obj: jax.Array        # objective value
    status: jax.Array     # int32 status code
    prim_res: jax.Array
    dual_res: jax.Array
    iters: jax.Array


def _clip_inf(v):
    return jnp.clip(v, -_BIG, _BIG)


def _ruiz_equilibrate(P, q, A, row_mask, iters=10):
    """Modified Ruiz equilibration of the KKT data: diagonal D (variables) and
    E (rows) such that columns of [DPD; EAD] and rows of EAD have ~unit
    inf-norm.  Dramatically cuts ADMM iterations on badly scaled LPs."""
    n = q.shape[0]
    m = A.shape[0]
    dt = q.dtype
    D = jnp.ones(n, dtype=dt)
    E = jnp.ones(m, dtype=dt)

    def body(i, DE):
        D, E = DE
        Pn = jnp.abs(D[:, None] * P * D[None, :])
        An = jnp.abs(E[:, None] * A * D[None, :]) * row_mask[:, None]
        col = jnp.maximum(jnp.max(Pn, axis=0), jnp.max(An, axis=0))
        dd = 1.0 / jnp.sqrt(jnp.clip(col, 1e-8, 1e8))
        row = jnp.max(An, axis=1)
        de = jnp.where(row_mask, 1.0 / jnp.sqrt(jnp.clip(row, 1e-8, 1e8)), 1.0)
        return D * dd, E * de

    D, E = jax.lax.fori_loop(0, iters, body, (D, E))
    return D, E


def _admm_solve(P, q, A, l, u, row_mask, *, max_iter, eps, rho0, sigma, alpha,
                check_every, banded_k=0, mixed=False,
                x_init=None, y_init=None, polish=True):
    """Single-instance OSQP-style ADMM. All shapes static; vmapped by caller.

    Invalid (padded) rows must come with a=0, l=-inf, u=+inf, row_mask=False.

    ``banded_k > 0`` declares the KKT matrix ``P + σI + A'RA`` block-
    tridiagonal with step size ``banded_k`` in the given variable ordering
    (trajectory-horizon QPs, SURVEY §5 "long-context"): the x-update then
    factors by cyclic reduction (ops/banded.py) — O(T k³ log T) instead of
    O((Tk)³) — the sequence-parallel axis in the production QP path.

    ``mixed=True`` (f64 inputs only): iterates, residuals, and K stay f64,
    but every FACTORIZATION runs in f32 with one f64 iterative-refinement
    pass per solve: f32 factors + f64 GEMV refinement converge like f64
    (the refined solve is ~1e-10 relative, same discipline as
    shared_kkt._basis_solve_refine).  The mode was built for an earlier
    accelerator without fast f64; whether native f64 ADMM beats it on the
    GPU is ROADMAP C2 (measure both in one call before removing it).
    """
    n = q.shape[0]
    m = l.shape[0]
    dt = q.dtype
    f32 = jnp.float32

    # -------- Ruiz equilibration (scaled problem solved, unscaled returned) --
    Dsc, Esc = _ruiz_equilibrate(P, q, A, row_mask)
    P0, q0, A0, l0, u0 = P, q, A, l, u
    P = Dsc[:, None] * P * Dsc[None, :]
    q = Dsc * q
    A = Esc[:, None] * A * Dsc[None, :]
    l = jnp.where(jnp.isfinite(l), Esc * l, l)
    u = jnp.where(jnp.isfinite(u), Esc * u, u)

    l = jnp.where(row_mask, l, -jnp.inf)
    u = jnp.where(row_mask, u, jnp.inf)
    lc = _clip_inf(l)
    uc = _clip_inf(u)

    eq = row_mask & (jnp.abs(uc - lc) < 1e-10)
    loose = (~row_mask) | (~jnp.isfinite(l) & ~jnp.isfinite(u))

    def rho_vec(rho):
        r = jnp.where(eq, rho * 1e3, rho)
        return jnp.where(loose, rho * 1e-6, r)

    if banded_k:
        assert n % banded_k == 0, "banded_k must divide the variable count"
        Tb = n // banded_k

    _HI = jax.lax.Precision.HIGHEST

    def _split(M):
        Mh = M.astype(f32)
        return Mh, (M - Mh.astype(dt)).astype(f32)

    def _split_mv(Mh, Ml, v):
        vh = v.astype(f32)
        vl = (v - vh.astype(dt)).astype(f32)
        return (jnp.dot(Mh, vh, precision=_HI).astype(dt)
                + jnp.dot(Mh, vl, precision=_HI).astype(dt)
                + jnp.dot(Ml, vh, precision=_HI).astype(dt))

    if mixed:
        # split-f32 (double-float) products for EVERY dense matmul/matvec
        # in the solve: M·v ≈ M_hi·v_hi + M_hi·v_lo + M_lo·v_hi, each an
        # f32 op at Precision.HIGHEST (~1e-7 relative), in place of f64
        # matmuls.  The ~1e-7·scale noise floor sits below the eps=1e-4/
        # 1e-6 targets the mixed rung uses, and acceptance is always the
        # caller's exact-f64 audit.
        A_hi, A_lo = _split(A)
        P_hi, P_lo = _split(P)

        def matA(v):
            return _split_mv(A_hi, A_lo, v)

        def matAT(v):
            return _split_mv(A_hi.T, A_lo.T, v)

        def matP(v):
            return _split_mv(P_hi, P_lo, v)
    else:
        matA = lambda v: A @ v          # noqa: E731
        matAT = lambda v: A.T @ v       # noqa: E731
        matP = lambda v: P @ v          # noqa: E731

    # rho enters K only as a scalar multiple of the CONSTANT Gram matrix
    # G = A'·diag(base)·A (base = per-row class multiplier): K(ρ) = K0 + ρG.
    # Hoisting G out of factor() removes the per-epoch A'RA matmul; in
    # mixed mode the build itself is a split-f32 matrix product.
    base_r = rho_vec(jnp.asarray(1.0, dtype=dt))
    Atb = A.T * base_r[None, :]
    if mixed:
        Atb_hi, Atb_lo = _split(Atb)
        G = (jnp.dot(Atb_hi, A_hi, precision=_HI).astype(dt)
             + jnp.dot(Atb_hi, A_lo, precision=_HI).astype(dt)
             + jnp.dot(Atb_lo, A_hi, precision=_HI).astype(dt))
    else:
        G = Atb @ A
    K0 = P + sigma * jnp.eye(n, dtype=dt)

    def factor(rho):
        R = rho * base_r
        K = K0 + rho * G
        if banded_k:
            from .banded import cr_factor
            Kb = K.reshape(Tb, banded_k, Tb, banded_k)
            idx = jnp.arange(Tb)
            Bd = Kb[idx, :, idx, :]
            Ad = Kb[idx, :, jnp.clip(idx - 1, 0, Tb - 1), :]
            Cd = Kb[idx, :, jnp.clip(idx + 1, 0, Tb - 1), :]
            Ad = Ad.at[0].set(0.0)
            Cd = Cd.at[Tb - 1].set(0.0)
            return cr_factor(Ad, Bd, Cd), R
        if mixed:
            # explicit f32 inverse via the Cholesky factor: ONE triangular
            # solve per refactor (L⁻¹) + a matmul (Kinv = L⁻ᵀL⁻¹) —
            # batched trisolves are latency-bound; with Kinv every
            # x-update is a pure matmul, and the
            # split-f32 refinement against K restores the accuracy the
            # explicit inverse loses
            K_hi = K.astype(f32)
            K_lo = (K - K_hi.astype(dt)).astype(f32)
            L32 = jnp.linalg.cholesky(K_hi)
            eyef = jnp.eye(n, dtype=f32)
            Linv = jax.scipy.linalg.solve_triangular(L32, eyef, lower=True)
            Kinv = jnp.dot(Linv.T, Linv, precision=_HI)
            return (Kinv, K_hi, K_lo), R
        return jnp.linalg.cholesky(K), R

    def chol_solve(L, b):
        if banded_k:
            from .banded import cr_solve
            return cr_solve(L, b.reshape(Tb, banded_k)).reshape(n)
        if mixed:
            Kinv, K_hi, K_lo = L
            _HI = jax.lax.Precision.HIGHEST

            def apply(bb):
                return jnp.dot(Kinv, bb.astype(f32),
                               precision=_HI).astype(dt)
            x = apply(b)
            x = x + apply(b - _split_mv(K_hi, K_lo, x))
            return x + apply(b - _split_mv(K_hi, K_lo, x))
        w = jax.scipy.linalg.solve_triangular(L, b, lower=True)
        return jax.scipy.linalg.solve_triangular(L.T, w, lower=False)

    # warm start in SCALED coordinates (x = Dsc·x̂, y = Esc·ŷ): an EG-grade
    # (~1e-3) primal/dual estimate cuts the iteration count several-fold on
    # trajectory-scale QPs (measured in the shared-route chip rung)
    if x_init is not None:
        x0 = (x_init / Dsc).astype(dt)
        z0 = jnp.clip(matA(x0), lc, uc)
    else:
        x0 = jnp.zeros(n, dtype=dt)
        z0 = jnp.zeros(m, dtype=dt)
    if y_init is not None:
        y0 = (y_init / jnp.where(Esc == 0, 1.0, Esc)).astype(dt)
    else:
        y0 = jnp.zeros(m, dtype=dt)

    def residuals(x, z, y):
        Ax = matA(x)
        Px = matP(x)
        Aty = matAT(y)
        prim = jnp.max(jnp.abs(Ax - z) * row_mask, initial=0.0)
        dual = jnp.max(jnp.abs(Px + q + Aty), initial=0.0)
        prim_rel = jnp.maximum(jnp.max(jnp.abs(Ax) * row_mask, initial=0.0),
                               jnp.max(jnp.abs(z) * row_mask, initial=0.0))
        dual_rel = jnp.maximum(
            jnp.max(jnp.abs(Px), initial=0.0),
            jnp.maximum(jnp.max(jnp.abs(Aty), initial=0.0),
                        jnp.max(jnp.abs(q), initial=0.0)))
        return prim, dual, prim_rel, dual_rel

    # Epoch-structured main loop.  Under vmap, lax.cond lowers to select —
    # BOTH branches execute for every lane on every iteration — so guarding
    # the residual check / rho refactorization with cond inside a
    # per-iteration body still pays a full K rebuild + Cholesky each
    # iteration (~25x the useful FLOPs; measured 50s -> 3s on a
    # (512, 256, 128) verification batch).  Instead: an inner fori_loop of
    # ``check_every`` bare iterations (matvecs + triangular solves only),
    # with residuals, termination certificates, and rho adaptation ONCE per
    # epoch at the boundary — the same cadence the old per-iteration
    # cond-guards produced (check at k%25==24, adapt at k%100==99).
    adapt_every = max(100 // check_every, 1) * check_every

    def iter_once(_, carry):
        x, z, y, dx_acc, dy_acc, L, R = carry
        rhs = sigma * x - q + matAT(R * z - y)
        x_new = chol_solve(L, rhs)
        Ax = matA(x_new)
        z_relaxed = alpha * Ax + (1 - alpha) * z
        z_new = jnp.clip(z_relaxed + y / R, lc, uc)
        z_new = jnp.where(loose, z_relaxed + y / R, z_new)
        y_new = y + R * (z_relaxed - z_new)
        x_new = alpha * x_new + (1 - alpha) * x
        return (x_new, z_new, y_new,
                dx_acc * 0.5 + (x_new - x), dy_acc * 0.5 + (y_new - y), L, R)

    def check_status(x, z, y, dx_acc, dy_acc):
        """Residuals, termination flag, and infeasibility certificates —
        the per-check-epoch block (cheap matvecs only, no factorization)."""
        prim, dual, prim_rel, dual_rel = residuals(x, z, y)
        eps_p = eps + eps * prim_rel
        eps_d = eps + eps * dual_rel
        solved = (prim <= eps_p) & (dual <= eps_d)

        # primal infeasibility certificate on accumulated dy
        ny = jnp.max(jnp.abs(dy_acc), initial=0.0)
        dyv = dy_acc / jnp.maximum(ny, 1e-30)
        Atdy = jnp.max(jnp.abs(matAT(dyv)), initial=0.0)
        sup = jnp.sum(jnp.where(row_mask,
                                _clip_inf(u) * jnp.maximum(dyv, 0)
                                + _clip_inf(l) * jnp.minimum(dyv, 0), 0.0))
        pinf = (ny > 1e-12) & (Atdy <= 1e-6) & (sup <= -1e-6)

        # dual infeasibility certificate on accumulated dx
        nx = jnp.max(jnp.abs(dx_acc), initial=0.0)
        dxv = dx_acc / jnp.maximum(nx, 1e-30)
        Pdx = jnp.max(jnp.abs(matP(dxv)), initial=0.0)
        qdx = jnp.dot(q, dxv)
        Adx = matA(dxv)
        cone_ok = jnp.all(jnp.where(~row_mask, True,
                  jnp.where(jnp.isfinite(l) & jnp.isfinite(u), jnp.abs(Adx) <= 1e-6,
                  jnp.where(jnp.isfinite(l), Adx >= -1e-6,
                  jnp.where(jnp.isfinite(u), Adx <= 1e-6, True)))))
        dinf = (nx > 1e-12) & (Pdx <= 1e-6) & (qdx <= -1e-6) & cone_ok

        status = jnp.where(solved, SOLVED,
                 jnp.where(pinf, PRIMAL_INFEASIBLE,
                 jnp.where(dinf, DUAL_INFEASIBLE, MAX_ITER))).astype(jnp.int32)
        return status, prim, dual, prim_rel, dual_rel

    # the while body is one ADAPT epoch: factor(rho) ONCE, then
    # n_checks blocks of {check_every bare iterations + status check}.
    # rho can only change at adapt boundaries (the `allowed` gate), so
    # refactoring per CHECK epoch — as the previous structure did — paid
    # 4× the factorization cost for identical factors; in mixed mode the
    # factor (Cholesky + explicit inverse) dominated trajectory-scale
    # rungs (measured: 40 s of the T=16 chip rung).  A block whose start
    # status is terminal keeps its state (per-lane freezing).
    # Non-mixed (glue-QP) callers keep check-epoch granularity: their
    # factors are cheap, and the coarser epoch exit costs small fast-
    # converging QPs up to 3 extra check blocks per call (measured as a
    # zoo-wall regression).
    n_checks = max(adapt_every // check_every, 1) if mixed else 1

    def body(state):
        k, x, z, y, rho, status, dx_acc, dy_acc = state
        L, R = factor(rho)

        def block(_, st):
            k, x, z, y, status, dx_acc, dy_acc, pr = st
            live = status == MAX_ITER
            xn, zn, yn, dxn, dyn, _, _ = jax.lax.fori_loop(
                0, check_every, iter_once, (x, z, y, dx_acc, dy_acc, L, R))
            sn, prim, dual, prim_rel, dual_rel = check_status(
                xn, zn, yn, dxn, dyn)
            x = jnp.where(live, xn, x)
            z = jnp.where(live, zn, z)
            y = jnp.where(live, yn, y)
            dx_acc = jnp.where(live, dxn, dx_acc)
            dy_acc = jnp.where(live, dyn, dy_acc)
            status = jnp.where(live, sn, status)
            k = jnp.where(live, k + check_every, k)
            prn = jnp.where(live, jnp.stack([prim, dual, prim_rel,
                                             dual_rel]), pr)
            return k, x, z, y, status, dx_acc, dy_acc, prn

        pr0 = jnp.zeros(4, dtype=dt)
        k, x, z, y, status, dx_acc, dy_acc, pr = jax.lax.fori_loop(
            0, n_checks, block, (k, x, z, y, status, dx_acc, dy_acc, pr0))

        # adaptive rho on residual balance at the adapt boundary (same
        # cadence as before; applying it only when the ratio moved 5x
        # keeps the factorization identical on quiet epochs)
        prim, dual, prim_rel, dual_rel = pr[0], pr[1], pr[2], pr[3]
        ratio = jnp.sqrt((prim / jnp.maximum(prim_rel, 1e-12))
                         / jnp.maximum(dual / jnp.maximum(dual_rel, 1e-12),
                                       1e-12))
        rho_new = jnp.clip(rho * ratio, 1e-6, 1e6)
        allowed = ((k % adapt_every) == 0) & (k - check_every < max_iter // 2)
        big_change = (rho_new > 5 * rho) | (rho_new < rho / 5)
        rho = jnp.where(allowed & big_change & (status == MAX_ITER),
                        rho_new, rho)
        return (k, x, z, y, rho, status, dx_acc, dy_acc)

    def cond(state):
        return (state[0] < max_iter) & (state[5] == MAX_ITER)

    init = (jnp.int32(0), x0, z0, y0, jnp.asarray(rho0, dtype=dt),
            jnp.int32(MAX_ITER), jnp.zeros(n, dtype=dt),
            jnp.zeros(m, dtype=dt))
    k, x, z, y, rho, status, _, _ = jax.lax.while_loop(cond, body, init)

    # -------- unscale back to the original problem ------------------------
    if mixed:
        A0_hi, A0_lo = _split(A0)
        P0_hi, P0_lo = _split(P0)
        matA0 = lambda v: _split_mv(A0_hi, A0_lo, v)          # noqa: E731
        matAT0 = lambda v: _split_mv(A0_hi.T, A0_lo.T, v)     # noqa: E731
        matP0 = lambda v: _split_mv(P0_hi, P0_lo, v)          # noqa: E731
    else:
        matA0 = lambda v: A0 @ v                              # noqa: E731
        matAT0 = lambda v: A0.T @ v                           # noqa: E731
        matP0 = lambda v: P0 @ v                              # noqa: E731
    x = Dsc * x
    y = Esc * y
    lc0 = _clip_inf(jnp.where(row_mask, l0, -jnp.inf))
    uc0 = _clip_inf(jnp.where(row_mask, u0, jnp.inf))
    z = jnp.clip(matA0(x), lc0, uc0)

    def residuals0(x, z, y):
        Ax = matA0(x)
        prim = jnp.max(jnp.abs(Ax - z) * row_mask, initial=0.0)
        dual = jnp.max(jnp.abs(matP0(x) + q0 + matAT0(y)), initial=0.0)
        return prim, dual

    # -------- polish: active-set KKT refinement on the ORIGINAL data ------
    def polish_fn(x, z, y):
        Ax = matA0(x)
        act_l = row_mask & ((y < -1e-9) | (Ax <= lc0 + 1e-7))
        act_u = row_mask & ((y > 1e-9) | (Ax >= uc0 - 1e-7))
        act = act_l | act_u
        bnd = jnp.where(act_l, lc0, uc0)
        w = act.astype(dt)
        # Regularized KKT of the equality-constrained QP on active rows:
        #  [P+δI  Aact'] [x]   [-q ]
        #  [Aact   -δI ] [ν] = [bnd]
        # solved by dense QR.  (An SPD Schur-complement route through two
        # Choleskys is ~10x faster but loses dual accuracy when P is
        # singular — LP-like lanes get x ~ (P+δI)⁻¹(...) cancellation at
        # scale 1/δ — and the degraded duals flip downstream active-set
        # labels: deep_synthetic chain solves regress.  Keep QR until a
        # polish with LP-safe numerics is validated.)
        delta = 1e-9
        K = jnp.block([
            [P0 + delta * jnp.eye(n, dtype=dt), (A0 * w[:, None]).T],
            [A0 * w[:, None], -delta * jnp.eye(m, dtype=dt)],
        ])
        rhs = jnp.concatenate([-q0, jnp.where(act, bnd, 0.0)])
        # QR-based solve (see ops/linalg.py); in mixed mode the QR itself
        # is f32 with f64 refinement
        if mixed:
            Q32, R32 = jnp.linalg.qr(K.astype(f32))

            def _qs(bb):
                r_ = Q32.T @ bb.astype(f32)
                return jax.scipy.linalg.solve_triangular(
                    R32, r_, lower=False).astype(dt)
            sol = _qs(rhs)
            sol = sol + _qs(rhs - K @ sol)
            sol = sol + _qs(rhs - K @ sol)
        else:
            sol = qr_solve(K, rhs)
            # one step of iterative refinement
            r = rhs - K @ sol
            sol = sol + qr_solve(K, r)
        x_p = sol[:n]
        y_p = jnp.where(act, sol[n:], 0.0)
        # dual-sign sanity: lower-active duals ≤ 0, upper-active ≥ 0
        y_p = jnp.where(act_l & ~act_u, jnp.minimum(y_p, 0.0), y_p)
        y_p = jnp.where(act_u & ~act_l, jnp.maximum(y_p, 0.0), y_p)
        z_p = jnp.clip(matA0(x_p), lc0, uc0)
        prim_p, dual_p = residuals0(x_p, z_p, y_p)
        prim_o, dual_o = residuals0(x, z, y)
        Axp = matA0(x_p)
        feas_p = jnp.all(jnp.where(row_mask,
                                   (Axp >= lc0 - 1e-7)
                                   & (Axp <= uc0 + 1e-7), True))
        better = feas_p & (prim_p + dual_p <= prim_o + dual_o)
        x = jnp.where(better, x_p, x)
        y = jnp.where(better, y_p, y)
        z = jnp.where(better, jnp.clip(matA0(x), lc0, uc0), z)
        return x, z, y

    prim, dual = residuals0(x, z, y)
    # ``polish=False`` callers (the shared-route chip rung) certify through
    # their own structured host polish; under vmap the lax.cond below runs
    # the polish body for EVERY lane regardless of the flag value (select
    # semantics), and its (n+m)^2 batched QR dominates the whole call at
    # trajectory shapes (measured: the T=16 rung), so the skip must be
    # STATIC.
    do_polish = (status == SOLVED) | ((prim <= 1e-3) & (dual <= 1e-3))
    if not polish:
        do_polish = jnp.bool_(False)
    x, z, y = jax.lax.cond(do_polish, lambda op: polish_fn(*op),
                           lambda op: op, (x, z, y))

    prim, dual = residuals0(x, z, y)
    good = (prim <= 1e-6) & (dual <= 1e-6)
    okish = (prim <= 1e-4) & (dual <= 1e-4)
    # the in-loop check() passes on SCALED residuals; reclassify EVERY
    # solved-like lane against the unscaled ones (a badly Ruiz-scaled lane
    # can pass eps=1e-9 scaled while sitting at 1e-5 unscaled — returning
    # SOLVED there is inconsistent with the MAX_ITER ladder below).
    # Infeasibility certificates are untouched.
    solved_like = (status == SOLVED) | (status == MAX_ITER)
    status = jnp.where(solved_like & good, SOLVED,
              jnp.where(solved_like & okish, SOLVED_INACCURATE,
               jnp.where(status == SOLVED, MAX_ITER,
                         status))).astype(jnp.int32)
    obj = 0.5 * jnp.dot(x, P0 @ x) + jnp.dot(q0, x)
    return QPSolution(x=x, y=y, z=z, obj=obj, status=status,
                      prim_res=prim, dual_res=dual, iters=k)


# max_iter is a TRACED scalar (it only feeds the while_loop condition and
# an integer halving), so the two-tier straggler scheme (250 vs 4000) and
# any caller-chosen budget share one compiled kernel per shape bucket —
# halving the trace/compile count of the cold path.
@functools.partial(jax.jit, static_argnames=("check_every", "banded_k",
                                             "mixed", "polish"))
def solve_qp_batch(P, q, A, l, u, row_mask, *, max_iter=4000, eps=1e-9,
                   rho0=0.1, sigma=1e-6, alpha=1.6, check_every=25,
                   banded_k=0, mixed=False, x_init=None, y_init=None,
                   polish=True):
    """Solve a batch of box-constrained QPs.

    Args: P (B,n,n), q (B,n), A (B,m,n), l,u (B,m), row_mask (B,m) bool.
    ``banded_k`` routes the x-update through cyclic reduction for
    block-tridiagonal trajectory KKTs (see _admm_solve); ``mixed`` keeps
    f64 iterates but factors in f32 (the accelerator-safe f64 mode);
    ``x_init``/``y_init`` (B,n)/(B,m) warm-start the iteration.
    Returns QPSolution with leading batch dim.
    """
    fn = functools.partial(_admm_solve, max_iter=max_iter, eps=eps, rho0=rho0,
                           sigma=sigma, alpha=alpha, check_every=check_every,
                           banded_k=banded_k, mixed=mixed, polish=polish)
    if x_init is None and y_init is None:
        return jax.vmap(fn)(P, q, A, l, u, row_mask)
    B, m, n = A.shape
    if x_init is None:
        x_init = jnp.zeros((B, n), dtype=q.dtype)
    if y_init is None:
        y_init = jnp.zeros((B, m), dtype=q.dtype)
    return jax.vmap(lambda P_, q_, A_, l_, u_, rm_, xi_, yi_: fn(
        P_, q_, A_, l_, u_, rm_, x_init=xi_, y_init=yi_))(
            P, q, A, l, u, row_mask, x_init, y_init)


def solve_qp_batch_padded(P, q, A, l, u, row_mask, _no_lemke=False,
                          _no_broker=False, _sharding=None, _min_batch=1,
                          _prefer_lemke=False, **kw):
    """Bucket-padded batched solve: pads the batch size, row count, and
    variable count up to the configured buckets so repeated calls with ragged
    shapes hit a handful of compiled kernels instead of recompiling
    (config.row_buckets / dim_buckets).  Padded problems are trivial
    (P=I, no rows); padded rows are masked off; padded variables are fixed
    at 0 by identity P rows with zero q (their solution is 0).

    Pure LPs (P = 0) route to the exact Lemke pivot engine when
    ``CONFIG.lp_engine == "lemke"`` — tens of pivots instead of thousands of
    ADMM iterations, exact duals; uncertified lanes fall back here.

    Under a lockstep broker (parallel/lockstep.py) the call parks and fuses
    with other scenarios' requests; ``_sharding`` device-puts the padded
    batch with a mesh sharding so XLA partitions the batch axis (dp)."""
    from ..config import bucket, CONFIG

    if not _no_broker:
        from ..parallel.lockstep import active_broker
        br = active_broker()
        if br is not None:
            return br.submit("qp", P, q, A, l, u, row_mask,
                             _no_lemke=_no_lemke,
                             _prefer_lemke=_prefer_lemke, **kw)

    P = np.asarray(P, dtype=np.float64)
    if (not _no_lemke
            and (CONFIG.lp_engine in ("lemke", "check") or _prefer_lemke)
            and not kw and P.size and not P.any()):
        from .lemke import solve_lp_lemke_batch
        sol = solve_lp_lemke_batch(q, A, l, u, row_mask,
                                   _sharding=_sharding,
                                   _min_batch=_min_batch)
        if CONFIG.lp_engine == "check":      # engine cross-validation mode
            ref = solve_qp_batch_padded(P, q, A, l, u, row_mask,
                                        _no_lemke=True)
            st_l = np.asarray(sol.status)
            st_r = np.asarray(ref.status)
            st_mismatch = (st_l != st_r) & ~((st_l == 1) & (st_r == 2))
            obj_mismatch = (st_l == 1) & (st_r == 1) & (
                np.abs(np.asarray(sol.obj) - np.asarray(ref.obj))
                > 1e-5 * (1 + np.abs(np.asarray(ref.obj))))
            for i in np.nonzero(st_mismatch | obj_mismatch)[0]:
                print(f"LPCHECK mismatch lane {i}: lemke st={st_l[i]} "
                      f"obj={np.asarray(sol.obj)[i]:.6g} | admm "
                      f"st={st_r[i]} obj={np.asarray(ref.obj)[i]:.6g}",
                      flush=True)
                import os
                dump = os.environ.get("QPN_LPCHECK_DUMP")
                if dump:
                    k = len([f for f in os.listdir(dump)
                             if f.startswith("lpmis")])
                    if k < 8:
                        np.savez(os.path.join(dump, f"lpmis_{k}.npz"),
                                 c=np.asarray(q)[i], A=np.asarray(A)[i],
                                 l=np.asarray(l)[i], u=np.asarray(u)[i],
                                 mask=np.asarray(row_mask)[i])
        return sol
    q = np.asarray(q, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    row_mask = np.asarray(row_mask, dtype=bool)
    B, m, n = A.shape
    # Trajectory-structure auto-routing (SURVEY §5 long-context axis): when
    # the batch's KKT pattern is block-tridiagonal with enough blocks, the
    # x-update factors by cyclic reduction instead of dense Cholesky.  The
    # variable axis then stays EXACT (bucket padding would break the block
    # divisibility and densify the pattern).
    if (CONFIG.banded_auto and "banded_k" not in kw
            and n >= CONFIG.banded_auto_min_n and P.any()):
        from ..config import banded_min_blocks
        from .banded import detect_banded_k
        bk = detect_banded_k(P, A, min_blocks=banded_min_blocks())
        if bk:
            kw["banded_k"] = bk
            from ..utils.metrics import METRICS
            METRICS.bump("banded_route", B)
    Bp = bucket(max(B, _min_batch),
                CONFIG.batch_buckets)
    mp = bucket(m, CONFIG.row_buckets)
    np_ = n if kw.get("banded_k") else bucket(n, CONFIG.dim_buckets)

    Pp = np.zeros((Bp, np_, np_))
    # padded variables get unit diagonal so K = P + sigma I stays SPD
    Pp[:, :, :] = np.eye(np_)
    Pp[:B, :n, :n] = P
    qp_ = np.zeros((Bp, np_))
    qp_[:B, :n] = q
    Ap = np.zeros((Bp, mp, np_))
    Ap[:B, :m, :n] = A
    lp = np.full((Bp, mp), -np.inf)
    up = np.full((Bp, mp), np.inf)
    lp[:B, :m] = l
    up[:B, :m] = u
    maskp = np.zeros((Bp, mp), dtype=bool)
    maskp[:B, :m] = row_mask
    if _sharding is not None:
        import jax
        Pp, qp_, Ap, lp, up, maskp = (
            jax.device_put(a, _sharding)
            for a in (Pp, qp_, Ap, lp, up, maskp))
    tier1 = CONFIG.admm_tier1_iters
    if "max_iter" not in kw and tier1 > 0:
        # tier 1: short lockstep pass — most lanes converge well inside it
        sol = _np_solution(_call_kernel(Pp, qp_, Ap, lp, up, maskp,
                                        max_iter=tier1, **kw), B, n, m)
        # stragglers = lanes that EXHAUSTED the tier-1 budget, including
        # those the post-loop ladder upgraded to SOLVED_INACCURATE/SOLVED
        # on 1e-4/1e-6 residuals — a single full-budget call would have
        # kept iterating them toward eps, and that is the contract here
        bad = np.nonzero(np.asarray(sol.iters) >= tier1)[0]
        if bad.size == 0:
            return sol
        # tier 2: full budget for the stragglers only (small batch); the
        # outcome contract is identical to a single full-budget call —
        # tier 1 merely caps how long converged lanes ride the lockstep
        sub = solve_qp_batch_padded(
            P[bad], q[bad], A[bad], l[bad], u[bad], row_mask[bad],
            _no_lemke=_no_lemke, _no_broker=True, max_iter=4000, **kw)
        out = {f: getattr(sol, f).copy() for f in sol._fields}
        for f in sol._fields:
            out[f][bad] = np.asarray(getattr(sub, f))
        out["iters"][bad] += tier1
        return QPSolution(**out)
    sol = _call_kernel(Pp, qp_, Ap, lp, up, maskp, **kw)
    return _np_solution(sol, B, n, m)


def _call_kernel(Pp, qp_, Ap, lp, up, maskp, **kw):
    """Dispatch the batched ADMM kernel through the cross-process AOT
    cache (utils/aot_cache): scalar knobs ride as traced inputs, the
    jit-static knobs (check_every, banded_k) are baked per artifact and
    encoded in the cache tag.  Sharded inputs fall back to the live jit
    inside call_aot.

    On accelerator backends, sub-threshold batches run on the LOCAL CPU
    backend instead (``config.small_qp_on_cpu``): these geometry/
    verification LPs are host-algorithm glue — the reference runs them
    in-process in OSQP — and each accelerator dispatch costs a device
    round-trip that dwarfs the solve itself.  The accelerator keeps the big
    structured AVI batches.
    """
    from ..config import small_dispatch_device
    from ..utils.aot_cache import call_aot
    static = {k: kw[k] for k in ("check_every", "banded_k") if k in kw}
    tag = "qp_batch|" + ",".join(f"{k}={v}" for k, v in sorted(static.items()))
    n_elems = Pp.size if isinstance(Pp, np.ndarray) else 1 << 30
    with small_dispatch_device(n_elems):
        return call_aot(tag, solve_qp_batch, Pp, qp_, Ap, lp, up, maskp,
                        **kw)


def _np_solution(sol, B, n, m):
    """Materialize a padded device QPSolution as sliced numpy arrays.

    One pipelined device_get for ALL fields (serial per-field np.asarray
    fetches pay one device round-trip each); slicing happens in
    numpy.  (Slicing the
    jax Arrays instead compiles a one-off jit(dynamic_slice) per distinct
    shape — measured at ~200 such micro-compiles per cold solve, the
    dominant cold-start cost.)

    Under multi-process SPMD the kernel outputs span processes and a plain
    device_get is illegal — allgather the full batch instead (every process
    needs the whole result: the host algorithm is replicated)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        sol = jax.tree.map(
            lambda v: multihost_utils.process_allgather(v, tiled=True)
            if isinstance(v, jax.Array) and not v.is_fully_addressable
            else v, sol)
    sol = jax.device_get(sol)
    return QPSolution(x=np.asarray(sol.x)[:B, :n],
                      y=np.asarray(sol.y)[:B, :m],
                      z=np.asarray(sol.z)[:B, :m],
                      obj=np.asarray(sol.obj)[:B],
                      status=np.asarray(sol.status)[:B],
                      prim_res=np.asarray(sol.prim_res)[:B],
                      dual_res=np.asarray(sol.dual_res)[:B],
                      iters=np.asarray(sol.iters)[:B])


def solve_qp_np(P, q, A, l, u, row_mask=None, **kw):
    """Convenience single-problem host wrapper returning numpy results."""
    P = np.asarray(P, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    if row_mask is None:
        row_mask = np.ones(l.shape[0], dtype=bool)
    sol = solve_qp_batch_padded(P[None], q[None], A[None], l[None], u[None],
                                row_mask[None], **kw)
    return jax.tree.map(lambda v: np.asarray(v[0]), sol)
