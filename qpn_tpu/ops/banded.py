"""Block-tridiagonal KKT solver via cyclic reduction — the sequence/context-
parallel analogue (SURVEY.md §5 "long-context"): trajectory-horizon KKT
systems (robust_avoid's T-step dynamics, deprecated/robust_avoid.jl:72-83)
factor as block-banded matrices.  A serial Thomas sweep is O(T) sequential;
cyclic reduction runs in O(log T) parallel levels of batched small-block
solves — each level is one fused set of (B, T, k, k) einsums/solves, and
the level loop is a host-unrolled log₂T sequence (static shapes).

System:  A_t x_{t-1} + B_t x_t + C_t x_{t+1} = b_t,  t = 0..T-1
(A_0 = C_{T-1} = 0).  Blocks are general (QR-solved); SPD KKT diagonals work
unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .linalg import qr_solve


def _level_ops(A, B, C, stride, T):
    """One cyclic-reduction level on the matrix data: eliminate neighbors at
    distance `stride`, formulated as a full masked update (indices without a
    neighbor this level pass through).  Returns the elimination operators
    (Gm, Gp, im, ip) — enough to replay the level on any RHS — plus the
    reduced (A, B, C)."""
    idx = jnp.arange(T)
    # neighbors at +-stride (clamped; masked out of range)
    im = jnp.clip(idx - stride, 0, T - 1)
    ip = jnp.clip(idx + stride, 0, T - 1)
    has_m = idx - stride >= 0
    has_p = idx + stride <= T - 1

    Bm, Bp = B[im], B[ip]
    # G_m = A_t B_{t-s}^{-1},  G_p = C_t B_{t+s}^{-1}
    Gm = jnp.swapaxes(qr_solve(jnp.swapaxes(Bm, -1, -2),
                               jnp.swapaxes(A, -1, -2)), -1, -2)
    Gp = jnp.swapaxes(qr_solve(jnp.swapaxes(Bp, -1, -2),
                               jnp.swapaxes(C, -1, -2)), -1, -2)
    Gm = jnp.where(has_m[:, None, None], Gm, 0.0)
    Gp = jnp.where(has_p[:, None, None], Gp, 0.0)

    B_new = B - Gm @ C[im] - Gp @ A[ip]
    A_new = -Gm @ A[im]
    C_new = -Gp @ C[ip]
    return (Gm, Gp, im, ip), A_new, B_new, C_new


def _rhs_reduce(b, Gm, Gp, im, ip):
    """Replay one elimination level on a RHS (T, k)."""
    return b - (Gm @ b[im][..., None])[..., 0] \
             - (Gp @ b[ip][..., None])[..., 0]


def solve_block_tridiag(A, B, C, b):
    """Solve the block-tridiagonal system by full cyclic reduction.

    Shapes: A, B, C (T, k, k); b (T, k).  After log₂T doubling levels every
    equation is decoupled (its off-diagonal blocks vanish) and one batched
    solve finishes.  vmap over a leading batch axis for ensembles."""
    T, k, _ = B.shape
    levels = max(1, int(np.ceil(np.log2(max(T, 2)))))
    stride = 1
    for _ in range(levels):
        (Gm, Gp, im, ip), A, B, C = _level_ops(A, B, C, stride, T)
        b = _rhs_reduce(b, Gm, Gp, im, ip)
        stride *= 2
    x = qr_solve(B, b)
    return x


solve_block_tridiag_batch = jax.jit(jax.vmap(solve_block_tridiag))


# --------------------------------------------------------------------------
#  factor / solve split — reuse the reduction operators across many RHS
#  (the production pattern: one factorization per ADMM rho value, one
#  O(log T) solve per iteration)
# --------------------------------------------------------------------------

def cr_factor(A, B, C):
    """Precompute the cyclic-reduction operators (G_m, G_p, index maps and
    per-level eliminated blocks).  Returns an opaque list of level tuples
    consumed by :func:`cr_solve`; matrix-only work — no RHS."""
    T, k, _ = B.shape
    levels = max(1, int(np.ceil(np.log2(max(T, 2)))))
    ops = []
    stride = 1
    for _ in range(levels):
        level, A, B, C = _level_ops(A, B, C, stride, T)
        ops.append(level)
        stride *= 2
    # fold the final block solves into the factorization: per-solve work is
    # then pure batched matvecs
    B_inv = qr_solve(B, jnp.broadcast_to(jnp.eye(k, dtype=B.dtype),
                                         B.shape))
    return ops, B_inv


def cr_solve(factor, b):
    """Apply a precomputed cyclic-reduction factorization to one RHS
    (T, k): O(log T) batched small matvecs only."""
    ops, B_inv = factor
    for Gm, Gp, im, ip in ops:
        b = _rhs_reduce(b, Gm, Gp, im, ip)
    return (B_inv @ b[..., None])[..., 0]


def detect_banded_k(P, A, min_blocks: int = 8, max_k: int = 64) -> int:
    """Auto-detect block-tridiagonal structure of the ADMM KKT matrix
    ``P + σI + A'RA`` from the sparsity patterns of P and A.

    Returns the block size ``k`` (dividing n) with the MOST blocks
    ``Tb = n/k ≥ min_blocks`` such that both P and A'A are block-tridiagonal
    in the given variable ordering — the trajectory-horizon class the
    reference factors as banded dynamics (deprecated/robust_avoid.jl:72-83).
    Returns 0 when no qualifying block size exists (dense route).

    Accepts single (n,n)/(m,n) or batched (B,n,n)/(B,m,n) inputs; for a
    batch the detected structure must hold for the pattern UNION, so one
    ``banded_k`` is valid for every lane.  Cost: O(n²) boolean reductions —
    negligible next to one ADMM factorization."""
    P = np.asarray(P)
    A = np.asarray(A)
    n = P.shape[-1]
    patP = (np.abs(P) > 0)
    if patP.ndim == 3:
        patP = patP.any(axis=0)
    patA = (np.abs(A) > 0)
    if patA.ndim == 3:
        patA = patA.reshape(-1, n)
    best = 0
    for k in range(1, min(max_k, n // min_blocks) + 1):
        if n % k:
            continue
        Tb = n // k
        # block-level patterns: P blocks and A'A blocks via per-row block
        # incidence (avoids forming the n×n product)
        blkP = patP.reshape(Tb, k, Tb, k).any(axis=(1, 3))
        inc = patA.reshape(-1, Tb, k).any(axis=2)          # (m, Tb)
        blkA = inc.T @ inc                                  # (Tb, Tb) counts
        coupled = blkP | (blkA > 0)
        off = np.abs(np.arange(Tb)[:, None] - np.arange(Tb)[None, :]) > 1
        if not coupled[off].any():
            return k            # smallest k = most blocks = biggest win
    return best


def horizon_kkt_blocks(T: int, k: int, rng: np.random.Generator = None,
                       rho: float = 1.0):
    """Build a T-step tracking-with-dynamics KKT in block-tridiagonal form:

        min Σ_t ½ x_t' Q_t x_t − g_t' x_t  s.t.  x_{t+1} = F x_t + c_t

    condensed by dual elimination with penalty ρ — giving diagonal blocks
    B_t = Q_t + ρ(I + F'F) and couplings A_t = −ρF, C_t = −ρF'.  Used by
    tests and the SP-analogue benchmarks."""
    rng = rng or np.random.default_rng(0)
    F = 0.5 * rng.standard_normal((k, k)) / np.sqrt(k)
    Q = []
    g = rng.standard_normal((T, k))
    for _ in range(T):
        G = rng.standard_normal((k, k))
        Q.append(G @ G.T / k + np.eye(k))
    Q = np.stack(Q)
    eye = np.eye(k)
    B = Q + rho * (eye + F.T @ F)[None]
    A = np.repeat((-rho * F)[None], T, axis=0)
    C = np.repeat((-rho * F.T)[None], T, axis=0)
    A[0] = 0.0
    C[-1] = 0.0
    return A, B, C, g


def dense_from_blocks(A, B, C):
    """Assemble the dense matrix (for verification only)."""
    T, k, _ = B.shape
    M = np.zeros((T * k, T * k))
    for t in range(T):
        M[t * k:(t + 1) * k, t * k:(t + 1) * k] = B[t]
        if t > 0:
            M[t * k:(t + 1) * k, (t - 1) * k:t * k] = A[t]
        if t < T - 1:
            M[t * k:(t + 1) * k, (t + 1) * k:(t + 2) * k] = C[t]
    return M
