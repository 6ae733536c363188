"""Batched dense linear-algebra building blocks for the equilibrium core.

Every linear solve here goes through Cholesky (SPD) or QR (general), both
batched-friendly.  The policy dates from an earlier accelerator that had no
f64 LU; the GPU has one, and whether LU should come back is ROADMAP C2.
These replace the reference's LAPACK ``\\`` calls (qp_processing.jl:115, sets.jl:761, 798).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def chol_solve(K, b):
    """Solve SPD ``K x = b`` via Cholesky. Supports leading batch dims."""
    L = jnp.linalg.cholesky(K)
    w = jax.scipy.linalg.solve_triangular(L, b, lower=True)
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), w, lower=False)


def qr_solve(A, b):
    """Solve square (or overdetermined least-squares) ``A x = b`` via QR.

    ``b`` may be a vector (…, n) or a matrix of right-hand sides (…, n, k).
    For a square nonsingular A this matches an LU solve; for rank-deficient A
    callers should prefer :func:`ridge_solve`.
    """
    Q, R = jnp.linalg.qr(A)
    if b.ndim == A.ndim:          # matrix RHS
        rhs = jnp.einsum("...ji,...jk->...ik", Q, b)
        return jax.scipy.linalg.solve_triangular(R, rhs, lower=False)
    rhs = jnp.einsum("...ij,...i->...j", Q, b)
    return jax.scipy.linalg.solve_triangular(R, rhs, lower=False)


def ridge_solve(A, b, eps: float = 1e-10):
    """Least-squares/least-norm solve via regularized normal equations:
    ``x = (A'A + eps I)^{-1} A' b``.  Robust to mild rank deficiency; used for
    dual recovery where the reference does ``Ā \\ q̃`` (qp_processing.jl:115).
    """
    n = A.shape[-1]
    K = jnp.einsum("...ji,...jk->...ik", A, A) + eps * jnp.eye(n, dtype=A.dtype)
    Atb = jnp.einsum("...ji,...j->...i", A, b)
    return chol_solve(K, Atb)


def solve_general(A, b, eps: float = 0.0):
    """General square solve without LU: QR when well-posed, ridge fallback.

    ``eps > 0`` adds Tikhonov damping through the normal equations (used by the
    semismooth Newton AVI solver on near-singular Jacobians).
    """
    if eps and eps > 0:
        return ridge_solve(A, b, eps)
    return qr_solve(A, b)


def lstsq_minnorm(A, b, rcond: float = 1e-10):
    """Minimum-norm least-squares via SVD."""
    return jnp.linalg.lstsq(A, b, rcond=rcond)[0]
