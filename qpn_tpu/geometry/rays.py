"""Extreme-ray enumeration and unbounded convex hulls.

This closes the one cdd capability the framework had not replaced:
the reference's V-representation bridge returns
and consumes RAYS for unbounded polyhedra (`/root/reference/src/sets.jl:
439-496` — ``vrep_to_poly`` rebuilds H-reps from points + rays, and
``convex_hull`` at `sets.jl:977-1010` works on any union cdd can describe).

One combinatorial primitive powers everything here:

    extreme rays of a polyhedral cone  {d : A d ≥ 0}

enumerated exactly the way ``get_verts_exhaustive`` enumerates vertices —
each extreme ray is the 1-dim null space of some (rank−1)-subset of tight
rows, validated by cone feasibility, deduped by normalized direction, with
the same C(m, k) combinatorial budget.  Lineality (lines) is split off
first as null(A) so the enumeration always runs on a pointed cone.

On top of it:

* :func:`recession` — exact extreme rays + lines of a Poly's recession
  cone (the reference gets these from cdd's double description);
* :func:`hull_of_points_and_rays` — H-rep of conv(V) + cone(R) via
  homogenization: facets a·x ≤ b of the hull are exactly the extreme rays
  of the dual cone {(a, b) : a·vᵢ − b ≤ 0, a·rⱼ ≤ 0}, so the SAME
  enumerator computes unbounded hulls (cdd's remaining role).
"""

from __future__ import annotations

from itertools import combinations
from math import comb
from typing import List, Optional, Tuple

import numpy as np

from .poly import Poly

#: same class of combinatorial budget as geometry.vertices
RAY_BUDGET = 200_000


def _null_space(A: np.ndarray, tol: float = 1e-9) -> np.ndarray:
    """Orthonormal basis (n, k) of null(A); A may have zero rows."""
    n = A.shape[1]
    if A.size == 0:
        return np.eye(n)
    u, s, vt = np.linalg.svd(A, full_matrices=True)
    r = int(np.sum(s > tol * max(1.0, s[0] if s.size else 1.0)))
    return vt[r:].T


def cone_extreme_rays(A: np.ndarray, tol: float = 1e-8,
                      budget: int = RAY_BUDGET
                      ) -> Optional[Tuple[List[np.ndarray],
                                          List[np.ndarray]]]:
    """Exact extreme rays and lineality basis of ``{d : A d ≥ 0}``.

    Returns (rays, lines) with rays unit-normalized, or ``None`` when the
    combinatorial budget C(m, rank−1) is exceeded (callers fall back to
    certificates, mirroring get_verts_exhaustive's contract).
    """
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    # lineality space: directions feasible with their negation, i.e. null(A)
    Lb = _null_space(A)
    lines = [Lb[:, j] for j in range(Lb.shape[1])]
    if Lb.shape[1] == n:        # cone is the whole space (or A empty)
        return [], lines
    # reduce to the pointed cone on the row space: d = Vr y
    u, s, vt = np.linalg.svd(A, full_matrices=False)
    r = int(np.sum(s > 1e-9 * max(1.0, s[0])))
    Vr = vt[:r].T                              # (n, r)
    Ar = A @ Vr                                # (m, r) — pointed cone rows
    scale = np.linalg.norm(Ar, axis=1)
    keep = scale > 1e-12
    Ar = Ar[keep] / scale[keep, None]
    mr = Ar.shape[0]
    rays: List[np.ndarray] = []
    seen = set()

    def _try(d):
        nd = np.linalg.norm(d)
        if nd < 1e-10:
            return
        d = d / nd
        for cand in (d, -d):
            if np.all(Ar @ cand >= -tol):
                # extremality: tight rows at cand must have rank r-1
                tight = Ar[np.abs(Ar @ cand) <= tol]
                if r == 1 or (tight.shape[0] >= r - 1
                              and np.linalg.matrix_rank(tight, tol=1e-9)
                              >= r - 1):
                    key = tuple(np.round(cand, 6))
                    if key not in seen:
                        seen.add(key)
                        rays.append(Vr @ cand)
                return

    if r == 1:
        _try(np.ones(1))
        return rays, lines
    k = r - 1
    if mr < k or comb(mr, k) > budget:
        if mr < k:
            return rays, lines      # too few rows: no extreme rays exist
        return None
    for S in combinations(range(mr), k):
        sub = Ar[list(S)]
        ns = _null_space(sub)
        if ns.shape[1] != 1:        # degenerate subset: rank < r-1
            continue
        _try(ns[:, 0])
    return rays, lines


def recession(p: Poly, tol: float = 1e-8,
              budget: int = RAY_BUDGET
              ) -> Optional[Tuple[List[np.ndarray], List[np.ndarray]]]:
    """Extreme rays + lines of ``p``'s recession cone (sets.jl:456-496 —
    what the reference reads off cdd's V-representation).

    Row ``l ≤ a·x ≤ u``: finite l alone → a·d ≥ 0; finite u alone →
    a·d ≤ 0; both finite → a·d = 0; none → vacuous.
    """
    rows = []
    for i in range(p.m):
        fl, fu = np.isfinite(p.l[i]), np.isfinite(p.u[i])
        if fl:
            rows.append(p.A[i])
        if fu:
            rows.append(-p.A[i])
    A = np.array(rows) if rows else np.zeros((0, p.dim))
    return cone_extreme_rays(A, tol=tol, budget=budget)


def recession_nontrivial(p: Poly, tol: float = 1e-7) -> bool:
    """Cheap boundedness gate: True iff the recession cone has a nonzero
    direction.  Lines are a rank check; pointed-cone nontriviality is ONE
    tiny LP (max Σ A_c y over the cone ∩ unit box — positive optimum iff a
    nonzero feasible direction exists; in the row-rank space any nonzero
    feasible y has Σ A_c y > 0).  Used so the vertex-enumeration hot path
    only pays the combinatorial ray enumeration when actually unbounded."""
    rows = []
    for i in range(p.m):
        fl, fu = np.isfinite(p.l[i]), np.isfinite(p.u[i])
        if fl:
            rows.append(p.A[i])
        if fu:
            rows.append(-p.A[i])
    if not rows:
        return p.dim > 0
    Ac = np.array(rows)
    n = p.dim
    if np.linalg.matrix_rank(Ac, tol=1e-9) < n:
        return True                      # lineality
    from ..ops import batch_qp
    mc = Ac.shape[0]
    A_lp = np.vstack([Ac, np.eye(n)])
    l_lp = np.concatenate([np.zeros(mc), -np.ones(n)])
    u_lp = np.concatenate([np.full(mc, np.inf), np.ones(n)])
    c = -(Ac.T @ np.ones(mc))
    sol = batch_qp.solve_qp_batch_padded(
        np.zeros((1, n, n)), c[None], A_lp[None], l_lp[None], u_lp[None],
        np.ones((1, mc + n), dtype=bool))
    if int(np.asarray(sol.status)[0]) not in (batch_qp.SOLVED,
                                              batch_qp.SOLVED_INACCURATE):
        return True                      # be conservative: check exactly
    return float(-np.asarray(sol.obj)[0]) > tol


def hull_of_points_and_rays(pts: np.ndarray, rays: np.ndarray,
                            lines: np.ndarray = None, tol: float = 1e-6,
                            budget: int = RAY_BUDGET) -> Poly:
    """H-rep of ``conv(pts) + cone(rays) + span(lines)`` (cdd's
    doubledescription role for unbounded hulls, sets.jl:977-1010).

    Homogenization: (a, b) defines a valid face ``a·x ≤ b`` iff
    a·vᵢ − b ≤ 0 for every point and a·rⱼ ≤ 0 for every ray (and a ⟂ every
    line) — a polyhedral cone in (a, b) whose extreme rays are the hull's
    irredundant facets and whose lineality encodes implicit equalities.
    """
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    d = pts.shape[1]
    rays = (np.zeros((0, d)) if rays is None or len(rays) == 0
            else np.atleast_2d(np.asarray(rays, dtype=np.float64)))
    lines = (np.zeros((0, d)) if lines is None or len(lines) == 0
             else np.atleast_2d(np.asarray(lines, dtype=np.float64)))
    # dual cone rows over (a, b):  [-vᵢ, 1]·(a,b) ≥ 0 ; [-rⱼ, 0]·(a,b) ≥ 0
    # lines force equality: ±[lₖ, 0]
    rows = [np.concatenate([-pts, np.ones((pts.shape[0], 1))], axis=1)]
    if rays.shape[0]:
        rows.append(np.concatenate([-rays, np.zeros((rays.shape[0], 1))],
                                   axis=1))
    if lines.shape[0]:
        z = np.zeros((lines.shape[0], 1))
        rows.append(np.concatenate([lines, z], axis=1))
        rows.append(np.concatenate([-lines, z], axis=1))
    Ad = np.vstack(rows)
    out = cone_extreme_rays(Ad, tol=1e-9, budget=budget)
    if out is None:
        raise RuntimeError(
            f"hull_of_points_and_rays: combinatorial budget exceeded "
            f"({pts.shape[0]} points, {rays.shape[0]} rays, dim {d})")
    facets, dual_lines = out
    A_rows, lbs, ubs = [], [], []
    for f in facets:
        a, b = f[:d], f[d]
        na = np.linalg.norm(a)
        if na < 1e-10:
            continue                      # (0, 1): the vacuous 0 ≤ b face
        A_rows.append(a / na)
        lbs.append(-np.inf)
        ubs.append(b / na)
    # dual lineality (a, b) with both signs valid ⇒ a·x = b on the hull:
    # implicit equalities of a non-full-dimensional hull
    for f in dual_lines:
        a, b = f[:d], f[d]
        na = np.linalg.norm(a)
        if na < 1e-10:
            continue
        A_rows.append(a / na)
        lbs.append(b / na)
        ubs.append(b / na)
    if not A_rows:
        raise RuntimeError("hull_of_points_and_rays: no facets found")
    return Poly(np.array(A_rows), np.array(lbs), np.array(ubs)).simplify()
