"""Vertex discovery without double description.

The reference enumerates *all* vertices of a piece-slice through cdd
(sets.jl:439-451) and then explores at most ``exploration_vertices`` of them
(avi_solutions.jl:277-321).  Batched, we invert the economics: vertices are
*sampled* as a single batch of LPs with random objectives (every LP optimum of
a pointed polytope is a vertex), polished onto the active set, and deduped by
the reference's own 5-digit quantization.  A batch of K objectives is one
vmapped kernel; K scales with the exploration budget, so we never pay for
vertices the exploration cap would discard anyway.

Degenerate cases follow sets.jl:443-449: zero intrinsic dimension returns the
exemplar point; an empty poly raises.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..ops import batch_qp
from .poly import Poly
from . import setops
from .setops import _abs_close


#: combinatorial budget for exhaustive enumeration: C(#facets, dim) above
#: this falls back to LP sampling (METRICS counter ``verts_sampled_fallback``)
EXHAUSTIVE_LIMIT = 200_000


def _affine_basis(p: Poly, impl: np.ndarray, tol: float = 1e-9):
    """Parameterize the implicit-equality affine hull: x = x0 + Z y.

    Returns (x0, Z, keep_rows) or None when the equality system is
    inconsistent.  ``keep_rows`` masks the non-implicit rows."""
    n = p.dim
    if impl.any():
        Aeq = p.A[impl]
        beq = 0.5 * (p.l[impl] + p.u[impl])
        x0, res, rank, sv = np.linalg.lstsq(Aeq, beq, rcond=None)
        if np.abs(Aeq @ x0 - beq).max(initial=0.0) > 1e-6:
            return None
        # nullspace via SVD
        _, s, vt = np.linalg.svd(Aeq, full_matrices=True)
        r = int((s > max(tol, s[0] * 1e-10 if s.size else 0)).sum())
        Z = vt[r:].T
    else:
        x0 = np.zeros(n)
        Z = np.eye(n)
    return x0, Z, ~impl


def get_verts_exhaustive(p: Poly, impl: np.ndarray = None, tol: float = 1e-6):
    """ALL vertices of the closed polyhedron ``p`` by basis enumeration.

    The cdd-completeness replacement (sets.jl:439-451): every vertex is the
    unique solution of ``k`` linearly independent active facets in the
    ``k``-dimensional affine hull.  Enumerate k-subsets of candidate facet
    hyperplanes, solve all the k×k systems as one stacked LAPACK call, keep
    the feasible ones, dedupe at the reference's 5-digit precision.

    Returns a list of vertices, or None when the combinatorial budget
    C(#facets, k) exceeds EXHAUSTIVE_LIMIT (caller falls back to sampling).
    """
    from itertools import combinations
    from math import comb

    n = p.dim
    if impl is None:
        impl = _abs_close(p.l, p.u, 1e-4)
    ab = _affine_basis(p, impl)
    if ab is None:
        return []                      # inconsistent equalities: empty
    x0, Z, keep = ab
    k = Z.shape[1]
    if k == 0:
        return [x0] if p.contains(x0, tol=1e-4) else []

    # candidate facet hyperplanes in y-space: each finite bound of each
    # non-implicit row contributes (a_y, b) with a_y = A_i Z
    Ay = p.A[keep] @ Z
    off = p.A[keep] @ x0
    lr = p.l[keep] - off
    ur = p.u[keep] - off
    cand_a, cand_b = [], []
    for i in range(Ay.shape[0]):
        nrm = np.linalg.norm(Ay[i])
        if nrm < 1e-12:
            continue
        if np.isfinite(lr[i]):
            cand_a.append(Ay[i])
            cand_b.append(lr[i])
        if np.isfinite(ur[i]) and not _abs_close(lr[i], ur[i], 1e-12):
            cand_a.append(Ay[i])
            cand_b.append(ur[i])
    Mfac = len(cand_a)
    if Mfac < k:
        return []                      # unbounded in some direction: no verts
    if comb(Mfac, k) > EXHAUSTIVE_LIMIT:
        return None
    cand_a = np.array(cand_a)
    cand_b = np.array(cand_b)

    combos = np.array(list(combinations(range(Mfac), k)), dtype=np.int64)
    Asys = cand_a[combos]                      # (C, k, k)
    bsys = cand_b[combos]                      # (C, k)
    # mask singular bases via determinant magnitude (scaled)
    det = np.abs(np.linalg.det(Asys))
    row_sc = np.maximum(np.linalg.norm(Asys, axis=2).prod(axis=1), 1e-30)
    ok = det > 1e-9 * row_sc
    if not ok.any():
        return []
    Y = np.full((len(combos), k), np.nan)
    Y[ok] = np.linalg.solve(Asys[ok], bsys[ok][..., None])[..., 0]
    # feasibility of every candidate against all rows (vectorized)
    vals = Y @ Ay.T                            # (C, m)
    feas = ok & np.all(
        (vals >= np.where(np.isfinite(lr), lr, -np.inf)[None, :] - 1e-6) &
        (vals <= np.where(np.isfinite(ur), ur, np.inf)[None, :] + 1e-6),
        axis=1)
    verts = []
    seen = set()
    for y in Y[feas]:
        x = x0 + Z @ y
        key = tuple(np.round(x, 5))
        if key not in seen:
            seen.add(key)
            verts.append(x)
    return verts


def get_verts_batch(polys, rng: np.random.Generator = None,
                    num_samples: int = None, tol: float = 1e-6):
    """Vertex sampling for MANY polys at once: all emptiness checks, implicit
    bounds and random-objective LPs across every poly fuse into single
    padded kernel calls (the per-piece version loops them)."""
    polys = list(polys)
    if rng is None:
        rng = np.random.default_rng(0)
    if not polys:
        return []
    from ..utils.metrics import METRICS
    empty, examples = setops.exemplar_batch(polys)
    results = [None] * len(polys)
    # complete enumeration first (cdd parity, sets.jl:439-451): needs only
    # the cheap l==u equality detection — support-function implicit-bound
    # LPs are skipped entirely for exhaustively enumerable slices (the
    # common case), which removes 2m LP solves per piece from the hot path
    fallback = []
    for pi, p in enumerate(polys):
        if empty[pi]:
            results[pi] = "empty"
            continue
        impl0 = _abs_close(p.l, p.u, 1e-4)
        V = get_verts_exhaustive(p, impl0, tol)
        if V is not None:
            METRICS.bump("verts_exhaustive")
            if not V and examples[pi] is not None:
                V = [np.asarray(examples[pi])]
            results[pi] = (V, [], [])
        else:
            fallback.append(pi)
    # batched implicit-equality detection for intrinsic dim (fallback only)
    impl_list = {}
    todo_polys, todo_dirs, owners = [], [], []
    for pi in fallback:
        p = polys[pi]
        impl = _abs_close(p.l, p.u, 1e-4)
        impl_list[pi] = impl
        for i in range(p.m):
            if not impl[i]:
                todo_polys += [p, p]
                todo_dirs += [p.A[i], -p.A[i]]
                owners.append((pi, i))
    if owners:
        v, s = setops.support_batch(todo_polys, todo_dirs)
        for k, (pi, i) in enumerate(owners):
            lo_v, lo_s = v[2 * k], s[2 * k]
            hi_v, hi_s = v[2 * k + 1], s[2 * k + 1]
            if lo_s in (1, 2) and hi_s in (1, 2) and \
                    _abs_close(lo_v, -hi_v, 1e-4):
                impl_list[pi][i] = True
    # batched random-objective vertex LPs
    q_polys, q_dirs, q_owner = [], [], []
    for pi in fallback:
        p = polys[pi]
        Aim = p.A[impl_list[pi]]
        ridim = int(np.linalg.matrix_rank(Aim)) if Aim.size else 0
        if p.dim - ridim == 0:
            results[pi] = ([np.asarray(examples[pi])], [], [])
            continue
        METRICS.bump("verts_sampled_fallback")
        n = p.dim
        ns = num_samples or max(2 * n, 8)
        dirs = np.vstack([rng.standard_normal((ns, n)), np.eye(n), -np.eye(n)])
        for d in dirs:
            q_polys.append(p)
            q_dirs.append(d)
            q_owner.append(pi)
    if q_polys:
        from ..config import row_bucket
        from collections import defaultdict
        groups = defaultdict(list)
        for k, p in enumerate(q_polys):
            groups[(p.dim, row_bucket(max(p.m, 1)))].append(k)
        X = [None] * len(q_polys)
        St = [0] * len(q_polys)
        for (n, mp), idxs in groups.items():
            As, ls, us, masks = [], [], [], []
            for k in idxs:
                A, l, u, mask = setops._pad_rows(q_polys[k].A, q_polys[k].l,
                                                 q_polys[k].u, mp)
                As.append(A)
                ls.append(l)
                us.append(u)
                masks.append(mask)
            sol = batch_qp.solve_qp_batch_padded(
                np.zeros((len(idxs), n, n)),
                np.array([q_dirs[k] for k in idxs]),
                np.array(As), np.array(ls), np.array(us), np.array(masks))
            for j, k in enumerate(idxs):
                X[k] = np.asarray(sol.x[j])
                St[k] = int(sol.status[j])
        per_poly_verts = {pi: [] for pi in range(len(polys))}
        for k, pi in enumerate(q_owner):
            if St[k] not in (batch_qp.SOLVED, batch_qp.SOLVED_INACCURATE):
                continue
            x = _polish_vertex(q_polys[k], X[k], tol)
            if x is not None:
                per_poly_verts[pi].append(x)
        for pi, p in enumerate(polys):
            if results[pi] is not None:
                continue
            seen = set()
            V = []
            for x in per_poly_verts[pi]:
                key = tuple(np.round(x, 5))
                if key not in seen:
                    seen.add(key)
                    V.append(x)
            if not V and examples[pi] is not None:
                V = [np.asarray(examples[pi])]
            results[pi] = (V, [], [])
    return results


def get_verts(p: Poly, rng: np.random.Generator = None, num_samples: int = None,
              tol: float = 1e-6):
    """Sample vertices of the closed polyhedron ``p``.

    Returns (V, R, L): vertex list, ray list, line list.  Rays/lines are
    reported only as a boundedness flag side effect: if some sampled LP is
    unbounded, its direction is recovered as a ray estimate (rarely needed —
    the enumeration pipeline consumes only V, avi_solutions.jl:253-256).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    n = p.dim
    if num_samples is None:
        num_samples = max(2 * n, 8)

    empty, example = setops.exemplar_batch([p])
    if empty[0]:
        raise RuntimeError("get_verts called on empty polyhedron")

    # exhaustive enumeration first: it needs only the cheap l==u equality
    # mask, while intrinsic_dim pays up to 2m support LPs (implicit_bounds)
    # — the exact cost get_verts_batch skips on its fast path too.  The
    # 0-dim exemplar shortcut only matters on the sampling fallback.
    V = get_verts_exhaustive(p, tol=tol)
    if V is not None:
        R, L = [], []
        from .rays import recession, recession_nontrivial
        if recession_nontrivial(p):
            rec = recession(p)
            if rec is not None:
                R, L = rec
        if not V and example[0] is not None:
            V = [np.asarray(example[0])]
        return V, R, L

    idim = setops.intrinsic_dim(p)
    if idim == 0:
        return [np.asarray(example[0])], [], []

    dirs = rng.standard_normal((num_samples, n))
    # include +-coordinate directions for coverage of axis-aligned faces
    eye = np.eye(n)
    dirs = np.vstack([dirs, eye, -eye])

    # one batched LP per direction fetches minimizer AND status (an extra
    # support_batch pass here would solve every LP twice for values alone)
    m = p.m
    A, l, u, mask = setops._pad_rows(p.A, p.l, p.u, m)
    B = dirs.shape[0]
    sol = batch_qp.solve_qp_batch_padded(
        np.zeros((B, n, n)), dirs,
        np.repeat(A[None], B, axis=0), np.repeat(l[None], B, axis=0),
        np.repeat(u[None], B, axis=0), np.repeat(mask[None], B, axis=0))
    X = np.asarray(sol.x)
    St = np.asarray(sol.status)

    V: List[np.ndarray] = []
    R: List[np.ndarray] = []
    L: List[np.ndarray] = []
    seen = set()
    unbounded_hit = False
    for k in range(B):
        if St[k] == batch_qp.DUAL_INFEASIBLE:
            if not unbounded_hit:
                unbounded_hit = True
                # exact extreme rays + lines of the recession cone
                # (sets.jl:456-496 V-rep parity); certificate direction
                # only if the combinatorial budget is exceeded
                from .rays import recession
                rec = recession(p)
                if rec is not None:
                    R, L = rec
                else:
                    R.append(-dirs[k])
            continue
        if St[k] not in (batch_qp.SOLVED, batch_qp.SOLVED_INACCURATE):
            continue
        x = X[k]
        x = _polish_vertex(p, x, tol)
        if x is None:
            continue
        key = tuple(np.round(x, 5))
        if key not in seen:
            seen.add(key)
            V.append(x)
    if not V and example[0] is not None:
        V = [np.asarray(example[0])]
    return V, R, L


def _polish_vertex(p: Poly, x, tol):
    """Snap an LP optimum onto the exact intersection of its active rows."""
    ax = p.A @ x
    act_rows = []
    rhs = []
    for i in range(p.m):
        if np.isfinite(p.l[i]) and abs(ax[i] - p.l[i]) < 1e-5:
            act_rows.append(p.A[i]); rhs.append(p.l[i])
        elif np.isfinite(p.u[i]) and abs(ax[i] - p.u[i]) < 1e-5:
            act_rows.append(p.A[i]); rhs.append(p.u[i])
    if not act_rows:
        return x
    Aact = np.array(act_rows)
    b = np.array(rhs)
    # least-squares snap (keeps x if active set is rank deficient)
    x_new, *_ = np.linalg.lstsq(Aact, b, rcond=None)
    if np.linalg.matrix_rank(Aact) < p.dim:
        # not a unique vertex: project x onto the active affine set instead
        x_new = x - np.linalg.pinv(Aact) @ (Aact @ x - b)
    if p.contains(x_new, tol=1e-4):
        return x_new
    return x if p.contains(x, tol=1e-4) else None


def convex_hull(pu, tol: float = 1e-6) -> Poly:
    """Convex hull of a union via sampled vertices (sets.jl:977-1010).

    Bounded unions: facet enumeration / polar duality on the vertex cloud.
    Unbounded members contribute their EXACT recession rays/lines
    (geometry.rays.recession) and the hull is rebuilt from points + rays by
    homogenized dual-cone enumeration — the cdd doubledescription role
    (sets.jl:439-496) fully replaced.  Boundedness is checked EXPLICITLY
    per member (±eᵢ support LPs): the exhaustive vertex path reports
    vertices regardless of recession directions, so relying on get_verts
    rays alone would let an unbounded member slip through as bounded."""
    from .rays import hull_of_points_and_rays, recession
    all_verts, all_rays, all_lines = [], [], []
    for p in pu:
        dirs = np.vstack([np.eye(p.dim), -np.eye(p.dim)])
        vals, _ = setops.support_batch([p] * dirs.shape[0], list(dirs))
        if not np.all(np.isfinite(np.asarray(vals))):
            rec = recession(p)
            if rec is None:
                raise RuntimeError(
                    "convex_hull: recession-ray budget exceeded for "
                    "unbounded member")
            all_rays.extend(rec[0])
            all_lines.extend(rec[1])
            if rec[1]:
                # vertex-free member (lineality): the minimal generators
                # are the vertices of p ∩ L⊥ — pin each line direction so
                # the reduced member is pointed, then enumerate those
                Lmat = np.array(rec[1])
                A2 = np.vstack([p.A, Lmat])
                _, ex = setops.exemplar_batch([p])
                x_ref = (np.asarray(ex[0]) if ex[0] is not None
                         else np.zeros(p.dim))
                lv = Lmat @ x_ref
                p = Poly(A2, np.concatenate([p.l, lv]),
                         np.concatenate([p.u, lv]))
        V, R, L = get_verts(p)
        all_rays.extend(R)
        all_lines.extend(L)
        all_verts.extend(V)
    if all_rays or all_lines:
        return hull_of_points_and_rays(
            np.array(all_verts),
            np.array(all_rays) if all_rays else None,
            np.array(all_lines) if all_lines else None, tol)
    return hull_of_points(np.array(all_verts), tol)


def hull_of_points(pts: np.ndarray, tol: float = 1e-6) -> Poly:
    """H-rep hull of a point cloud (sets.jl:977-1010, cdd role).

    Low dimension: direct facet enumeration over point d-subsets.
    Higher dimension: polar duality — after centering, the facets of
    conv(V) are the vertices of the polar dual ``{y : y·v ≤ 1 ∀v}``, an
    H-polytope handled by :func:`get_verts_exhaustive` (same combinatorial
    budget; full-dimensional clouds only)."""
    npts, d = pts.shape
    if d > 4 or npts > 64:
        return _hull_via_polar(pts, tol)
    from itertools import combinations
    rows, lbs, ubs = [], [], []
    for comb in combinations(range(npts), d):
        P = pts[list(comb)]
        # hyperplane through the d points: normal in null space of differences
        Dm = P[1:] - P[0]
        if d == 1:
            normal = np.ones(1)
        else:
            _, s, vt = np.linalg.svd(Dm, full_matrices=True)
            # the d points must span a unique (d-1)-dim hyperplane: rank of
            # the difference matrix must be exactly d-1 (degenerate subsets —
            # collinear triples etc. — would emit spurious facets)
            if s.size < d - 1 or s[d - 2] < 1e-9 * max(s[0], 1.0):
                continue
            normal = vt[-1]
        if np.linalg.norm(normal) < tol:
            continue
        off = normal @ P[0]
        side = pts @ normal - off
        if np.all(side <= tol):
            rows.append(normal); lbs.append(-np.inf); ubs.append(off)
        elif np.all(side >= -tol):
            rows.append(-normal); lbs.append(-np.inf); ubs.append(-off)
    if not rows:
        raise RuntimeError("hull_of_points: no facets found")
    return Poly(np.array(rows), np.array(lbs), np.array(ubs)).simplify()


def _hull_via_polar(pts: np.ndarray, tol: float = 1e-6) -> Poly:
    """General-dimension hull by polar duality (requires a full-dimensional
    cloud: the centered points must span R^d so 0 is interior)."""
    npts, d = pts.shape
    c = pts.mean(axis=0)
    V = pts - c
    if np.linalg.matrix_rank(V, tol=1e-9) < d:
        raise RuntimeError(
            "hull_of_points: degenerate (non-full-dimensional) cloud in "
            f"dim {d}; project first")
    # polar dual: y·v ≤ 1 for every point (redundant interior points only
    # add redundant dual rows — harmless)
    dual = Poly(V, np.full(npts, -np.inf), np.ones(npts))
    Y = get_verts_exhaustive(dual, np.zeros(npts, dtype=bool), tol)
    if Y is None:
        raise RuntimeError(
            "hull_of_points: combinatorial budget exceeded "
            f"({npts} points, dim {d})")
    rows, ubs = [], []
    for y in Y:
        nrm = np.linalg.norm(y)
        if nrm < 1e-12:
            continue
        # facet in original coordinates: y·(x − c) ≤ 1
        rows.append(y)
        ubs.append(1.0 + float(y @ c))
    if not rows:
        raise RuntimeError("hull_of_points: no facets found (polar)")
    return Poly(np.array(rows), np.full(len(rows), -np.inf),
                np.array(ubs)).simplify()
