"""Extreme-ray enumeration + unbounded hulls (geometry/rays.py) — the cdd
V-representation role for unbounded polyhedra (reference sets.jl:439-496,
977-1010).
"""

import numpy as np
import pytest

from qpn_tpu.geometry.poly import Poly, PolyUnion
from qpn_tpu.geometry.rays import (cone_extreme_rays, hull_of_points_and_rays,
                                   recession)
from qpn_tpu.geometry.vertices import convex_hull, get_verts

INF = np.inf


def _dirset(vecs):
    return {tuple(np.round(v / np.linalg.norm(v), 6)) for v in vecs}


class TestConeRays:
    def test_orthant(self):
        # {d : d >= 0} in 3D: extreme rays are the coordinate axes
        rays, lines = cone_extreme_rays(np.eye(3))
        assert not lines
        assert _dirset(rays) == _dirset(list(np.eye(3)))

    def test_halfspace_has_lineality(self):
        # {d : d1 >= 0} in 2D: line along e2, single ray e1
        rays, lines = cone_extreme_rays(np.array([[1.0, 0.0]]))
        assert _dirset(lines) == _dirset([np.array([0.0, 1.0])])
        assert _dirset(rays) == _dirset([np.array([1.0, 0.0])])

    def test_ice_cream_like_polyhedral_cone(self):
        # {d : d2 >= d1, d2 >= -d1}: rays (1,1) and (-1,1)
        A = np.array([[-1.0, 1.0], [1.0, 1.0]])
        rays, lines = cone_extreme_rays(A)
        assert not lines
        assert _dirset(rays) == _dirset([np.array([1.0, 1.0]),
                                         np.array([-1.0, 1.0])])

    def test_whole_space(self):
        rays, lines = cone_extreme_rays(np.zeros((0, 2)))
        assert not rays and len(lines) == 2


class TestRecession:
    def test_box_is_bounded(self):
        p = Poly(np.eye(2), np.zeros(2), np.ones(2))
        rays, lines = recession(p)
        assert not rays and not lines

    def test_halfstrip(self):
        # [0,1] x [0, inf): single recession ray e2
        p = Poly(np.eye(2), np.zeros(2), np.array([1.0, INF]))
        rays, lines = recession(p)
        assert not lines
        assert _dirset(rays) == _dirset([np.array([0.0, 1.0])])

    def test_slab_has_line(self):
        # {0 <= x1 <= 1}: lineality e2
        p = Poly(np.array([[1.0, 0.0]]), np.array([0.0]), np.array([1.0]))
        rays, lines = recession(p)
        assert not rays
        assert _dirset(lines) == _dirset([np.array([0.0, 1.0])])

    def test_get_verts_returns_exact_rays(self):
        p = Poly(np.eye(2), np.zeros(2), np.array([1.0, INF]))
        V, R, L = get_verts(p)
        assert _dirset(R) == _dirset([np.array([0.0, 1.0])])
        assert not L
        keys = {tuple(np.round(v, 5)) for v in V}
        assert (0.0, 0.0) in keys and (1.0, 0.0) in keys


def _same_set(p: Poly, q: Poly, pts_in, pts_out):
    for x in pts_in:
        assert p.contains(np.asarray(x, float), tol=1e-6), x
        assert q.contains(np.asarray(x, float), tol=1e-6), x
    for x in pts_out:
        assert not p.contains(np.asarray(x, float), tol=1e-6), x
        assert not q.contains(np.asarray(x, float), tol=1e-6), x


class TestUnboundedHull:
    def test_hull_of_two_halfstrips(self):
        # [0,1] x [0,inf)  ∪  [2,3] x [0,inf)  →  hull [0,3] x [0,inf)
        p1 = Poly(np.eye(2), np.zeros(2), np.array([1.0, INF]))
        p2 = Poly(np.eye(2), np.array([2.0, 0.0]), np.array([3.0, INF]))
        h = convex_hull(PolyUnion([p1, p2]))
        expect = Poly(np.eye(2), np.zeros(2), np.array([3.0, INF]))
        _same_set(h, expect,
                  pts_in=[(0, 0), (3, 0), (1.5, 7.0), (0, 100.0)],
                  pts_out=[(-0.1, 0), (3.1, 0), (1.0, -0.1)])

    def test_hull_with_lineality_member(self):
        # slab {0<=x1<=1} ∪ box [2,3]^2 → hull {0<=x1<=3} (x2 free)
        slab = Poly(np.array([[1.0, 0.0]]), np.array([0.0]),
                    np.array([1.0]))
        box = Poly(np.eye(2), np.array([2.0, 2.0]), np.array([3.0, 3.0]))
        h = convex_hull(PolyUnion([slab, box]))
        expect = Poly(np.array([[1.0, 0.0]]), np.array([0.0]),
                      np.array([3.0]))
        _same_set(h, expect,
                  pts_in=[(0, -50), (3, 99), (1.5, 0)],
                  pts_out=[(-0.1, 0), (3.1, 5)])

    def test_points_plus_rays_directly(self):
        pts = np.array([[0.0, 0.0], [1.0, 0.0]])
        rays = np.array([[0.0, 1.0]])
        h = hull_of_points_and_rays(pts, rays)
        expect = Poly(np.eye(2), np.zeros(2), np.array([1.0, INF]))
        _same_set(h, expect,
                  pts_in=[(0, 0), (1, 5), (0.5, 0)],
                  pts_out=[(1.5, 0), (0, -0.2)])

    def test_bounded_hull_unchanged(self):
        p1 = Poly(np.eye(2), np.zeros(2), np.ones(2))
        p2 = Poly(np.eye(2), np.array([2.0, 0.0]), np.array([3.0, 1.0]))
        h = convex_hull(PolyUnion([p1, p2]))
        _same_set(h, h, pts_in=[(0, 0), (3, 1), (1.5, 0.5)],
                  pts_out=[(1.5, 1.2), (-0.1, 0.5)])
