"""Enumeration-layer tests: comp_indices labels, recipe products, local_piece
bounds table, solution-graph generation (avi_solutions.jl semantics)."""

import numpy as np
import pytest

from qpn_tpu.enumeration import (comp_indices, all_Ks, local_piece,
                                 LocalGAVISolutions, process_solution_graph,
                                 quantize)
from qpn_tpu.network import Quadratic, QP
from qpn_tpu.ops.avi import GAVI


def _scalar_follower_gavi():
    """KKT GAVI of: min_y (y - w)^2 s.t. y >= 0 (z=[y, lam], w param).

    M = [2, -1] (dQ/dy, -A'), N = [-2], A = [1, 0], bounds y>=0."""
    return GAVI(M=np.array([[2.0, -1.0]]), N=np.array([[-2.0]]),
                o=np.array([0.0]),
                l1=np.array([-np.inf]), u1=np.array([np.inf]),
                A=np.array([[1.0, 0.0]]), B=np.array([[0.0]]),
                l2=np.array([0.0]), u2=np.array([np.inf]))


def test_comp_indices_strict_interior():
    g = _scalar_follower_gavi()
    # w=2: solution y=2, lam=0 (constraint inactive): row1 label 2; row2 label 9->...
    J = comp_indices(g, np.array([2.0, 0.0]), np.array([2.0]))
    assert J[0] == {2}
    # block-2 row: lam=0 (r2=0), s2=y=2 in (0, inf): label 6 (i.e. 2+4)
    assert J[1] == {6}


def test_comp_indices_weak():
    g = _scalar_follower_gavi()
    # w=0: y=0, lam=0: boundary AND multiplier zero — weak row gets 2 labels
    J = comp_indices(g, np.array([0.0, 0.0]), np.array([0.0]))
    assert J[1] == {5, 6}
    Ks = all_Ks(J)
    assert len(Ks) == 2


def test_local_piece_regions():
    g = _scalar_follower_gavi()
    # label (2, 6): stationarity equality + constraint inactive: piece w >= 0
    piece, _ = local_piece(g, 2, 1, (2, 6))
    # piece is over (y, lam, w): y=w, lam=0, y >= 0
    assert piece.contains(np.array([1.0, 0.0, 1.0]), tol=1e-6)
    assert not piece.contains(np.array([1.0, 0.0, 2.0]), tol=1e-4)
    # label (2, 5): constraint active at lower: y=0, lam=-2w -> needs lam>=0: w<=0
    piece2, _ = local_piece(g, 2, 1, (2, 5))
    assert piece2.contains(np.array([0.0, 2.0, -1.0]), tol=1e-6)
    assert not piece2.contains(np.array([0.0, -2.0, 1.0]), tol=1e-4)


def test_solution_graph_scalar_follower():
    """The solution map of min_y (y-w)^2 s.t. y>=0 is y = max(w, 0):
    two pieces meeting at the kink; seeding at the kink finds both."""
    Q = np.array([[0.0, 0.0], [0.0, 2.0]])  # vars (w, y)
    q = np.zeros(2)
    # cost (y - w)^2 => Q = [[2,-2],[-2,2]]; use that
    Q = np.array([[2.0, -2.0], [-2.0, 2.0]])
    f = Quadratic(Q, q, 0.0)
    qp = QP(f=f, constraint_indices=[1], var_indices=[1])
    from qpn_tpu.geometry.poly import Poly
    cons = [Poly(np.array([[0.0, 1.0]]), [0.0], [np.inf])]
    x = np.zeros(2)       # at the kink w=0, y=0
    lam = np.zeros(1)
    gen = process_solution_graph(qp, cons, [1], x, lam)
    pieces = gen.collect()
    assert len(pieces) >= 2
    # pieces live in (x) = (w, y) space: check the two branches
    def in_any(pt):
        return any(p.contains(np.array(pt), tol=1e-6) for p in pieces)
    assert in_any([1.0, 1.0])     # y=w branch
    assert in_any([-1.0, 0.0])    # y=0 branch
    assert not in_any([1.0, 0.0])
    assert not in_any([-1.0, 0.5])


def test_quantize_dedup():
    a = quantize(np.array([0.1234567, 1.0]))
    b = quantize(np.array([0.1234572, 1.0]))
    c = quantize(np.array([0.1234467, 1.0]))
    assert a == b
    assert a != c


def test_vertex_exploration_budget():
    """max_vertices=0 disables exploration entirely (the default path,
    programs.jl:69)."""
    g = _scalar_follower_gavi()
    sols = LocalGAVISolutions(g, np.array([0.0, 0.0]), np.array([0.0]),
                              0, 0, [0], [1], max_vertices=0)
    pieces = sols.collect()
    assert len(pieces) >= 2
    assert len(sols.explored_vertices) == 1   # only the seed point


class TestVertexCompleteness:
    """exploration must not miss pieces that a missed
    dual-slice vertex would have unlocked.  A redundant constraint through
    the corner of the nonnegative orthant makes the dual solution set a
    SEGMENT (degenerate): with exhaustive slice-vertex enumeration the
    discovered piece set is seed-independent — the same from an interior
    dual point as from either dual vertex."""

    def _gavi(self):
        from qpn_tpu.ops.avi import GAVI
        A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])   # redundant row
        return GAVI(M=np.hstack([np.eye(2), -A.T]), N=-np.eye(2),
                    o=np.zeros(2),
                    l1=np.full(2, -np.inf), u1=np.full(2, np.inf),
                    A=np.hstack([A, np.zeros((3, 3))]), B=np.zeros((3, 2)),
                    l2=np.zeros(3), u2=np.full(3, np.inf))

    @staticmethod
    def _pieces(gavi, lam):
        from qpn_tpu.enumeration import LocalGAVISolutions
        w = np.array([-1.0, -1.0])
        z = np.concatenate([np.zeros(2), lam])
        gen = LocalGAVISolutions(gavi, z, w, 0, 0, [0, 1], [0, 1],
                                 max_vertices=10 ** 6)
        return {(tuple(np.round(p.A.flatten(), 5)), tuple(np.round(p.l, 5)),
                 tuple(np.round(p.u, 5))) for p in gen.collect()}

    def test_seed_independent_piece_discovery(self):
        gavi = self._gavi()
        # dual solutions at w=(-1,-1), x=0: λ1+λ3 = λ2+λ3 = 1, λ ≥ 0 — a
        # segment λ3 ∈ [0,1]; enumerate from its interior and both endpoints
        interior = self._pieces(gavi, np.array([0.5, 0.5, 0.5]))
        v0 = self._pieces(gavi, np.array([1.0, 1.0, 0.0]))
        v1 = self._pieces(gavi, np.array([0.0, 0.0, 1.0]))
        assert interior == v0 == v1
        assert len(interior) == 4


def test_frontier_resume_with_pending_vertices(tmp_path):
    """The generation checkpoint lands BETWEEN expansion and the vertex
    pull, so a restored frontier can hold pending VERTICES with an empty
    recipe set; collect() must pull them instead of exiting immediately
    (regression: a resumed multi-generation enumeration returned a
    truncated piece set)."""
    from qpn_tpu.ops.avi import GAVI
    from qpn_tpu.utils.checkpoint import FrontierStore

    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])   # redundant row
    gavi = GAVI(M=np.hstack([np.eye(2), -A.T]), N=-np.eye(2),
                o=np.zeros(2),
                l1=np.full(2, -np.inf), u1=np.full(2, np.inf),
                A=np.hstack([A, np.zeros((3, 3))]), B=np.zeros((3, 2)),
                l2=np.zeros(3), u2=np.full(3, np.inf))
    w = np.array([-1.0, -1.0])
    z = np.concatenate([np.zeros(2), np.array([0.5, 0.5, 0.5])])

    def key_set(pieces):
        return {(tuple(np.round(p.A.flatten(), 5)), tuple(np.round(p.l, 5)),
                 tuple(np.round(p.u, 5))) for p in pieces}

    full = LocalGAVISolutions(gavi, z, w, 0, 0, [0, 1], [0, 1],
                              max_vertices=10 ** 6)
    truth = key_set(full.collect())
    assert len(truth) >= 2        # multi-generation instance

    store = FrontierStore(str(tmp_path / "f"))
    gen = LocalGAVISolutions(gavi, z, w, 0, 0, [0, 1], [0, 1],
                             max_vertices=10 ** 6, frontier_store=store)
    # kill after ONE generation: checkpoint has pending vertices, no Ks
    Ks = list(gen.unexplored_Ks)
    gen.explored_Ks |= gen.unexplored_Ks
    gen.unexplored_Ks = set()
    gen._absorb(gen._expand_batch(Ks))
    gen._checkpoint()
    assert not gen.unexplored_Ks and gen.unexplored_vertices
    del gen

    gen2 = LocalGAVISolutions(gavi, z, w, 0, 0, [0, 1], [0, 1],
                              max_vertices=10 ** 6, frontier_store=store)
    assert key_set(gen2.collect()) == truth


def test_frontier_key_depends_on_exploration_settings():
    """A stored frontier computed under one vertex budget (or request set)
    must not be resumed under another: the key must differ."""
    from qpn_tpu.enumeration import LocalGAVISolutions
    from qpn_tpu.ops.avi import GAVI
    g = GAVI(M=np.eye(1), N=np.zeros((1, 1)), o=np.zeros(1),
             l1=np.zeros(1), u1=np.full(1, np.inf),
             A=np.zeros((0, 1)), B=np.zeros((0, 1)),
             l2=np.zeros(0), u2=np.zeros(0))

    def key(mv):
        s = LocalGAVISolutions(g, np.zeros(1), np.zeros(1), 0, 0, [0], [0],
                               max_vertices=mv)
        return s._frontier_key()

    assert key(10) != key(1000)
    assert key(10) == key(10)


def test_solve_clears_stale_frontier_store(tmp_path):
    """solve() without checkpoint_path must not silently keep resuming (or
    writing) frontiers from an earlier checkpointed run on the same QPNet."""
    import qpn_tpu as qt
    qpn = qt.setup("simple_bilevel", gen_solution_map=True)
    x0 = np.array([0.0, 1.0, 0.0, 0.0])
    ret = qt.solve(qpn, x0, checkpoint_path=str(tmp_path / "ck"))
    assert ret.solved
    assert qpn.frontier_store is not None   # checkpointed run attaches
    # after a checkpointed solve, a plain solve must detach the store
    qt.solve(qpn, x0)
    assert getattr(qpn, "frontier_store", None) is None
