"""End-to-end exercise of the requests subsystem.

The reference wires requests through signatures but the negotiation loop is
dead code (requests.jl:22 early-return); the *components* — request-granted
labels in comp_indices (avi_solutions.jl:522-541), identify_request /
propagate_request (avi.jl:479-537) — define the design intent
(requests.jl:6-17): a parent asks the child's solution map to extend toward
a direction, and piece discovery grants boundary labels along it.

These tests drive that chain live: a request direction measurably CHANGES
the discovered piece set of a parametric GAVI, and the identified request
maps back through the projection parents.
"""

import numpy as np

from qpn_tpu.enumeration import (LocalGAVISolutions, all_Ks, comp_indices,
                                 process_solution_graph)
from qpn_tpu.network import Linear
from qpn_tpu.ops.avi import GAVI
from qpn_tpu.requests import identify_request, propagate_request


def _follower_gavi():
    """KKT GAVI of  min ½(x−w)²  s.t. x ≥ 0:  z = [x; λ], w scalar::

        x − w − λ ⟂ x free
        λ         ⟂ 0 ≤ x ≤ ∞
    """
    return GAVI(
        M=np.array([[1.0, -1.0]]), N=np.array([[-1.0]]), o=np.zeros(1),
        l1=np.array([-np.inf]), u1=np.array([np.inf]),
        A=np.array([[1.0, 0.0]]), B=np.array([[0.0]]),
        l2=np.array([0.0]), u2=np.array([np.inf]))


class TestRequestsChangePieceDiscovery:
    def test_request_extends_solution_map(self):
        gavi = _follower_gavi()
        z = np.array([1.0, 0.0])       # solution at w=1 (interior: x=1, λ=0)
        w = np.array([1.0])

        def enumerate_with(request):
            gen = LocalGAVISolutions(gavi, z, w, 0, 0, [0], [1])
            gen.permuted_request = request
            J = comp_indices(gavi, z, w, request)
            gen.unexplored_Ks = all_Ks(J)
            return gen.collect()

        base = enumerate_with(frozenset())
        # request along a2 = −[e_λ; B_i]: "extend toward larger λ" — grants
        # the s-at-lower-bound label (x = 0, λ ≥ 0), discovering the piece
        # valid for w ≤ 0 that plain local enumeration at w=1 cannot see
        req = frozenset([Linear(np.array([0.0, -1.0, 0.0]))])
        extended = enumerate_with(req)
        assert len(extended) > len(base), (
            f"request did not extend the map: {len(base)} -> {len(extended)}")

    def test_granted_labels_in_comp_indices(self):
        gavi = _follower_gavi()
        z = np.array([1.0, 0.0])
        w = np.array([1.0])
        J0 = comp_indices(gavi, z, w)
        req = frozenset([Linear(np.array([0.0, -1.0, 0.0]))])
        J1 = comp_indices(gavi, z, w, req)
        assert all(a <= b for a, b in zip(J0, J1))      # only ever grows
        assert J0 != J1                                  # and did grow


class TestRequestsThroughSolve:
    """options.make_requests wired through solve_base:
    requests are identified from the parent's verification duals on
    child-graph rows, negotiated in a re-solve round, and the child's
    DISCOVERED SOLUTION GRAPH CHANGES — while the equilibrium point and the
    no-request trajectory stay identical."""

    @staticmethod
    def _build(make_requests):
        from qpn_tpu.frontend import QPNetBuilder, variable
        w = variable("w")
        x = variable("x")
        b = QPNetBuilder(w, x)
        # follower: min ½(x−w)²  s.t. x ≥ 0  — solution map has two pieces
        # (x=w for w≥0; x=0 for w≤0) but local enumeration at the leader's
        # optimum (w≈1.82) can only see the first
        cid = b.add_constraint([x], [0.0], [np.inf])
        fid = b.add_qp((x - w) ** 2, [cid], x)
        # leader pulls x toward 2, so its duals on the child-graph equality
        # row x−w=0 are active — the request source
        lid = b.add_qp((x - 2.0) ** 2 + 0.1 * w ** 2, [], w)
        b.add_edges([(lid, fid)])
        b.set_options(gen_solution_map=True, make_requests=make_requests,
                      exploration_vertices=0)
        return b.net, fid

    def test_make_requests_extends_discovered_graph(self):
        from qpn_tpu.algorithm import solve
        from qpn_tpu.utils.metrics import METRICS

        net0, fid = self._build(False)
        ret0 = solve(net0, np.array([1.0, 1.0]))
        assert ret0.solved
        base_pieces = len(ret0.Sol[fid])

        net1, fid = self._build(True)
        ret1 = solve(net1, np.array([1.0, 1.0]))
        assert ret1.solved
        # the equilibrium itself must not move...
        assert np.allclose(ret0.x_opt, ret1.x_opt, atol=1e-6)
        # ...but the negotiated graph gains the far-side piece (x=0, w≤0)
        assert len(ret1.Sol[fid]) > base_pieces
        assert METRICS.counters.get("request_rounds", 0) >= 1
        # the extension piece contains (w,x)=(−1,0): only reachable via the
        # request-granted boundary label
        pt = np.array([-1.0, 0.0])
        assert any(p.contains(pt, tol=1e-6) for p in ret1.Sol[fid])
        assert not any(p.contains(pt, tol=1e-6) for p in ret0.Sol[fid])


class TestIdentifyPropagate:
    def test_identify_request_through_parent(self):
        """Active duals on child-graph rows map through ProjectedPoly
        parents into request directions (avi.jl:479-506)."""
        from qpn_tpu.geometry.poly import Poly
        parent = Poly(np.array([[1.0, 0.0], [0.0, 1.0]]),
                      np.array([0.0, 0.0]), np.array([2.0, 2.0]))
        S = Poly(np.array([[1.0, 0.0]]), np.array([0.0]), np.array([2.0]))
        S.parent = parent
        S.row_parents = [parent]
        reqs = identify_request(S, np.array([1.0]))
        assert len(reqs) >= 1
        for r in reqs:
            assert isinstance(r, Linear)

    def test_propagate_request_duals(self):
        from qpn_tpu.geometry.poly import Poly
        box = Poly(np.eye(2), np.zeros(2), np.ones(2))
        out = propagate_request(np.array([1.0, 0.0]), box)
        # minimizing +x over the box activates the x >= 0 facet
        assert any(np.allclose(r.a, [1.0, 0.0]) for r in out)


class TestGrantDirectionsWithParameterCoupling:
    """The grant-direction matrices must match the gradients of the rows
    local_piece emits — i.e. what propagate_request actually produces:
    ∇r1 = [M N] (not [M 0]) and ∇r2 = [0 I 0] (not [0 I B]).  With N or B
    nonzero the old matrices silently never matched (the e2e tests above
    pass only because their N and B blocks vanish)."""

    def test_block1_r_direction_includes_N(self):
        # r1 = M z + N w + o with N nonzero; finite box on z1
        gavi = GAVI(
            M=np.array([[1.0, -1.0]]), N=np.array([[-1.0]]), o=np.zeros(1),
            l1=np.array([0.0]), u1=np.array([1.0]),
            A=np.array([[1.0, 0.0]]), B=np.array([[0.0]]),
            l2=np.array([0.0]), u2=np.array([np.inf]))
        # z1 = 0 = l1 with r1 = 0.5 > 0: strict label 1 only
        z = np.array([0.0, 0.0])
        w = np.array([-0.5])
        base = comp_indices(gavi, z, w)
        assert base[0] == {1}
        # direction that DECREASES r1 = +[M N] row = [1, -1, -1]; grants
        # label 3 (z1 at u1).  The old [M 0] matrix only matched
        # [1, -1, 0], which propagate_request never produces when N != 0.
        req = (Linear(np.array([1.0, -1.0, -1.0])),)
        granted = comp_indices(gavi, z, w, req)
        assert 3 in granted[0] - base[0], (
            "a [M N]-built request direction must grant a new label")

    def test_block2_r_direction_excludes_B(self):
        # z2-direction requests are pure [0 I 0]; a B-contaminated matrix
        # would reject them whenever B != 0
        gavi = GAVI(
            M=np.array([[1.0, -1.0]]), N=np.array([[0.0]]),
            o=np.array([-1.0]),
            l1=np.array([-np.inf]), u1=np.array([np.inf]),
            A=np.array([[1.0, 0.0]]), B=np.array([[-1.0]]),
            l2=np.array([0.0]), u2=np.array([np.inf]))
        # z1 free with r1 = 0; s2 = z1 - w = 1 interior, λ = 0: label 6
        z = np.array([1.0, 0.0])
        w = np.array([0.0])
        base = comp_indices(gavi, z, w)
        assert base[1] == {6}
        # direction that increases r2 = λ is -[0 I 0] = [0, -1, 0]; grants
        # label 5 (s2 at l2).  The old [0 I B] matrix only matched
        # [0, -1, 1], which propagate_request never produces.
        req = (Linear(np.array([0.0, -1.0, 0.0])),)
        granted = comp_indices(gavi, z, w, req)
        assert 5 in granted[1] - base[1], (
            "a pure lambda-direction request must grant a boundary label")
