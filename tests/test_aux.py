"""Auxiliary subsystems: printing, requests, checkpoint/resume, metrics."""

import numpy as np
import pytest

import qpn_tpu as qt
from qpn_tpu.geometry.poly import Poly, PolyUnion, from_box
from qpn_tpu.network import Linear, Quadratic
from qpn_tpu import printing, requests
from qpn_tpu.utils import checkpoint
from qpn_tpu.utils.metrics import Metrics


def test_format_poly():
    p = from_box([0.0, -np.inf], [1.0, 2.0])
    s = printing.format_poly(p)
    assert "Poly in R^2" in s
    assert "∞" in s


def test_format_quadratic():
    f = Quadratic(np.array([[2.0, 1.0], [1.0, 0.0]]), np.array([0.0, -3.0]),
                  1.0)
    s = printing.format_quadratic(f, names=["a", "b"])
    assert "a²" in s and "a·b" in s and "b" in s
    # printed coefficients must EVALUATE to f(x) = 0.5 x'Qx + q'x + k:
    # coefficient of a·b is 0.5(Q01+Q10) = 1, of a² is 0.5*Q00 = 1
    assert "+1 a·b" in s and "+1 a²" in s


def test_format_labeled_poly_golden():
    # the reference's LabeledPoly printer (printing.jl:17-112): name headers,
    # lexicographic rows with equalities first, · for zeros, x-marker at the
    # middle row, strictness markers on bounds
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    p = Poly(A, np.array([0.0, -1.0, 2.0]), np.array([1.0, 1.0, 2.0]))
    s = printing.format_labeled_poly(p, labels={"x": 0, "yvar": 1})
    lines = s.rstrip("\n").split("\n")
    assert lines[0] == "Polyhedron in R^2 with 3 constraints."
    assert "x" in lines[1] and "yvar" in lines[1]
    # equality row (l == u == 2) printed first
    assert lines[2].lstrip().startswith("2 ≤")
    # exactly one row carries the midpoint marker "| x"
    assert sum("| x" in ln for ln in lines) == 1
    # structural zeros render as ·
    assert "·" in s
    # strictness markers flip ≤ to <
    ps = Poly(A, np.array([0.0, -1.0, 2.0]), np.array([1.0, 1.0, 2.0]),
              strict_l=np.array([True, False, False]))
    assert "<" in printing.format_labeled_poly(ps)


def test_format_intersection_tree_golden():
    # the reference's IntersectionRoot printer (printing.jl:148-169): root
    # line with the potential leaf count, per-depth children nested
    p = from_box([0.0], [1.0])
    s = printing.format_intersection_tree(
        [PolyUnion([p]), PolyUnion([p, p])], red_lengths=[1, 0])
    lines = s.split("\n")
    assert lines[0] == "Intersection root with 2 potential polys"
    assert lines[1] == "  depth 0: 1 contributing polys (1 complement)"
    assert any(ln.startswith("    depth 1: 2 contributing polys")
               for ln in lines)
    # children indent two spaces per depth
    assert any(ln.startswith("      Poly in R^1") for ln in lines)


def test_min_norm_objective():
    f = requests.min_norm_objective(4, [1, 3])
    assert f(np.array([1.0, 2.0, 3.0, 4.0])) == pytest.approx(0.5 * (4 + 16))


def test_propagate_request():
    # parent poly: box [0,1]^2; requesting direction e1 gives duals on the
    # x1 bounds -> returns some Linear directions
    p = from_box([0.0, 0.0], [1.0, 1.0])
    out = requests.propagate_request(np.array([1.0, 0.0]), p)
    assert all(isinstance(r, Linear) for r in out)
    assert len(out) >= 1


def test_identify_request_reads_parents():
    parent = from_box([0.0, 0.0], [1.0, 1.0])
    S = Poly(np.array([[1.0, 0.0]]), [0.0], [1.0], parent=parent)
    S.row_parents = [parent]
    reqs = requests.identify_request(S, np.array([1.0]))
    assert len(reqs) >= 1


def test_checkpoint_roundtrip(tmp_path):
    x = np.array([1.0, 2.0, 3.0])
    pu = PolyUnion([from_box([0.0], [1.0]), from_box([2.0], [3.0])])
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_state(path, x, Sol={7: pu},
                          iterate_cache={1: [np.array([0.5, 0.5])]},
                          meta={"iteration": 3})
    state = checkpoint.load_state(path)
    assert np.allclose(state["x"], x)
    assert len(state["Sol"][7]) == 2
    assert state["Sol"][7][0].contains(np.array([0.5]))
    assert state["meta"]["iteration"] == 3
    assert len(state["iterate_cache"][1]) == 1


def test_solve_with_checkpoint(tmp_path):
    qpn = qt.setup("simple_bilevel", gen_solution_map=True)
    path = str(tmp_path / "run.npz")
    ret = qt.solve(qpn, np.array([1.0, 0.0, 0.0, 0.0]),
                   checkpoint_path=path)
    assert ret.solved
    state = checkpoint.load_state(path)
    assert state["meta"].get("solved") is True
    assert np.allclose(state["x"], ret.x_opt)
    assert 2 in state["Sol"]
    # resume from the checkpoint: already at the fixed point
    ret2 = checkpoint.resume(qpn, path)
    assert ret2.solved
    assert np.allclose(ret2.x_opt, ret.x_opt, atol=1e-6)


def test_metrics_scope():
    m = Metrics()
    m.bump("a")
    m.bump("a", 2)
    with m.timer("t"):
        pass
    snap = m.snapshot()
    assert snap["a"] == 3
    assert "time/t" in snap


class TestFrontierCheckpoint:
    """mid-enumeration kill/resume reproduces the final
    piece set from the stored frontier instead of restarting discovery."""

    def _enumerator(self, store=None):
        import qpn_tpu as qt
        from qpn_tpu.algorithm import _prepare_qp_tasks, verify_solutions_batch
        from qpn_tpu.enumeration import process_solution_graph
        qpn = qt.setup("simple_bilevel")
        x = np.array([0.0, 1.0, 0.5, 0.5])
        leaf = sorted(qpn.network_depth_map[qpn.num_levels()])[0]
        prep = _prepare_qp_tasks(qpn, leaf, x, {})
        ret = verify_solutions_batch(prep.tasks, x)[0]
        assert ret.solution
        return process_solution_graph(
            prep.qp, prep.base_constraints, prep.dec_inds, x, ret.lam,
            exploration_vertices=10, frontier_store=store)

    def test_kill_resume_reproduces_piece_set(self, tmp_path):
        from qpn_tpu.utils.checkpoint import FrontierStore
        # ground truth: uninterrupted enumeration
        full = self._enumerator()
        truth = {tuple(np.round(p.A.flatten(), 5).tolist()) +
                 tuple(np.round(p.l, 5).tolist())
                 for p in full.collect()}

        store = FrontierStore(str(tmp_path / "f"))
        gen = self._enumerator(store)
        # simulate a kill after ONE frontier generation
        Ks = list(gen.unexplored_Ks)
        gen.explored_Ks |= gen.unexplored_Ks
        gen.unexplored_Ks = set()
        gen._absorb(gen._expand_batch(Ks))
        gen._checkpoint()
        partial_count = len(gen.polys)
        del gen

        # a fresh enumerator with the same store resumes mid-frontier
        gen2 = self._enumerator(store)
        assert len(gen2.polys) == partial_count      # state restored
        resumed = {tuple(np.round(p.A.flatten(), 5).tolist()) +
                   tuple(np.round(p.l, 5).tolist())
                   for p in gen2.collect()}
        assert resumed == truth

    def test_solve_with_checkpoint_writes_frontiers(self, tmp_path):
        import os
        import qpn_tpu as qt
        qpn = qt.setup("simple_bilevel")
        path = str(tmp_path / "ckpt")
        ret = qt.solve(qpn, np.array([0.0, 1.0, 0.0, 0.0]),
                       checkpoint_path=path)
        assert ret.solved
        fdir = path + ".frontiers"
        assert os.path.isdir(fdir) and len(os.listdir(fdir)) >= 1
