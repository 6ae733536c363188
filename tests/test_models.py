"""End-to-end example-model tests (the reference's de-facto extended tests:
four_player cross-checks, robust_avoid_simple 3-level solve)."""

import numpy as np
import pytest

import qpn_tpu as qt


@pytest.mark.slow
def test_robust_avoid_simple_solves():
    qpn = qt.setup("robust_avoid_simple", num_obj=1)
    ret = qt.solve(qpn)
    assert ret.solved
    x = ret.x_opt
    # separation certificates nonnegative at equilibrium (ego constraint)
    eps = x[-1]
    assert eps >= -1e-6


def test_four_player_nash_vs_bilevel():
    """Nash and bilevel DAGs on the same costs give different equilibria
    (the structural point of the example)."""
    nash = qt.setup("four_player_matrix_game", edge_list=[], seed=2)
    r1 = qt.solve(nash, np.zeros(8))
    assert r1.solved
    bil = qt.setup("four_player_matrix_game", edge_list=[(1, 2)], seed=2)
    r2 = qt.solve(bil, np.zeros(8))
    assert r2.solved
    assert not np.allclose(r1.x_opt, r2.x_opt, atol=1e-4)


def test_four_player_equilibrium_crosscheck():
    """A Nash equilibrium re-solved from itself stays put (the
    search_for_game validation primitive, four_player_matrix_game.jl:226-237)."""
    net = qt.setup("four_player_matrix_game", edge_list=[], seed=2)
    r1 = qt.solve(net, np.zeros(8))
    assert r1.solved
    r2 = qt.solve(net, r1.x_opt)
    assert r2.solved
    assert np.allclose(r1.x_opt, r2.x_opt, atol=1e-6)


def test_unique_edge_lists_structure():
    from qpn_tpu.models.four_player_matrix_game import (
        compute_unique_edge_lists, graph_is_redundant)
    # symmetry detector: 1->2 vs 1->3 are the same graph up to relabeling
    assert graph_is_redundant(frozenset({(1, 2)}), [frozenset({(1, 3)})])
    assert not graph_is_redundant(frozenset({(2, 1)}), [frozenset({(1, 3)})])


@pytest.mark.slow
def test_deep_synthetic_three_levels():
    qpn = qt.setup("deep_synthetic", levels=3, width=1, seed=0)
    assert qpn.num_levels() == 3
    ret = qt.solve(qpn)
    assert ret.solved


def test_robust_avoid_model_builds():
    qpn = qt.setup("robust_avoid", T=2, num_obj=1)
    assert qpn.num_levels() == 3
    assert len(qpn.qps) == 1 + 2 * 2   # ego + (adv+cert) per timestep
    # scenario batch tensors for the bench / parallel path
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    batch = scenario_batch_gavis(num_scenarios=4, T=1, num_obj=1,
                                 num_poly_faces=3)
    assert batch["M"].shape[0] == 4
    assert batch["mask"].any()


def test_flat_initialization():
    qpn = qt.setup("four_player_matrix_game", edge_list=[(1, 2)], seed=2)
    x0 = qpn.get_flat_initialization()
    assert x0.shape == (8,)
    assert np.isfinite(x0).all()


@pytest.mark.slow
def test_robust_avoid_t2_solves():
    qpn = qt.setup("robust_avoid", T=2, num_obj=1, num_poly_faces=3)
    ret = qt.solve(qpn)
    assert ret.solved


def test_rock_paper_scissors_nash():
    qpn = qt.setup("rock_paper_scissors", bilevel=False)
    ret = qt.solve(qpn)
    assert ret.solved
    # symmetric regularized zero-sum: uniform mixed strategies
    assert np.allclose(ret.x_opt, 1.0 / 3.0, atol=1e-4)


@pytest.mark.slow
def test_rock_paper_scissors_bilevel():
    qpn = qt.setup("rock_paper_scissors", bilevel=True)
    ret = qt.solve(qpn)
    assert ret.solved
    # strategies stay on the simplex
    assert abs(ret.x_opt[:3].sum() - 1.0) < 1e-5
    assert abs(ret.x_opt[3:].sum() - 1.0) < 1e-5


def test_toll_setting_bilevel():
    qpn = qt.setup("toll_setting")
    ret = qt.solve(qpn)
    assert ret.solved
    tolls, flows = ret.x_opt[:3], ret.x_opt[3:]
    assert np.all(tolls >= -1e-6) and np.all(tolls <= 2.0 + 1e-6)
    assert abs(flows.sum() - 1.0) < 1e-5
    assert np.all(flows >= -1e-6)


def test_solve_many():
    from qpn_tpu.algorithm import solve_many
    rets = solve_many([qt.setup("toll_setting", seed=s) for s in range(2)])
    assert all(r.solved for r in rets)


@pytest.mark.slow
def test_chainstore_paradox():
    """Backward induction: the incumbent never fights (r=0), entrants enter."""
    qpn = qt.setup("chainstore", num_towns=3)
    assert qpn.num_levels() == 6
    ret = qt.solve(qpn)
    assert ret.solved
    e, r = ret.x_opt[:3], ret.x_opt[3:]
    assert np.all(r < 1e-4)          # fighting is never credible
    assert np.all(e > 0.5)           # entrants enter


def test_trilevel_escape():
    qpn = qt.setup("trilevel_escape")
    assert qpn.num_levels() == 3
    ret = qt.solve(qpn)
    assert ret.solved
    assert np.all(np.abs(ret.x_opt) <= 3.0 + 1e-6)


@pytest.mark.slow
def test_search_for_game_smoke():
    """The equilibrium cross-check harness on a restricted DAG family:
    equilibria of one structure are typically not equilibria of another
    (four_player_matrix_game.jl:179-248)."""
    from qpn_tpu.models.four_player_matrix_game import search_for_game
    seed, n_unique = search_for_game([2], max_edges=1)
    assert seed == 2
    assert n_unique >= 1


def test_shepherd_sheep():
    """Interior case: sheep can reach the target, bucket placed so the
    follower's unconstrained optimum hits it."""
    qpn = qt.setup("shepherd_sheep", target=(0.5, 0.5), barn_weight=0.0)
    ret = qt.solve(qpn)
    assert ret.solved
    shp = ret.x_opt[2:]
    assert np.allclose(shp, [0.5, 0.5], atol=1e-4)


def test_shepherd_sheep_pen_binding():
    """Target outside the pen: the sheep pins to the pen corner."""
    qpn = qt.setup("shepherd_sheep", pen=1.0, target=(2.0, 2.0),
                   barn_weight=0.0)
    ret = qt.solve(qpn)
    assert ret.solved
    shp = ret.x_opt[2:]
    assert np.allclose(shp, [1.0, 1.0], atol=1e-4)


def test_robust_avoid_simple_num_obj3_solves():
    """Round-1 'Known limit' regression: three coupled
    obstacle/certificate branches defeat a naive equilibrium step — solving
    needs the full robustness ladder (vacuous-combo guard, joint-feasibility
    screen, alternate failing combos, perturb-to-continue).  The reference
    dies in PATH on the infeasible subpiece QEP this configuration produces
    (avi.jl:413-427 error path)."""
    qpn = qt.setup("robust_avoid_simple", num_obj=3)
    ret = qt.solve(qpn)
    assert ret.solved
    assert np.all(np.isfinite(ret.x_opt))


def test_robust_constrained_equilibrium_properties():
    """Behavioral port of deprecated/robust_constrained.jl: single-level
    Nash of constraint-coupled adversaries. Analytic equilibrium facts:
    u1 = min(15, max_accel), u2 = 0 (uncoupled u-player cost);
    s[i,t] = max_j h[j,i,t]; c = min s; v = max(0, c)."""
    T = 2
    qpn = qt.setup("robust_constrained", T=T, num_obj=1)
    ret = qt.solve(qpn)
    assert ret.solved
    x = np.asarray(ret.x_opt)
    F = 4
    i = 4 + 4 * T
    U = x[i:i + 2 * T]
    i += 2 * T
    H = x[i:i + F * T]
    i += F * T
    S = x[i:i + T]
    i += T
    i += 2                       # obstacle center
    c, v = x[i], x[i + 1]
    np.testing.assert_allclose(U[0::2], 10.0, atol=1e-6)   # u1 clipped
    np.testing.assert_allclose(U[1::2], 0.0, atol=1e-6)    # u2 zero
    np.testing.assert_allclose(c, S.min(), atol=1e-6)
    np.testing.assert_allclose(v, max(0.0, c), atol=1e-6)


def test_bilevel_escape_behavior():
    """deprecated/bilevel_escape.jl: leader min y1-x1 over the radius-2
    diamond; follower projects x onto the unit diamond.  The analytic
    global equilibrium x=(2,0), y=(1,0) is stationary; from the origin the
    algorithm stops at the local equilibrium of the identity piece (y=x on
    the diamond interior makes the leader's objective flat) — the same
    local-equilibrium semantics as the reference's piece-wise verification."""
    qpn = qt.setup("bilevel_escape")
    ret = qt.solve(qpn, np.array([2.0, 0.0, 1.0, 0.0]))
    assert ret.solved
    np.testing.assert_allclose(ret.x_opt, [2.0, 0.0, 1.0, 0.0], atol=1e-4)
    qpn = qt.setup("bilevel_escape")
    ret0 = qt.solve(qpn, np.zeros(4))
    assert ret0.solved
    np.testing.assert_allclose(ret0.x_opt, np.zeros(4), atol=1e-4)


def test_simple_network_variants():
    """deprecated/simple_network.jl: three DAG versions over three scalar
    players.  v1: p3 below p2 -> (0,0,0).  v3: 3-level chain -> the leader
    picks the x2=x1 piece: (0.5, 0.5, 0).  v2 (two parents sharing child
    variables with conflicting objectives) is the ξ-disagreement case —
    must terminate cleanly (solved or a reported failure, no crash)."""
    ret = qt.solve(qt.setup("simple_network", edge_version=1))
    assert ret.solved
    np.testing.assert_allclose(ret.x_opt, [0.0, 0.0, 0.0], atol=1e-4)

    ret = qt.solve(qt.setup("simple_network", edge_version=3))
    assert ret.solved
    np.testing.assert_allclose(ret.x_opt, [0.5, 0.5, 0.0], atol=1e-4)

    ret = qt.solve(qt.setup("simple_network", edge_version=2))
    assert hasattr(ret, "solved")        # clean termination either way


def test_repeated_variable_control_matches_direct_qp():
    """deprecated/repeated_variable_control.jl: the bilevel shared-variable
    reformulation must reproduce the directly-solved constrained QP."""
    from qpn_tpu.ops import batch_qp
    qpn = qt.setup("repeated_variable_control")
    ret = qt.solve(qpn)
    assert ret.solved
    d = qpn.problem_data
    sol = batch_qp.solve_qp_np(d["Q"], d["q"], d["A"], d["l"], d["u"])
    np.testing.assert_allclose(ret.x_opt[:3], np.asarray(sol.x), atol=1e-5)
    np.testing.assert_allclose(ret.x_opt[3], 0.0, atol=1e-6)   # s = 0


def test_control_avoid_solves_with_clearance():
    """deprecated/control_avoid.jl: bilevel obstacle-avoidance MPC.  The
    driver maximizes progress subject to the children's least-violated
    halfspace certificates staying nonnegative (s >= 0 = clearance)."""
    T = 2
    qpn = qt.setup("control_avoid", T=T, num_obj=1)
    ret = qt.solve(qpn)
    assert ret.solved
    x = np.asarray(ret.x_opt)
    F = 4
    i = 2 + 4 + 4 * T + 2 * T + F * T
    S = x[i:i + T]
    assert np.all(S >= -1e-6)            # avoidance certificates hold
    # dynamics consistency of the first step: x1 = dyn(xbar, u1)
    from qpn_tpu.models.robust_constrained import dyn
    xbar = x[2:6]
    xt = x[6:10]
    u1 = x[6 + 4 * T:6 + 4 * T + 2]
    np.testing.assert_allclose(xt, dyn(list(xbar), list(u1)), atol=1e-6)


def test_interpolation_avoid_swept_certificates():
    """deprecated/interpolation_avoid.jl (sampled linear reformulation of
    its bilinear swept-segment interpolation): trilevel chain with
    per-sample separation certificates, adversarially aggregated
    c_t = min_k eps_{k,t}; the ego keeps c_t >= 0."""
    qpn = qt.setup("interpolation_avoid", T=1, num_samples=3)
    ret = qt.solve(qpn)
    assert ret.solved
    x = np.asarray(ret.x_opt)
    K = 3
    i = 4 + 4 + 2 + 2 * K
    eps = x[i:i + K]
    c = x[i + K]
    np.testing.assert_allclose(c, eps.min(), atol=1e-5)
    assert c >= -1e-6


def test_vis_equilibria_constellation_overlay(tmp_path):
    """jl:250-267: solve every unique DAG at one seed, overlay equilibria on
    the constellation figure (matplotlib Agg; limited to 1-edge DAGs)."""
    from qpn_tpu.models.four_player_matrix_game import vis_equilibria
    p = tmp_path / "fp.png"
    out = vis_equilibria(seed=495, max_edges=1, save_path=str(p))
    assert len(out["edge_lists"]) >= 4
    assert all(x is not None for _, x in out["overlay"])
    assert p.stat().st_size > 0


def test_trajectory_fingerprint_backend_invariant():
    """Cross-backend trajectory anchor: the solve
    trajectory — QEP-step count and projected-piece count — is pinned to
    the golden CPU values.  An accelerator's rounding in the verification
    glue (masked-LSQ dual recovery) can flip sign splits near the 1e-2
    activity band and change the trajectory, so that glue is pinned to
    host LAPACK on every backend (algorithm.verify_solutions_batch
    small-dispatch placement; ops/avi.solve_avi glue placement), and this
    test asserts the SAME fingerprint whichever backend runs the suite."""
    import numpy as np
    import qpn_tpu as qt

    qpn = qt.setup("robust_avoid", T=2, num_obj=1, num_poly_faces=3)
    ret = qt.solve(qpn)
    assert ret.solved
    c = qpn.metrics.counters
    assert int(c.get("qep_solves", 0)) == 7
    assert int(c.get("pieces_projected", 0)) == 60
