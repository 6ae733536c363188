#!/usr/bin/env python3
"""Smoke run of the QP-network solver's main path on the GPU.

    python chip_smoke.py               # one card: phases 1-6
    python chip_smoke.py --devices 4   # four cards: the multi-card path only

Every phase goes through the entry points a user calls (``qt.solve``,
``solve_kkt_avi_batch``, ``solve_kkt_avi_shared``,
``equilibrium_superstep``) at the production widths, and checks the answer
against the repository's own references: the golden table, the same solve
on the host CPU device, the host f64 exact pivot engine, the generic f64
solver, and the XLA pivot lane for the fused kernel.  A failed check ends
the run with a nonzero exit.  The script refuses to run without a GPU.

Lines that carry a time also carry the card's name and power limit.  The
last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

CARD = ""                       # "name, power limit" from nvidia-smi


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(msg: str) -> None:
    log(f"[{CARD}] {msg}")


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def compute_apps_per_card() -> dict:
    """Processes holding each card (nvidia-smi), keyed by card UUID."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=gpu_uuid,pid",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    apps: dict = {}
    for line in out.strip().splitlines():
        uuid, pid = (s.strip() for s in line.split(","))
        apps.setdefault(uuid, []).append(pid)
    return apps


def check_one_process_per_card() -> None:
    apps = compute_apps_per_card()
    check(all(len(p) <= 1 for p in apps.values()),
          f"more than one process holds a card: {apps}")


def primal_diff(z, z_ref, nd) -> float:
    return float(np.abs(np.asarray(z)[:, :nd]
                        - np.asarray(z_ref)[:, :nd]).max())


# ---------------------------------------------------------------------------
#  Phases.  Each takes its sizes as arguments (the tests run them on the
#  CPU at tiny sizes) and raises SmokeFailure on a failed check.
# ---------------------------------------------------------------------------

GOLDEN_W = [
    [-2.0, -3.0], [0.0, -1.0], [1.0, -3.0], [1.0, -1.0],
    [1.0, 0.0], [0.0, 1.0], [-1.0, 1 + math.sqrt(2.0)], [0.0, 0.0],
]
GOLDEN_X = [
    [[-2.0, 0.0]], [[0.0, 0.0]], [[0.0, 0.0]], [[0.0, 0.0]],
    [[0.5, 0.5]], [[0.5, 0.5], [0.0, 0.0]],
    [[-1.0, 0.0], [math.sqrt(2.0) / 2, math.sqrt(2.0) / 2]], [[0.0, 0.0]],
]
# solution-graph piece counts of the reference's test/simple_bilevel.jl
GOLDEN_PIECES = [1, 2, 1, 2, 1, 1, 1, 3]


def phase_golden(points=range(8)) -> dict:
    """The reference's 8-point simple_bilevel table through qt.solve."""
    import qpn_tpu as qt
    qpn = qt.setup("simple_bilevel", gen_solution_map=True)
    for i in points:
        w = GOLDEN_W[i]
        ret = qt.solve(qpn, np.concatenate([w, np.zeros(2)]))
        check(ret.solved, f"golden point {i + 1} not solved")
        check(any(np.allclose(ret.x_opt, np.concatenate([w, x]), atol=1e-6)
                  for x in GOLDEN_X[i]),
              f"golden point {i + 1}: x_opt={ret.x_opt}")
        pieces = len(list(ret.Sol[2]))
        check(pieces == GOLDEN_PIECES[i],
              f"golden point {i + 1}: {pieces} pieces, want "
              f"{GOLDEN_PIECES[i]}")
    return {"points": len(list(points))}


ZOO = [
    ("robust_avoid_simple", dict(num_obj=1), None),
    ("four_player_matrix_game", dict(edge_list=[(1, 2), (3, 4)], seed=2),
     np.zeros(8)),
]


def _zoo_solve(name, kwargs, x0):
    import qpn_tpu as qt
    qpn = qt.setup(name, **kwargs)
    t0 = time.perf_counter()
    ret = qt.solve(qpn, x0)
    dt = time.perf_counter() - t0
    c = qpn.metrics.counters
    check(ret.solved, f"{name} not solved")
    return ret.x_opt, (int(c.get("qep_solves", 0)),
                       int(c.get("pieces_projected", 0))), dt


def phase_zoo(models=ZOO) -> dict:
    """Zoo models on the default device vs the host CPU device."""
    import jax
    cpu = jax.local_devices(backend="cpu")[0]
    out = {}
    for name, kwargs, x0 in models:
        x_dev, counts_dev, t_dev = _zoo_solve(name, kwargs, x0)
        with jax.default_device(cpu):
            x_cpu, counts_cpu, t_cpu = _zoo_solve(name, kwargs, x0)
        check(counts_dev == counts_cpu,
              f"{name}: (qep solves, pieces) {counts_dev} on the default "
              f"device vs {counts_cpu} on the CPU")
        d = float(np.abs(np.asarray(x_dev) - np.asarray(x_cpu)).max())
        check(d <= 1e-6, f"{name}: x_opt differs from the CPU solve by {d}")
        timed(f"zoo {name}: {t_dev:.3f} s default device, {t_cpu:.3f} s "
              f"cpu device (cold, incl. compile), (qep, pieces)={counts_dev}")
        out[name] = {"counts": counts_dev, "x_diff": d}
    return out


def _host_reference_avi(M, q, l, u):
    """Host f64 exact pivoting (native engine, else the numpy oracle)."""
    from qpn_tpu.ops.lemke import solve_lemke_np
    from qpn_tpu.utils import native
    out = native.lemke_batch(M, q, l, u, tol=1e-11)
    if out is not None:
        return out[0]
    return np.stack([solve_lemke_np(M[b], q[b], l[b], u[b], tol=1e-11)[0]
                     for b in range(q.shape[0])])


def phase_kernel_vs_xla(batch, interpret=False) -> dict:
    """The fused pivot kernel, compiled for the card, against the XLA lane
    at the flagship width (``interpret``: the CPU tests' interpreter)."""
    from qpn_tpu.ops.avi import natural_residual_np
    from qpn_tpu.ops.lemke import (LEMKE_SUCCESS, refactor_batch_np,
                                   solve_lemke_batch_state,
                                   solve_lemke_batch_state_auto)
    M, q, l, u, vm = (batch[k] for k in ("M", "q", "l", "u", "mask"))
    f32 = lambda a: np.asarray(a, dtype=np.float32)     # noqa: E731
    args = (f32(M), f32(q), f32(l), f32(u), np.zeros(q.shape, np.float32),
            np.asarray(vm, bool))
    kw = dict(tol=1e-6, piv_tol=1e-5, max_pivots=1024)
    K = [np.asarray(a) for a in solve_lemke_batch_state_auto(
        *args, engine="kernel", interpret=interpret, **kw)]
    X = [np.asarray(a) for a in solve_lemke_batch_state(*args, **kw)]
    check((K[1] == LEMKE_SUCCESS).all(), "kernel: lanes without success")
    check((K[1] == X[1]).all(), "kernel and XLA lane statuses differ")
    zK, okK = refactor_batch_np(M, q, l, u, K[3], K[4], vm)
    zX, okX = refactor_batch_np(M, q, l, u, X[3], X[4], vm)
    rK = natural_residual_np(M, q, l, u, zK, vm)
    check(okK.all() and rK.max() <= 1e-8,
          f"kernel terminal bases: refactor ok {okK.mean()}, resid "
          f"{rK.max()}")
    d = float(np.abs(zK - zX).max())
    check(d <= 1e-6, f"kernel vs XLA lane solutions differ by {d}")
    return {"pivots_mean": float(K[2].mean()),
            "same_pivot_counts": float((K[2] == X[2]).mean()),
            "z_diff": d}


def phase_flagship(S=256, runs=7, interpret=False) -> dict:
    """Flagship structured route (n=38): audit, host reference, and the
    warm median of each Lemke engine."""
    from qpn_tpu.config import CONFIG
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.ops.avi import natural_residual_np, solve_kkt_avi_batch
    from qpn_tpu.ops.lemke import lemke_engine
    b = scenario_batch_gavis(num_scenarios=S, T=2, num_obj=1,
                             num_poly_faces=4, seed=0)
    M, q, l, u, vm = (b[k] for k in ("M", "q", "l", "u", "mask"))
    st = b["structure"]
    out = {"n": int(q.shape[1]), "engine": lemke_engine(q.shape[1])}

    def solve():
        return solve_kkt_avi_batch(M, q, l, u, vm, st, tol=1e-8)
    res = solve()
    z = np.asarray(res.z)
    r = natural_residual_np(M, q, l, u, z, vm)
    conv = float(np.asarray(res.converged).mean())
    check(conv == 1.0 and r.max() <= 1e-8,
          f"flagship: conv {conv}, audit {r.max()}")
    d = primal_diff(z, _host_reference_avi(M, q, l, u), st["nd"])
    check(d <= 1e-6, f"flagship: primal parts differ from host f64 by {d}")
    out.update(conv=conv, audit=float(r.max()), primal_diff=d)
    out["kernel_vs_xla"] = phase_kernel_vs_xla(b, interpret)

    saved = CONFIG.lemke_kernel
    try:
        times = {"auto": [], "xla": []}
        for rep in range(runs):           # alternate engines run by run
            for mode in (("auto", "xla") if rep % 2 == 0
                         else ("xla", "auto")):
                CONFIG.lemke_kernel = mode
                if rep == 0:
                    solve()               # warm this engine's compilation
                t0 = time.perf_counter()
                solve()
                times[mode].append(time.perf_counter() - t0)
    finally:
        CONFIG.lemke_kernel = saved
    for mode, name in (("auto", out["engine"]), ("xla", "xla")):
        med = float(np.median(times[mode]))
        out[f"{name}_median_s"] = med
        timed(f"flagship S={S} n={out['n']} engine={name}: warm median "
              f"{med:.6f} s of {runs} runs (min {min(times[mode]):.6f}, max "
              f"{max(times[mode]):.6f}), {S / med:.2f} solves/s")
    return out


def phase_shared(S=1024, T=8, num_obj=4, seed=0, ref_lanes=32,
                 require_no_host=True) -> dict:
    """Trajectory-scale shared route: conv, host lanes, audit, and primal
    parts of ``ref_lanes`` lanes against the generic f64 solver on CPU."""
    import jax
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.ops.avi import natural_residual_np, solve_avi_batch_adaptive
    from qpn_tpu.ops.shared_kkt import solve_kkt_avi_shared
    b = scenario_batch_gavis(num_scenarios=S, T=T, num_obj=num_obj,
                             num_poly_faces=4, seed=seed)
    M0, q, l, u = b["M"][0], b["q"], b["l"], b["u"]
    st = b["structure"]
    n = q.shape[1]
    walls = []
    for _ in range(2):                    # cold (compiles), then warm
        stats: dict = {}
        t0 = time.perf_counter()
        res = solve_kkt_avi_shared(M0, q, l, u, None, tol=1e-8, stats=stats,
                                   structure=st)
        walls.append(time.perf_counter() - t0)
    z = np.asarray(res.z)
    conv = float(np.asarray(res.converged).mean())
    r = natural_residual_np(np.broadcast_to(M0, (S, n, n)), q, l, u, z)
    check(conv == 1.0 and r.max() <= 1e-8,
          f"shared S={S} seed={seed}: conv {conv}, audit {r.max()}")
    if require_no_host:
        check(stats["host_solves"] == 0,
              f"shared S={S}: {stats['host_solves']} host-solved lanes")
    out = {"n": n, "conv": conv, "audit": float(r.max()),
           "host_solves": stats["host_solves"],
           "eg_iters": stats["eg_iters"], "phase_t": stats["phase_t"],
           "cold_s": walls[0], "warm_s": walls[1]}
    timed(f"shared S={S} n={n} seed={seed}: warm {walls[1]:.6f} s (cold "
          f"{walls[0]:.6f} s), eg_iters={stats['eg_iters']}, host_solves="
          f"{stats['host_solves']}, phase_t={stats['phase_t']}")
    if ref_lanes:
        k = min(ref_lanes, S)
        with jax.default_device(jax.local_devices(backend="cpu")[0]):
            ref = solve_avi_batch_adaptive(
                np.broadcast_to(M0, (k, n, n)), q[:k], l[:k], u[:k],
                np.zeros((k, n)), np.ones((k, n), bool), tol=1e-8)
        check(np.asarray(ref.converged).all(), "generic reference failed")
        d = primal_diff(z[:k], ref.z, st["nd"])
        check(d <= 1e-6, f"shared: primal parts differ from the generic "
                         f"f64 solver by {d}")
        out["primal_diff"] = d
    return out, b, res


def keep_reference(z, resid, l, u, tol=1e-8) -> np.ndarray:
    """Plain dedup rule of the superstep: lane i survives unless a lane
    with the same active-set signature has a smaller (quantized score,
    index); the score is the residual, 0 for certified lanes."""
    lq = np.where(np.isfinite(l), l, -1e20)
    uq = np.where(np.isfinite(u), u, 1e20)
    act = ((np.abs(z - lq) < 1e-6).astype(np.int32)
           + 2 * (np.abs(z - uq) < 1e-6).astype(np.int32))
    resid = np.asarray(resid)
    rq = np.round(np.where(resid <= tol, 0.0, resid) * 1e12)
    best: dict = {}
    for i in range(z.shape[0]):
        key = act[i].tobytes()
        if key not in best or (rq[i], i) < (rq[best[key]], best[key]):
            best[key] = i
    keep = np.zeros(z.shape[0], dtype=bool)
    keep[list(best.values())] = True
    return keep


def phase_superstep(batch, mesh) -> dict:
    """One equilibrium superstep over ``mesh``; keep-mask against the plain
    dedup rule, converged fraction."""
    from qpn_tpu.parallel.sharded import equilibrium_superstep
    t0 = time.perf_counter()
    out = equilibrium_superstep(mesh, batch, tol=1e-8)
    keep = np.asarray(out["keep"])
    dt = time.perf_counter() - t0
    z, resid = np.asarray(out["z"]), np.asarray(out["resid"])
    frac = float(out["converged_frac"])
    check(frac == 1.0, f"superstep converged fraction {frac}")
    want = keep_reference(z, resid, np.asarray(batch["l"]),
                          np.asarray(batch["u"]))
    check(keep.shape == want.shape and (keep == want).all(),
          f"superstep keep-mask: {int(keep.sum())} kept, reference "
          f"{int(want.sum())}")
    timed(f"superstep mesh={dict(mesh.shape)} S={z.shape[0]}: {dt:.6f} s, "
          f"converged_frac={frac}, kept={int(keep.sum())}")
    return {"out": out, "keep": keep, "z": z, "frac": frac}


def phase_multicard(S=1024, T=8, num_obj=4, n_devices=4,
                    ring_pieces=8192 + 64) -> dict:
    """Four cards: the superstep and the shared route on a 4-device mesh,
    lane for lane against one card, plus the ring prune."""
    import jax
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.ops.shared_kkt import solve_kkt_avi_shared
    from qpn_tpu.parallel.mesh import make_mesh
    check(len(jax.devices()) >= n_devices,
          f"need {n_devices} devices, have {len(jax.devices())}")
    mesh, mesh1 = make_mesh(n_devices), make_mesh(1)
    every = set(mesh.devices.flat)
    b = scenario_batch_gavis(num_scenarios=S, T=T, num_obj=num_obj,
                             num_poly_faces=4, seed=0)
    M0, q, l, u, st = b["M"][0], b["q"], b["l"], b["u"], b["structure"]

    s4, s1 = phase_superstep(b, mesh), phase_superstep(b, mesh1)
    for key in ("z", "resid", "keep"):
        check(set(s4["out"][key].sharding.device_set) == every,
              f"superstep {key} does not span the {n_devices} devices")
    check((s4["keep"] == s1["keep"]).all(), "keep-masks differ (4 vs 1)")
    dz = float(np.abs(s4["z"] - s1["z"]).max())
    check(dz <= 1e-8, f"superstep z differs between meshes by {dz}")

    res = {}
    for name, m in (("mesh", mesh), ("one", None)):
        t0 = time.perf_counter()
        res[name] = solve_kkt_avi_shared(M0, q, l, u, None, tol=1e-8,
                                         mesh=m, structure=st)
        timed(f"shared route S={S} on {'4 cards' if m else '1 card'}: "
              f"{time.perf_counter() - t0:.6f} s (one call; compiles when "
              f"the placement is new)")
    c4, c1 = (np.asarray(res[k].converged) for k in ("mesh", "one"))
    check((c4 == c1).all() and c4.all(), "shared route: converged differs")
    dzs = float(np.abs(np.asarray(res["mesh"].z)
                       - np.asarray(res["one"].z)).max())
    check(dzs <= 1e-8, f"shared route z differs between meshes by {dzs}")

    from qpn_tpu.geometry import setops
    from qpn_tpu.geometry.poly import Poly, PolyUnion
    from qpn_tpu.utils.metrics import METRICS
    polys = []
    for i in range(ring_pieces):
        base = i - (i % 4 == 3)           # every 4th duplicates its neighbor
        c = np.array([3.0 * (base % 128), 3.0 * (base // 128)])
        polys.append(Poly(np.eye(2), c, c + 1.0))
    w0 = int(METRICS.counters.get("ring_prune_waves", 0))
    t0 = time.perf_counter()
    pruned = setops.remove_subsets(PolyUnion(polys))
    dt = time.perf_counter() - t0
    waves = int(METRICS.counters.get("ring_prune_waves", 0)) - w0
    check(waves >= 1, "ring prune did not run")
    check(len(pruned) == ring_pieces - ring_pieces // 4,
          f"ring prune kept {len(pruned)} of {ring_pieces}")
    timed(f"ring prune {ring_pieces} pieces -> {len(pruned)}: {dt:.6f} s, "
          f"{waves} ring waves")
    return {"superstep_dz": dz, "shared_dz": dzs, "ring_kept": len(pruned)}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-card path and its "
                         "one-card comparison")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r}); "
              f"nothing was run", file=sys.stderr)
        return 2
    try:
        import qpn_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run it from the repository root ({e})",
              file=sys.stderr)
        return 2
    CARD = card_name_and_power()
    log(f"card: {CARD}")
    log(f"jax {jax.__version__}, devices: {devs}")
    from qpn_tpu.utils import native
    log(f"native host library loaded: {native.native_available()}")

    if args.devices == 4:
        t0 = time.perf_counter()
        r = phase_multicard(n_devices=4)
        timed(f"multicard: ok in {time.perf_counter() - t0:.3f} s {r}")
    else:
        from qpn_tpu.parallel.mesh import make_mesh
        t_all = time.perf_counter()
        for name, fn in (("golden", phase_golden), ("zoo", phase_zoo),
                         ("flagship", phase_flagship)):
            t0 = time.perf_counter()
            r = fn()
            timed(f"phase {name}: ok in {time.perf_counter() - t0:.3f} s "
                  f"{json.dumps(r, default=str)}")
            check_one_process_per_card()
        t0 = time.perf_counter()
        r, big, _ = phase_shared()
        timed(f"phase shared: ok in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        r, _, _ = phase_shared(S=512, seed=2, ref_lanes=0,
                               require_no_host=False)
        timed(f"phase degenerate: ok in {time.perf_counter() - t0:.3f} s, "
              f"host_solves={r['host_solves']}")
        t0 = time.perf_counter()
        r = phase_superstep(big, make_mesh(1))
        timed(f"phase superstep: ok in {time.perf_counter() - t0:.3f} s")
        timed(f"all phases: {time.perf_counter() - t_all:.3f} s")
    check_one_process_per_card()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
