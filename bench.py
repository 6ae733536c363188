"""Benchmark: batched AVI-piece throughput on the flagship robust_avoid
scenario ensemble.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

value       = AVI KKT systems solved per second on one GPU, batched.
vs_baseline = speedup vs solving the same systems one-at-a-time sequentially
              on the same device — the stand-in for the reference's
              single-threaded PATH loop (the reference publishes no numbers).

Each row runs in its own subprocess (``--row=flagship`` / ``large`` /
``hard``), one after another, so a fault in one row is reported as an
``{"error": ...}`` field instead of losing the others.  Every row records
the platform, device kind and device count it ran on.

The benchmark needs a GPU and fails without one.  ``QPN_BENCH_CPU=1`` runs
the flagship row on the CPU for debugging; device metrics are then absent.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def _run_row(row: str, timeout_s: float):
    """Run one bench row in a killable subprocess; return (dict|None, meta).

    The row prints its result as the LAST stdout line (a JSON object).  On
    any failure the returned meta captures rc and the tail of stderr,
    including the terminal device/XLA error text."""
    env = dict(os.environ)
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), f"--row={row}"],
            capture_output=True, timeout=timeout_s, env=env, text=True)
    except subprocess.TimeoutExpired as e:
        tail = ((e.stderr or b"").decode(errors="replace")
                if isinstance(e.stderr, bytes) else (e.stderr or ""))
        return None, {"error": f"timeout after {timeout_s:.0f}s",
                      "stderr_tail": tail[-2000:]}
    except OSError as e:  # pragma: no cover
        return None, {"error": f"spawn failed: {e}"}
    last = ""
    for line in out.stdout.strip().splitlines():
        line = line.strip()
        if line.startswith("{"):
            last = line
    if out.returncode == 0 and last:
        try:
            return json.loads(last), {}
        except json.JSONDecodeError:
            pass
    return None, {"error": f"row '{row}' exited rc={out.returncode}",
                  "stderr_tail": out.stderr[-4000:]}


# --------------------------------------------------------------------------
#  Row workers (each runs in its own process)
# --------------------------------------------------------------------------

def _init_backend():
    """(platform, device kind, device count); exits unless on a GPU, or on
    the CPU when QPN_BENCH_CPU asks for it."""
    import jax
    if os.environ.get("QPN_BENCH_CPU"):     # debug runs off the card
        jax.config.update("jax_platforms", "cpu")
    d = jax.devices()[0]
    if d.platform != "gpu" and not os.environ.get("QPN_BENCH_CPU"):
        sys.exit(f"bench: no GPU (JAX platform {d.platform!r})")
    from qpn_tpu.config import CONFIG
    # controlled same-device comparison: the production small-dispatch CPU
    # routing would silently move the B=1 sequential-baseline lane off-card
    CONFIG.small_qp_on_cpu = False
    return d.platform, d.device_kind, len(jax.devices())


def _device_fields(dev):
    platform, kind, count = dev
    return {"platform": platform, "device_kind": kind, "device_count": count}


def _peaks(dev):
    """Data-sheet peaks of the device (None on the CPU debug path)."""
    if dev[0] == "cpu":
        return None
    from qpn_tpu.utils.flops import device_peaks
    return device_peaks(dev[1])


def row_flagship():
    """256-lane robust_avoid certificate ensemble through the production
    structured route (batched Lemke pivoting + f64 refactorization)."""
    dev = _init_backend()
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.ops.avi import solve_kkt_avi_batch

    S = 256
    batch = scenario_batch_gavis(num_scenarios=S, T=2, num_obj=1,
                                 num_poly_faces=4, seed=0)
    M, q, l, u = batch["M"], batch["q"], batch["l"], batch["u"]
    z0, mask = batch["z0"], batch["mask"]
    structure = batch["structure"]

    def solve_ensemble(M, q, l, u, z0, mask, tol):
        return solve_kkt_avi_batch(M, q, l, u, mask, structure, tol=tol)

    tol = 1e-8

    # warmup / compile
    res = solve_ensemble(M, q, l, u, z0, mask, tol=tol)
    _ = np.asarray(res.z)

    # spread-quoted runs: the workload is identical each run, so the
    # spread is host noise — median is the quoted rate, min/max bound it
    n_runs = 7
    times = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        res = solve_ensemble(M, q, l, u, z0, mask, tol=tol)
        _ = np.asarray(res.z)
        times.append(time.perf_counter() - t0)
    t_batch = float(np.median(times))
    throughput = S / t_batch
    conv = float(np.asarray(res.converged).mean())

    # sequential baseline: one system at a time (PATH-loop stand-in);
    # median per-call time — tail spikes of single-instance dispatches
    # would otherwise dominate a mean
    K = 8
    r1 = solve_ensemble(M[:1], q[:1], l[:1], u[:1], z0[:1], mask[:1],
                        tol=tol)
    _ = np.asarray(r1.z)
    seq_times = []
    for i in range(K):
        t0 = time.perf_counter()
        r1 = solve_ensemble(M[i:i + 1], q[i:i + 1], l[i:i + 1], u[i:i + 1],
                            z0[i:i + 1], mask[i:i + 1],
                            tol=tol)
        _ = np.asarray(r1.z)
        seq_times.append(time.perf_counter() - t0)
    t_seq = float(np.median(seq_times))

    out = {
        **_device_fields(dev),
        "batch": S,
        "conv": round(conv, 4),
        "solves_per_sec": round(throughput, 2),
        "solves_per_sec_min": round(S / max(times), 2),
        "solves_per_sec_max": round(S / min(times), 2),
        "regime": "latency",   # small-n ensemble: dispatch-bound
        "vs_sequential": round(throughput * t_seq, 2),
    }

    # roofline accounting: analytic flop count of the work actually
    # executed (structured route = batched f32 Lemke pivoting; iters are
    # pivot counts, each touching the (n, 3n+2) tableau once).  These small
    # solves are latency-bound; the hbm fraction shows the binding roofline.
    from qpn_tpu.utils.flops import lemke_flops
    peaks = _peaks(dev)
    if peaks is not None:
        n_avi = M.shape[1]
        it = np.asarray(res.iters, dtype=np.float64)
        fl = lemke_flops(n_avi, it)
        by = 4.0 * float(np.sum(it)) * n_avi * (3 * n_avi + 2) * 2
        achieved = fl / t_batch
        out.update({
            "achieved_gflops": round(achieved / 1e9, 2),
            "frac_of_f32_peak": round(achieved / peaks["f32"], 6),
            "hbm_bw_frac": round((by / t_batch) / peaks["hbm"], 4),
        })
    print(json.dumps(out))


def row_large():
    """Arithmetic-bound regime: T=8 trajectory horizon, num_obj=4, S=1024
    scenarios sharing one KKT matrix (n=608), solved by the shared-matrix
    GEMM route (ops/shared_kkt) whose per-iteration work is (S,n)@(n,n)
    matmuls plus batched f32 LU factorizations."""
    dev = _init_backend()
    peaks = _peaks(dev)
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.ops.shared_kkt import solve_kkt_avi_shared
    Sl = 1024
    big = scenario_batch_gavis(num_scenarios=Sl, T=8, num_obj=4,
                               num_poly_faces=4, seed=0)
    stats = {}
    r = solve_kkt_avi_shared(big["M"][0], big["q"], big["l"], big["u"],
                             None, tol=1e-8, stats=stats,
                             structure=big["structure"])   # warm/compile
    tl = []
    for _ in range(5):
        stats = {}
        t0 = time.perf_counter()
        r = solve_kkt_avi_shared(big["M"][0], big["q"], big["l"],
                                 big["u"], None, tol=1e-8, stats=stats,
                                 structure=big["structure"])
        tl.append(time.perf_counter() - t0)
    t_large = float(np.median(tl))
    conv_l = float(np.asarray(r.converged).mean())
    achieved_l = stats["device_flops"] / t_large
    print(json.dumps({
        "config": f"robust_avoid T=8 num_obj=4 S={Sl} n={big['M'].shape[1]}",
        **_device_fields(dev),
        "solves_per_sec": round(Sl / t_large, 2),
        "solves_per_sec_min": round(Sl / max(tl), 2),
        "solves_per_sec_max": round(Sl / min(tl), 2),
        "conv": round(conv_l, 4),
        "achieved_gflops": round(achieved_l / 1e9, 2),
        "frac_of_f32_peak": round(achieved_l / peaks["f32"], 6),
        "hbm_bw_frac": round(
            (stats["device_bytes"] / t_large) / peaks["hbm"], 4),
        "eg_iters": stats.get("eg_iters"),
        "host_solves": stats.get("host_solves"),
        "phase_t": stats.get("phase_t"),
    }))


def row_hard():
    """Degenerate-class robustness row: seed-2 ensembles are
    dual-degenerate-heavy, and their stragglers go through the on-device
    structured ADMM rung.  Records the warm wall."""
    dev = _init_backend()
    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.ops.shared_kkt import solve_kkt_avi_shared
    Sh = 512
    big = scenario_batch_gavis(num_scenarios=Sh, T=8, num_obj=4,
                               num_poly_faces=4, seed=2)
    r = solve_kkt_avi_shared(big["M"][0], big["q"], big["l"], big["u"],
                             None, tol=1e-8,
                             structure=big["structure"])   # warm/compile
    tl = []
    for _ in range(3):
        stats = {}
        t0 = time.perf_counter()
        r = solve_kkt_avi_shared(big["M"][0], big["q"], big["l"],
                                 big["u"], None, tol=1e-8, stats=stats,
                                 structure=big["structure"])
        tl.append(time.perf_counter() - t0)
    print(json.dumps({
        "config": f"robust_avoid T=8 num_obj=4 S={Sh} n={big['M'].shape[1]}"
                  " seed=2 (degenerate-heavy)",
        **_device_fields(dev),
        "wall_s": round(float(np.median(tl)), 2),
        "wall_s_min": round(min(tl), 2),
        "wall_s_max": round(max(tl), 2),
        "conv": round(float(np.asarray(r.converged).mean()), 4),
        "host_solves": stats.get("host_solves"),
        "phase_t": stats.get("phase_t"),
    }))


def main():
    for a in sys.argv[1:]:
        if a.startswith("--row="):
            {"flagship": row_flagship, "large": row_large,
             "hard": row_hard}[a[6:]]()
            return

    on_cpu = bool(os.environ.get("QPN_BENCH_CPU"))
    flag_timeout = float(os.environ.get("QPN_BENCH_ROW_TIMEOUT", 2400))
    flag, flag_meta = _run_row("flagship", flag_timeout)

    extra = {}
    if flag is None:
        # report the failure but still emit valid JSON
        record = {
            "metric": "avi_kkt_solves_per_sec_per_chip[failed]",
            "value": 0.0, "unit": "solves/s", "vs_baseline": 0.0,
            "flagship_error": flag_meta,
        }
    else:
        record = {
            "metric": (f"avi_kkt_solves_per_sec_per_chip"
                       f"[{flag['platform']},batch={flag['batch']},"
                       f"conv={flag['conv']:.2f}]"),
            "value": flag["solves_per_sec"],
            "unit": "solves/s",
            "vs_baseline": flag["vs_sequential"],
        }
        for k in ("platform", "device_kind", "device_count",
                  "solves_per_sec_min", "solves_per_sec_max",
                  "achieved_gflops", "frac_of_f32_peak", "hbm_bw_frac"):
            if k in flag:
                extra[k] = flag[k]

    # large + hard rows on the GPU; a fault in either is REPORTED, not fatal
    if not on_cpu:
        large_timeout = float(os.environ.get("QPN_BENCH_LARGE_TIMEOUT", 3000))
        large, large_meta = _run_row("large", large_timeout)
        extra["large"] = large if large is not None else large_meta
        hard, hard_meta = _run_row("hard", large_timeout)
        extra["hard_seed"] = hard if hard is not None else hard_meta

    record.update(extra)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
