"""Pivot-engine microbenchmark: fused Pallas kernel vs XLA while_loop.

Runs the bench.py scenario ensemble (256 KKT AVIs) through both f32 pivot
engines on the default backend (the kernel in the Pallas interpreter on the
CPU) and reports wall time + certification after the host f64 terminal
refactorization.

    python benchmarks/lemke_kernel_bench.py [--cpu] [--sizes 256]
"""

import os
import sys
import time

import numpy as np

# runnable as a plain script from anywhere: the package lives at the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    if "--cpu" in sys.argv:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax

    from qpn_tpu.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu.ops.avi import natural_residual_np
    from qpn_tpu.ops.lemke import (refactor_batch_np,
                                   solve_lemke_batch_state)
    from qpn_tpu.ops.lemke_pallas import solve_lemke_batch_state_pallas

    backend = jax.default_backend()
    print(f"backend: {backend}")
    S = 256
    if "--sizes" in sys.argv:
        S = int(sys.argv[sys.argv.index("--sizes") + 1])
    T = 2
    if "--T" in sys.argv:           # horizon scaling: n grows ~19T
        T = int(sys.argv[sys.argv.index("--T") + 1])
    batch = scenario_batch_gavis(num_scenarios=S, T=T, num_obj=1,
                                 num_poly_faces=4, seed=0)
    M, q, l, u = batch["M"], batch["q"], batch["l"], batch["u"]
    vm = np.asarray(batch["mask"], bool)
    B, n = q.shape
    f32 = lambda a: np.asarray(a, dtype=np.float32)   # noqa: E731
    args = (f32(M), f32(q), f32(l), f32(u), np.zeros((B, n), np.float32),
            vm)
    kw = dict(tol=1e-6, piv_tol=1e-5, max_pivots=1024)
    interp = backend == "cpu"

    for name, fn in (
            ("kernel", lambda: solve_lemke_batch_state_pallas(
                *args, interpret=interp, **kw)),
            ("xla", lambda: solve_lemke_batch_state(*args, **kw))):
        t0 = time.perf_counter()
        out = tuple(np.asarray(a) for a in fn())
        t_compile = time.perf_counter() - t0
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = tuple(np.asarray(a) for a in fn())
            times.append(time.perf_counter() - t0)
        t = min(times)
        z32, st, piv, basis, val = out
        zr, ok = refactor_batch_np(M, q, l, u, basis, val, vm)
        r = natural_residual_np(M, q, l, u, zr, vm)
        cert = float(((r <= 1e-10) & ok).mean())
        print(f"{name:7s} first={t_compile:7.2f}s  best={t*1e3:8.2f}ms  "
              f"solves/s={B / t:9.1f}  pivots median={np.median(piv):.0f}  "
              f"certified={cert:.3f}")


if __name__ == "__main__":
    main()
