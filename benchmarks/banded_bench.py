"""Sequence-parallel banded KKT benchmark.

Trajectory-horizon QP ensembles (robust_avoid's T-step dynamics class,
reference examples/deprecated/robust_avoid.jl:72-83) have block-tridiagonal
KKT matrices.  This bench times the production ADMM kernel
(ops/batch_qp.solve_qp_batch) with its x-update factored two ways:

  dense   — one (Tk)×(Tk) Cholesky + dense triangular solves
  banded  — cyclic-reduction factor/solve (ops/banded.py), O(T k³ log T)

Run:  python benchmarks/banded_bench.py [--cpu]
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
    from qpn_tpu.ops import batch_qp
    from qpn_tpu.ops.banded import dense_from_blocks, horizon_kkt_blocks

    print(f"backend: {jax.default_backend()}")
    rng = np.random.default_rng(0)
    B = 64
    print(f"{'T':>4s} {'k':>3s} {'n':>4s} {'dense[s]':>9s} {'banded[s]':>10s}"
          f" {'speedup':>8s} {'agree':>6s}")
    for T, k in ((8, 6), (16, 6), (32, 6), (64, 6)):
        n = T * k
        Ps, qs = [], []
        for _ in range(B):
            A_, B_, C_, g = horizon_kkt_blocks(T, k, rng)
            Q = dense_from_blocks(A_, B_, C_)
            Ps.append(0.5 * (Q + Q.T) + 0.5 * np.eye(n))
            qs.append(g.flatten())
        P = np.stack(Ps)
        q = np.stack(qs)
        A = np.repeat(np.eye(n)[None], B, axis=0)
        l = np.full((B, n), -2.0)
        u = np.full((B, n), 2.0)
        mask = np.ones((B, n), dtype=bool)

        def run(banded_k):
            sol = batch_qp.solve_qp_batch(P, q, A, l, u, mask,
                                          banded_k=banded_k)
            _ = np.asarray(sol.x)
            t0 = time.perf_counter()
            for _ in range(3):
                sol = batch_qp.solve_qp_batch(P, q, A, l, u, mask,
                                              banded_k=banded_k)
                _ = np.asarray(sol.x)
            return (time.perf_counter() - t0) / 3, np.asarray(sol.x)

        td, xd = run(0)
        tb, xb = run(k)
        agree = bool(np.allclose(xd, xb, atol=1e-6))
        print(f"{T:4d} {k:3d} {n:4d} {td:9.3f} {tb:10.3f} "
              f"{td / tb:7.2f}x {str(agree):>6s}")


if __name__ == "__main__":
    main()
