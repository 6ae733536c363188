"""Fused Lemke pivot loop for the GPU: one Pallas program per lane, via Triton.

The XLA route (ops/lemke.py, ``vmap(_lemke_single)``) runs each pivot as a
chain of small kernels inside a ``lax.while_loop`` whose predicate the host
reads back every iteration, plus a nested tie-break loop; a 60–80-pivot
solve is then bound by launches and synchronisation, not arithmetic.

Here the whole almost-complementary path of one lane runs inside one
Pallas program (``backend="triton"``):

* grid = one program per lane — lanes share no state, so the programs run
  independently on the streaming multiprocessors with no cross-block
  communication;
* the lane's tableau is padded to powers of two, ``(NP, WP)`` with
  ``NP = next_pow2(n)`` and ``WP = next_pow2(3n+1)`` (variable columns
  z|u|v|t; the rhs column rides separately), and is carried through an
  in-kernel ``lax.while_loop`` in registers — at n=38 that is a (64, 128)
  f32 tile, 32 KB;
* the entering column, ratio test and lexicographic tie-break are masked
  reductions over that tile (Triton has no dynamic gather), with padded
  rows made inert (zero column, ``theta = inf``);
* the pivot rule is the XLA lane's, step for step (same covering rule,
  tie-break, status and pivot-count discipline), so the two engines follow
  the same path up to f32 summation order.

The kernel is the f32 pivot tier of the mixed-precision pattern: exact
values are landed afterwards by refactorising the terminal basis against
the original f64 data (``lemke.refactor_batch_np``).  Reference semantics:
PATH's pivoting core (the reference's ``src/avi.jl:63-77``; prior art
``deprecated/avi_scratch.jl:17-134``).

``interpret=True`` runs the kernel through the Pallas interpreter — the CPU
test path; production callers never pass it (see
``lemke.solve_lemke_batch_state_auto``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .lemke import (LEMKE_MAX, LEMKE_RAY, LEMKE_SINGULAR, LEMKE_SUCCESS,
                    _lemke_extract, _lemke_setup)

# Largest AVI dimension the kernel takes.  At n=64 the padded tableau is
# (64, 256) f32 = 64 KB, a quarter of one SM's 256 KB register file, which
# leaves room for the rank-1 update's temporaries at 16 warps; beyond it the
# next power of two (128 rows) would spill to local memory, and the XLA
# route takes the batch instead.
LEMKE_KERNEL_MAX_N = 64


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def kernel_shape(n: int) -> tuple[int, int]:
    """Padded (rows, variable columns) of one lane's tableau in the kernel."""
    return _pow2(n), _pow2(3 * n + 1)


def _num_warps(NP: int, WP: int) -> int:
    # about 32 tableau elements per thread: 4 warps for the smallest tiles,
    # 8 at n=38 (4, 8 and 16 measured within 6% of each other there on the
    # H100), 16 at the (64, 256) ceiling
    return int(min(16, max(4, (NP * WP) // 1024)))


def _make_kernel(n: int, NP: int, WP: int, max_pivots: int, tol: float,
                 piv_tol: float):
    T_ID = 3 * n
    f32 = jnp.float32

    def kernel(Tv_ref, rhs_ref, basis_ref, val_ref, blb_ref, bub_ref,
               vlb_ref, vub_ref, leff_ref, ueff_ref, lane_i_ref, lane_f_ref,
               xB_out, basis_out, val_out, lane_out):
        # every constant is pinned to 32 bits: under jax_enable_x64 a bare
        # Python int would trace as int64, which the kernel must not carry
        inf = f32(np.inf)
        zero, one = f32(0.0), f32(1.0)
        tolc, ptol, lexeps = f32(tol), f32(piv_tol), f32(1e-12)
        i0, i1 = jnp.int32(0), jnp.int32(1)
        ni, n2i, tid = jnp.int32(n), jnp.int32(2 * n), jnp.int32(T_ID)
        iota_r = jax.lax.broadcasted_iota(jnp.int32, (NP,), 0)
        iota_w = jax.lax.broadcasted_iota(jnp.int32, (WP,), 0)
        iota_2 = jax.lax.broadcasted_iota(jnp.int32, (2,), 0)

        def pick(vec, oh):
            """vec[idx] as a masked reduction (oh = one-hot of idx)."""
            return jnp.sum(jnp.where(oh, vec, jnp.zeros_like(vec)),
                           dtype=vec.dtype)

        vlb = vlb_ref[...]
        vub = vub_ref[...]
        leff = leff_ref[...]
        ueff = ueff_ref[...]
        lane_i = lane_i_ref[...]
        lane_f = lane_f_ref[...]

        def cond(c):
            return (c[-2] < max_pivots) & (c[-1] == i0)

        def body(c):
            Tv, rhs, basis, val, blb, bub, ent, edir, ev, k, st = c
            # the entering variable carries its start value
            oh_e = iota_w == ent
            val = jnp.where(oh_e, ev, val)
            xB = rhs - jnp.sum(Tv * val[None, :], axis=1)
            colT = jnp.sum(jnp.where(oh_e[None, :], Tv, zero), axis=1)
            d = edir * colT
            theta = jnp.where(
                d > ptol, (xB - blb) / jnp.where(d > ptol, d, one),
                jnp.where(d < -ptol,
                          (xB - bub) / jnp.where(d < -ptol, d, one), inf))
            theta = jnp.maximum(jnp.where(theta != theta, inf, theta), zero)
            ent_lb = pick(vlb, oh_e)
            ent_ub = pick(vub, oh_e)
            theta_e = jnp.where(edir > zero, ent_ub - ev, ev - ent_lb)
            tstar = jnp.min(theta)

            is_ray = ~jnp.isfinite(tstar) & ~jnp.isfinite(theta_e)
            do_flip = ~is_ray & (theta_e <= tstar)
            i_e = ent % ni
            flip_newval = jnp.where(edir > zero, ent_ub, ent_lb)
            flip_ent = jnp.where(edir > zero, n2i + i_e, ni + i_e)

            # pivot row: ratio-test ties, t first, then lexicographic
            # refinement over the -B^-1 block (the u-columns); the loop
            # runs zero iterations for the typical unique minimum
            tie = theta <= tstar + tolc * (one + jnp.abs(tstar))
            t_tie = tie & (basis == tid)
            pick_t = jnp.max(t_tie.astype(jnp.int32)) > i0
            safe_d = jnp.where(jnp.abs(d) > ptol, d, one)
            need_lex = ~is_ray & ~do_flip & ~pick_t

            def lex_cond(lc):
                kk, cand = lc
                n_cand = jnp.sum(cand.astype(jnp.int32), dtype=jnp.int32)
                return need_lex & (kk < ni) & (n_cand > i1)

            def lex_body(lc):
                kk, cand = lc
                col = jnp.sum(jnp.where((iota_w == ni + kk)[None, :], Tv,
                                        zero), axis=1)
                key = jnp.where(cand, -col / safe_d, inf)
                kmin = jnp.min(key)
                return kk + i1, cand & (key <= kmin + lexeps
                                        * (one + jnp.abs(kmin)))

            _, cand = jax.lax.while_loop(lex_cond, lex_body, (i0, tie))
            row_mask = jnp.where(pick_t, t_tie, cand)
            jstar = jax.lax.argmax(row_mask.astype(jnp.int32), 0, jnp.int32)
            oh_j = iota_r == jstar
            piv = pick(colT, oh_j)
            bad_piv = jnp.abs(piv) < ptol
            exiting = pick(basis, oh_j)
            hit_lower = pick(d, oh_j) > zero
            oh_x = iota_w == exiting
            exit_val = jnp.where(hit_lower, pick(vlb, oh_x), pick(vub, oh_x))

            # rank-1 update (guarded divisor: a bad pivot's update is
            # computed and discarded, and must stay finite)
            piv_safe = jnp.where(bad_piv, one, piv)
            pr = jnp.sum(jnp.where(oh_j[:, None], Tv, zero), axis=0) / piv_safe
            pr_r = pick(rhs, oh_j) / piv_safe
            other = jnp.where(oh_j, zero, colT)
            Tv_piv = jnp.where(oh_j[:, None], pr[None, :],
                               Tv - other[:, None] * pr[None, :])
            rhs_piv = jnp.where(oh_j, pr_r, rhs - other * pr_r)
            val_piv = jnp.where(oh_e, zero, jnp.where(oh_x, exit_val, val))

            # Lemke rule: the complement of the exiting variable drives next
            i_x = exiting % ni
            oh_ix = iota_r == i_x
            l_i, u_i = pick(leff, oh_ix), pick(ueff, oh_ix)
            is_z = exiting < ni
            is_u = (exiting >= ni) & (exiting < n2i)
            at_l = jnp.abs(exit_val - l_i) <= jnp.abs(exit_val - u_i)
            nent = jnp.where(is_z, jnp.where(at_l, ni + i_x, n2i + i_x), i_x)
            ndir = jnp.where(is_z | is_u, one, -one)
            nev = jnp.where(is_z, zero, jnp.where(is_u, l_i, u_i))

            do_pivot = ~is_ray & ~do_flip & ~bad_piv
            Tv = jnp.where(do_pivot, Tv_piv, Tv)
            rhs = jnp.where(do_pivot, rhs_piv, rhs)
            upd = do_pivot & oh_j
            basis = jnp.where(upd, ent, basis)
            blb = jnp.where(upd, ent_lb, blb)
            bub = jnp.where(upd, ent_ub, bub)
            val = jnp.where(do_pivot, val_piv,
                            jnp.where(do_flip & oh_e, flip_newval, val))
            ent_n = jnp.where(do_pivot, nent, jnp.where(do_flip, flip_ent,
                                                        ent))
            edir = jnp.where(do_pivot, ndir, jnp.where(do_flip, one, edir))
            ev = jnp.where(do_pivot, nev, jnp.where(do_flip, zero, ev))
            singular = ~do_flip & bad_piv
            st = jnp.where(is_ray, jnp.int32(LEMKE_RAY),
                           jnp.where(singular, jnp.int32(LEMKE_SINGULAR),
                                     jnp.where(do_pivot & (exiting == tid),
                                               jnp.int32(LEMKE_SUCCESS), st)))
            # a ray or singular termination performs no pivot (pivot-count
            # parity with the XLA lane and the host oracle)
            k = jnp.where(is_ray | singular, k, k + i1)
            return Tv, rhs, basis, val, blb, bub, ent_n, edir, ev, k, st

        c0 = (Tv_ref[...], rhs_ref[...], basis_ref[...], val_ref[...],
              blb_ref[...], bub_ref[...], pick(lane_i, iota_2 == 0),
              pick(lane_f, iota_2 == 0), pick(lane_f, iota_2 == 1), i1,
              pick(lane_i, iota_2 == 1))
        Tv, rhs, basis, val, _, _, _, _, _, k, st = jax.lax.while_loop(
            cond, body, c0)
        st = jnp.where(st == i0, jnp.int32(LEMKE_MAX), st)
        xB_out[...] = rhs - jnp.sum(Tv * val[None, :], axis=1)
        basis_out[...] = basis
        val_out[...] = val
        lane_out[...] = jnp.where(iota_2 == 0, k, st)

    return kernel


def _pad(a, shape, fill):
    """Pad the trailing axes of ``a`` up to ``shape`` with ``fill``."""
    return jnp.pad(a, [(0, t - s) for s, t in zip(a.shape, shape)],
                   constant_values=fill)


@functools.partial(jax.jit,
                   static_argnames=("tol", "piv_tol", "max_pivots", "cover",
                                    "interpret"))
def solve_lemke_batch_state_pallas(M, q, l, u, z0, var_mask, tol=1e-9,
                                   piv_tol=1e-11, max_pivots: int = 512,
                                   synth_scale=1e4, cover: str = "viol",
                                   interpret: bool = False):
    """Drop-in for :func:`lemke.solve_lemke_batch_state` backed by the fused
    pivot kernel; float32 only, ``n <= LEMKE_KERNEL_MAX_N``.  Returns
    ``(z, status, pivots, basis, val)``.

    Setup (synthetic boxes, slack basis, covering pivot) and the terminal
    extraction (QR refactorisation, z assembly) are the XLA lane's own
    functions; only the pivot loop runs in the kernel."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    B, n = q.shape
    if q.dtype != jnp.float32:
        raise TypeError(f"lemke pivot kernel is float32-only, got {q.dtype}")
    if n > LEMKE_KERNEL_MAX_N:
        raise ValueError(f"lemke pivot kernel takes n <= {LEMKE_KERNEL_MAX_N}"
                         f", got n={n}")
    NP, WP = kernel_shape(n)
    W1 = 3 * n + 1
    init = jax.vmap(functools.partial(
        _lemke_setup, tol=tol, synth_scale=synth_scale, cover=cover))(
        M, q, l, u, z0, var_mask)

    # solved-at-start lanes enter with their pre-pivot state and a final
    # status, so the kernel's loop does not run for them
    solved = init.solved_at_start
    T_in = jnp.where(solved[:, None, None], init.T0t, init.T1)
    basis_in = jnp.where(solved[:, None], init.basis0,
                         init.basis1).astype(jnp.int32)
    f32, i32 = jnp.float32, jnp.int32
    # padded rows are inert: zero column and zero row bounds give an
    # infinite ratio, and basis id -1 is never the artificial t
    operands = (
        _pad(T_in[:, :, :W1], (B, NP, WP), 0.0),
        _pad(T_in[:, :, W1], (B, NP), 0.0),
        _pad(basis_in, (B, NP), -1),
        _pad(init.val0, (B, WP), 0.0),
        _pad(jnp.take_along_axis(init.var_lb, basis_in, axis=1), (B, NP), 0.0),
        _pad(jnp.take_along_axis(init.var_ub, basis_in, axis=1), (B, NP), 0.0),
        _pad(init.var_lb, (B, WP), 0.0),
        _pad(init.var_ub, (B, WP), 0.0),
        _pad(init.l_eff, (B, NP), 0.0),
        _pad(init.u_eff, (B, NP), 0.0),
        jnp.stack([init.ent0, init.status_init], axis=1).astype(i32),
        jnp.stack([init.dir0, init.ev0], axis=1).astype(f32),
    )

    def spec(a):
        return pl.BlockSpec((None,) + a.shape[1:],
                            lambda b: (b,) + (0,) * (a.ndim - 1))

    out_shape = (jax.ShapeDtypeStruct((B, NP), f32),      # xB
                 jax.ShapeDtypeStruct((B, NP), i32),      # basis
                 jax.ShapeDtypeStruct((B, WP), f32),      # val
                 jax.ShapeDtypeStruct((B, 2), i32))       # (pivots, status)
    xB, basis, val, lane = pl.pallas_call(
        _make_kernel(n, NP, WP, max_pivots, tol, piv_tol),
        grid=(B,),
        in_specs=[spec(a) for a in operands],
        out_specs=[spec(o) for o in out_shape],
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(NP, WP), num_stages=1),
        interpret=interpret,
        name="lemke_pivot",
    )(*operands)
    return jax.vmap(_lemke_extract)(
        init, xB[:, :n], basis[:, :n], val[:, :W1], lane[:, 0], lane[:, 1],
        var_mask)
