"""Multi-chip equilibrium kernels: sharded batched AVI solves + collective
piece pruning.

Design (SURVEY.md §2.3): the reference is fully serial; this framework's
scaling axes are

* scenario batches (dp): independent QPNet instances solve as one sharded
  vmapped kernel — computation follows data, XLA partitions the batch axis
  across the mesh with zero communication in the inner Newton loop;
* branch/piece batches (ep/tp): piece dedup ("remove_subsets",
  sets.jl:889-905) needs all-pairs information — each device holds a shard of
  pieces and `all_gather`s the rest, reducing keep-masks with deterministic
  order-based tie-breaks (the reference's serial tie-break, which its own
  threading bug note demands);
* global convergence flags reduce with `psum` (cross-scenario means).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.avi import _newton_solve
from .mesh import scenario_sharding


def _avi_vmap(M, q, l, u, z0, mask, tol, max_iter):
    fn = functools.partial(_newton_solve, tol=tol, max_iter=max_iter)
    return jax.vmap(lambda M_, q_, l_, u_, z_, vm: fn(M_, q_, l_, u_, z_,
                                                      var_mask=vm))(
        M, q, l, u, z0, mask)


# one module-level jit: a fresh jit(partial(...)) per call would have a new
# function identity and re-trace every invocation of the superstep
_avi_vmap_jit = jax.jit(_avi_vmap, static_argnames=("tol", "max_iter"))


def sharded_avi_solve(mesh: Mesh, M, q, l, u, z0, mask, tol=1e-8,
                      max_iter=840):
    """Solve a scenario batch of AVIs with the batch axis sharded over the
    whole mesh.  Inputs are host numpy; returns AVIResult on device."""
    sh = scenario_sharding(mesh)
    put = lambda x: jax.device_put(jnp.asarray(x), sh)
    return _avi_vmap_jit(put(M), put(q), put(l), put(u), put(z0), put(mask),
                         tol=tol, max_iter=max_iter)


_PRUNE_JIT_CACHE: dict = {}


#: above this many pieces the all_gather prune's O(total) per-device
#: replication is routed through the O(shard) ring rotation instead
RING_PRUNE_THRESHOLD = 4096


def sharded_containment_prune(mesh: Mesh, act, resid):
    """Deterministic piece-dedup keep-mask with collectives.

    ``act``  (B, k): quantized active-set signature per piece.
    ``resid`` (B,):  quality score (lower is better).

    Piece i is dropped iff an equivalent piece j (same signature) exists with
    (resid_j, j) < (resid_i, i) lexicographically — the order-based tie-break
    that keeps exactly one of each duplicate group, independent of sharding
    (the property the reference's threading bug violated).  Each device holds
    a shard of pieces and all_gathers the rest; beyond
    ``RING_PRUNE_THRESHOLD`` pieces the ring-rotated prune takes over with
    the identical keep-mask at O(shard) device memory (ring-attention
    analogue, SURVEY §5 long-context)."""
    B = act.shape[0]
    if B > RING_PRUNE_THRESHOLD:
        from ..utils.metrics import METRICS
        from .ring import ring_containment_prune
        METRICS.bump("ring_prune_waves")
        return ring_containment_prune(mesh, act, resid)
    sh = scenario_sharding(mesh)

    def local(act_s, resid_s, idx_s):
        act_all = jax.lax.all_gather(act_s, ("scenario", "branch"),
                                     tiled=True)
        resid_all = jax.lax.all_gather(resid_s, ("scenario", "branch"),
                                       tiled=True)
        idx_all = jax.lax.all_gather(idx_s, ("scenario", "branch"),
                                     tiled=True)
        same = jnp.all(act_s[:, None, :] == act_all[None, :, :], axis=-1)
        # STRICT lexicographic (quantized resid, idx) — a total order, so
        # exactly one member of every duplicate group survives.  The
        # previous epsilon-fuzzy comparison was non-transitive: a chain of
        # pieces each within atol of the next could drop ALL of them.
        # Quantization (12 digits, the dedup currency convention) absorbs
        # float noise while keeping the comparison exact and transitive.
        rq_s = jnp.round(resid_s * 1e12)
        rq_all = jnp.round(resid_all * 1e12)
        better = (rq_all[None, :] < rq_s[:, None]) | (
            (rq_all[None, :] == rq_s[:, None])
            & (idx_all[None, :] < idx_s[:, None]))
        dominated = jnp.any(same & better, axis=1)
        return ~dominated

    # the wrapped callable is cached per mesh: a fresh jit(shard_map(
    # closure)) per call has a new function identity and re-traces every
    # superstep
    fn = _PRUNE_JIT_CACHE.get(mesh)
    if fn is None:
        fn = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(("scenario", "branch")), P(("scenario", "branch")),
                      P(("scenario", "branch"))),
            out_specs=P(("scenario", "branch"))))
        _PRUNE_JIT_CACHE[mesh] = fn
    keep = fn(jax.device_put(jnp.asarray(act), sh),
              jax.device_put(jnp.asarray(resid), sh),
              jax.device_put(jnp.arange(B), sh))
    return keep


def stack_chain_avis(qpn):
    """Stack a chain network's per-level KKT AVIs into uniform tensors for
    :func:`level_sweep_scan`.

    Restricted to the level-pipeline fast class: one player per level, a
    single box-constraint set, and (as in the reference's latent PP axis,
    algorithm.jl:32-43) each level's QP parameterized only by its CHILD's
    decision — so the bottom-up sweep is a pure dataflow.  Returns
    (M, Ncarry, o, l, u, dec_slice) stacked bottom-up with uniform shapes.
    """
    L = qpn.num_levels()
    per_level = []
    for lv in range(L, 0, -1):               # bottom-up
        players = sorted(qpn.network_depth_map[lv])
        assert len(players) == 1, "chain sweep needs one player per level"
        pid = players[0]
        qp = qpn.qps[pid]
        own = sorted(qp.var_indices)
        child = sorted(qpn.network_edges[pid])
        cvars = sorted(qpn.qps[child[0]].var_indices) if child else []
        cons = [qpn.constraints[c].poly for c in qp.constraint_indices]
        A_full = np.vstack([c.A for c in cons])
        # the fast class requires constraints on OWN variables only and
        # objective coupling only to the single child — anything else must
        # fail loudly here, not solve a silently different network
        other = sorted(set(range(A_full.shape[1])) - set(own))
        if other and np.abs(A_full[:, other]).max(initial=0.0) > 0:
            raise ValueError(
                "stack_chain_avis: constraints couple non-own variables — "
                "outside the level-pipeline fast class")
        non_child = sorted(set(range(qp.f.Q.shape[1])) - set(own)
                           - set(cvars))
        if non_child and np.abs(
                qp.f.Q[np.ix_(own, non_child)]).max(initial=0.0) > 0:
            raise ValueError(
                "stack_chain_avis: objective couples variables beyond the "
                "first child — outside the level-pipeline fast class")
        A = A_full[:, own]
        lb = np.concatenate([c.l for c in cons])
        ub = np.concatenate([c.u for c in cons])
        nd, m = len(own), len(lb)
        k = nd + 2 * m
        Q = qp.f.Q[np.ix_(own, own)]
        qlin = qp.f.q[own]
        Qc = (qp.f.Q[np.ix_(own, cvars)] if cvars
              else np.zeros((nd, len(own))))
        # KKT AVI over z=[x; λ; s]:  Qx + Qc·c + q − A'λ ⟂ x free
        #                            Ax − s = 0 (free λ);  λ ⟂ l ≤ s ≤ u
        M = np.zeros((k, k))
        M[:nd, :nd] = Q
        M[:nd, nd:nd + m] = -A.T
        M[nd:nd + m, :nd] = A
        M[nd:nd + m, nd + m:] = -np.eye(m)
        M[nd + m:, nd:nd + m] = np.eye(m)
        Nc = np.zeros((k, Qc.shape[1]))
        Nc[:nd] = Qc
        o = np.concatenate([qlin, np.zeros(2 * m)])
        lo = np.concatenate([np.full(nd + m, -np.inf), lb])
        hi = np.concatenate([np.full(nd + m, np.inf), ub])
        per_level.append((M, Nc, o, lo, hi, nd, own))
    ks = {p[0].shape[0] for p in per_level}
    cs = {p[1].shape[1] for p in per_level}
    assert len(ks) == 1 and len(cs) == 1, "chain sweep needs uniform shapes"
    M = np.stack([p[0] for p in per_level])
    Nc = np.stack([p[1] for p in per_level])
    o = np.stack([p[2] for p in per_level])
    lo = np.stack([p[3] for p in per_level])
    hi = np.stack([p[4] for p in per_level])
    nd = per_level[0][5]
    owns = [p[6] for p in per_level]
    return M, Nc, o, lo, hi, nd, owns


def level_sweep_scan(M, Ncarry, o, l, u, nd, carry0, tol=1e-9, max_iter=60):
    """Bottom-up level pipeline as ONE ``lax.scan`` (SURVEY §2.3 row 6 — the
    PP analogue the reference leaves latent at algorithm.jl:32-43).

    Per level: q = Ncarry·carry + o; solve the level's KKT AVI with the
    semismooth-Newton kernel; the level's decision block becomes the next
    carry.  The whole L-level sweep compiles to one kernel — no host
    recursion — and vmaps/shards over scenario ensembles."""
    fn = functools.partial(_newton_solve, tol=tol, max_iter=max_iter)

    def step(carry, level):
        Ml, Nl, ol, ll, ul = level
        q = Nl @ carry + ol
        res = fn(Ml, q, ll, ul, jnp.zeros_like(ol),
                 var_mask=jnp.ones(ol.shape[0], dtype=bool))
        return res.z[:nd], (res.z, res.resid)

    carry, (zs, resids) = jax.lax.scan(step, jnp.asarray(carry0),
                                       (jnp.asarray(M), jnp.asarray(Ncarry),
                                        jnp.asarray(o), jnp.asarray(l),
                                        jnp.asarray(u)))
    return carry, zs, resids


def equilibrium_superstep(mesh: Mesh, batch, tol=1e-8, max_iter=840):
    """One full sharded equilibrium iteration — the framework's "training
    step" analogue, exercised by __graft_entry__.dryrun_multichip.

    1. scenario-sharded batched AVI solve               (dp)
    2. global convergence fraction                      (psum)
    3. active-set signatures per scenario solution
    4. collective duplicate-piece prune                 (all_gather, ep/tp)

    In the prune every certified lane (resid ≤ tol) scores 0, so among
    certified duplicates the lowest index survives: their residuals are
    float noise, which differs in the last bits between meshes and would
    otherwise decide which duplicate is kept.

    Trajectory-scale shared-matrix ensembles (``batch["structure"]`` with
    ``shared_M`` at n ≥ config.shared_kkt_min_n) route through the shared
    GEMM+policy-iteration path with the SAME mesh — at n≥600 the generic
    per-lane Newton kernel is slower; small ensembles keep the sharded
    Newton kernel.  Either way the returned per-lane arrays are sharded
    over the mesh's scenario axis when the lane count divides it.
    """
    structure = batch.get("structure") if hasattr(batch, "get") else None
    n = np.asarray(batch["M"]).shape[-1]
    from ..config import CONFIG
    if (structure is not None and structure.get("shared_M")
            and n >= CONFIG.shared_kkt_min_n
            and np.asarray(batch["mask"]).all()):
        from ..ops.shared_kkt import solve_kkt_avi_shared
        M0 = np.asarray(batch["M"], dtype=np.float64)
        res = solve_kkt_avi_shared(
            M0[0] if M0.ndim == 3 else M0, batch["q"], batch["l"],
            batch["u"], None, tol=tol, structure=structure, mesh=mesh)
        S = np.asarray(batch["q"]).shape[0]
        put = (functools.partial(jax.device_put,
                                 device=scenario_sharding(mesh))
               if S % mesh.devices.size == 0 else jnp.asarray)
        res = type(res)(z=put(res.z), resid=put(res.resid),
                        iters=put(res.iters), converged=put(res.converged))
    else:
        res = sharded_avi_solve(mesh, batch["M"], batch["q"], batch["l"],
                                batch["u"], batch["z0"], batch["mask"],
                                tol=tol, max_iter=max_iter)
    z = res.z
    frac = jnp.mean(res.converged.astype(jnp.float64))
    l = jnp.asarray(batch["l"])
    u = jnp.asarray(batch["u"])
    lq = jnp.where(jnp.isfinite(l), l, -1e20)
    uq = jnp.where(jnp.isfinite(u), u, 1e20)
    at_l = (jnp.abs(z - lq) < 1e-6)
    at_u = (jnp.abs(z - uq) < 1e-6)
    act = (at_l.astype(jnp.int32) + 2 * at_u.astype(jnp.int32))
    score = jnp.where(res.resid <= tol, 0.0, res.resid)
    keep = sharded_containment_prune(mesh, _fetch_global(act),
                                     _fetch_global(score))
    return dict(z=z, resid=res.resid, converged_frac=frac, keep=keep)


def _fetch_global(a):
    """Host copy of a possibly process-spanning array: plain np.asarray in
    one process; a tiled process_allgather when the mesh spans processes
    (fetching non-addressable shards directly is illegal)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(a, tiled=True))
    return np.asarray(a)
