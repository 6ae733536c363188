"""Ring-rotated frontier processing — the ring-attention analogue for piece
batches (SURVEY.md §5: "frontier sharding with ppermute rotation").

Each device holds a shard of the enumeration frontier (candidate pieces) and
a shard of the reference set (already-accepted pieces).  To test every
candidate against EVERY reference piece without all_gathering the whole set,
the reference shard rotates around the ring with `ppermute`; after
`num_devices` rotations every (candidate, reference) pair has met on some
device.  Communication is overlapped chunk-wise exactly like ring attention,
and memory stays O(shard) instead of O(total)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@functools.lru_cache(maxsize=64)
def _ring_fn(mesh: Mesh, sig_shape, sig_dtype, ref_shape, ref_dtype):
    """Build (and cache) the jitted ring sweep for one (mesh, shapes) key.
    jit caches on function identity, so rebuilding the closure per call
    would retrace + recompile every time."""
    axes = tuple(mesh.axis_names)
    if len(axes) > 2:
        raise ValueError(
            f"ring_duplicate_mask supports 1-D and 2-D meshes; got axes "
            f"{axes} — the rotation ring would skip axis {axes[2:]} pairs")
    n_dev = int(np.prod(list(mesh.shape.values())))

    def local(sig_s, ref_s):
        def step(carry, _):
            ref_cur, hit = carry
            eq = jnp.all(sig_s[:, None, :] == ref_cur[None, :, :], axis=-1)
            hit = hit | jnp.any(eq, axis=1)
            # rotate the reference shard one step around the ring
            perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
            ref_next = jax.lax.ppermute(ref_cur, axes[0], perm=perm) \
                if len(axes) == 1 else _ppermute2(ref_cur, axes, mesh)
            return (ref_next, hit), None

        # derive hit0 from sig_s so it is device-varying under shard_map's
        # replication check without jax.lax.pvary (deprecated alias)
        hit0 = sig_s[:, 0] != sig_s[:, 0]
        (ref_fin, hit), _ = jax.lax.scan(step, (ref_s, hit0), None,
                                         length=n_dev)
        return hit

    spec = P(tuple(mesh.axis_names))
    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec, spec),
                                 out_specs=spec))


def ring_duplicate_mask(mesh: Mesh, sig, ref_sig):
    """For each candidate signature, is an equal signature present in the
    (distributed) reference set?  sig (B, k) int32 sharded over the mesh;
    ref_sig (R, k) likewise.  Returns bool (B,): True = duplicate."""
    sig = jnp.asarray(sig)
    ref_sig = jnp.asarray(ref_sig)
    fn = _ring_fn(mesh, sig.shape, str(sig.dtype),
                  ref_sig.shape, str(ref_sig.dtype))
    sh = NamedSharding(mesh, P(tuple(mesh.axis_names)))
    return fn(jax.device_put(sig, sh), jax.device_put(ref_sig, sh))


def _ppermute2(x, axes, mesh):
    """Rotation across a flattened 2-D mesh: advance along the minor axis,
    carrying into the major axis (a single logical ring over all devices)."""
    minor, major = axes[1], axes[0]
    n_minor = mesh.shape[minor]
    n_major = mesh.shape[major]
    # one step on the minor ring
    perm_minor = [(i, (i + 1) % n_minor) for i in range(n_minor)]
    x_rot = jax.lax.ppermute(x, minor, perm=perm_minor)
    # devices at minor position 0 must receive from the previous major row's
    # last minor position: correct the wrapped entries with a major-axis hop
    idx_minor = jax.lax.axis_index(minor)
    perm_major = [(i, (i + 1) % n_major) for i in range(n_major)]
    x_carry = jax.lax.ppermute(x_rot, major, perm=perm_major)
    return jnp.where(idx_minor == 0, x_carry, x_rot)


@functools.lru_cache(maxsize=64)
def _ring_prune_fn(mesh: Mesh, B, k):
    """Ring-rotated duplicate-piece prune: the memory-bounded counterpart of
    sharded.sharded_containment_prune (same keep-mask, bit for bit).

    Instead of all_gathering the full (B, k) signature set to every device
    (O(total) memory), the reference shard rotates around the ring; after
    n_dev steps every (candidate, reference) pair has met.  Memory stays
    O(shard).  Dominance is the same strict lexicographic (quantized resid,
    index) total order the all_gather path uses."""
    axes = tuple(mesh.axis_names)
    if len(axes) > 2:
        raise ValueError(
            f"ring prune supports 1-D and 2-D meshes; got axes {axes}")
    n_dev = int(np.prod(list(mesh.shape.values())))

    def local(act_s, rq_s, idx_s):
        def step(carry, _):
            ref_act, ref_rq, ref_idx, dominated = carry
            same = jnp.all(act_s[:, None, :] == ref_act[None, :, :], axis=-1)
            better = (ref_rq[None, :] < rq_s[:, None]) | (
                (ref_rq[None, :] == rq_s[:, None])
                & (ref_idx[None, :] < idx_s[:, None]))
            dominated = dominated | jnp.any(same & better, axis=1)
            perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
            if len(axes) == 1:
                rot = lambda x: jax.lax.ppermute(x, axes[0], perm=perm)
            else:
                rot = lambda x: _ppermute2(x, axes, mesh)
            return (rot(ref_act), rot(ref_rq), rot(ref_idx), dominated), None

        dom0 = idx_s != idx_s      # device-varying all-False
        (ra, rr, ri, dominated), _ = jax.lax.scan(
            step, (act_s, rq_s, idx_s, dom0), None, length=n_dev)
        return ~dominated

    spec = P(tuple(mesh.axis_names))
    return jax.jit(jax.shard_map(local, mesh=mesh,
                                 in_specs=(spec, spec, spec),
                                 out_specs=spec))


def ring_containment_prune(mesh: Mesh, act, resid):
    """Keep-mask over duplicate piece groups with O(shard) device memory.
    Semantics identical to sharded.sharded_containment_prune."""
    act = jnp.asarray(act)
    B = act.shape[0]
    rq = jnp.round(jnp.asarray(resid) * 1e12)
    idx = jnp.arange(B)
    fn = _ring_prune_fn(mesh, B, act.shape[1])
    sh = NamedSharding(mesh, P(tuple(mesh.axis_names)))
    return fn(jax.device_put(act, sh), jax.device_put(rq, sh),
              jax.device_put(idx, sh))
