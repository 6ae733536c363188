"""Device-mesh construction for multi-chip equilibrium solving.

The reference has no parallelism at all (SURVEY.md §2.3; threading was
disabled for correctness, sets.jl:889-894).  This framework's parallel
axes map the algorithm's latent concurrency onto a 2-D mesh:

* ``scenario`` — data-parallel axis: independent QPNet instances
  (robust_avoid's 64-scenario batch), one shard of scenarios per device
  group.  Collectives: none in the inner solve; `psum` only for global
  convergence flags.
* ``branch`` — "expert"/branch-parallel axis: solution-graph pieces /
  enumeration frontier entries.  Collectives: `all_gather` for the pairwise
  containment prune, `psum` for keep-mask reductions.

Pipeline (level-by-level) parallelism rides the same mesh: each level's
batched KKT solve is sharded over both axes, and for chain networks the
bottom-up level sweep compiles to ONE ``lax.scan``
(:func:`qpn_tpu.parallel.sharded.level_sweep_scan`, fed by
:func:`~qpn_tpu.parallel.sharded.stack_chain_avis`) that vmaps/shards
over scenario ensembles.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int = None, scenario_axis: int = None):
    """Build a (scenario, branch) mesh over the available devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if scenario_axis is None:
        # favor the scenario axis; keep branch axis 1 or 2
        scenario_axis = n_devices if n_devices % 2 else n_devices // 2
    branch_axis = n_devices // scenario_axis
    assert scenario_axis * branch_axis == n_devices
    arr = np.array(devs).reshape(scenario_axis, branch_axis)
    return Mesh(arr, axis_names=("scenario", "branch"))


def scenario_sharding(mesh: Mesh):
    """Batch axis sharded over every mesh axis (pure data parallel)."""
    return NamedSharding(mesh, P(("scenario", "branch")))


def branch_sharding(mesh: Mesh):
    return NamedSharding(mesh, P("branch"))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
