"""Multi-host initialization — the distributed communication backend
(SURVEY.md §2.3 last row: the reference has none; the target design runs
scenario/branch axes across hosts, with NVLink collectives inside a host
and the network between hosts).

On a multi-host cluster each process calls :func:`init` once before any
jax computation; the (scenario × branch) mesh from ``parallel.mesh`` then
spans every host's devices automatically (``jax.devices()`` is global after
``jax.distributed.initialize``), and the sharded kernels in
``parallel/sharded.py`` work unchanged — XLA hands `psum`/`all_gather` to
NCCL.  This path has been exercised only across CPU processes so far
(tests/test_multihost.py); ROADMAP B5.
"""

from __future__ import annotations

import os
from typing import Optional


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed from explicit args or the standard
    environment (managed clusters auto-discover when no args are given;
    elsewhere pass coordinator_address, num_processes and process_id)."""
    import jax
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(scenario_axis: Optional[int] = None):
    """(scenario × branch) mesh over every device of every host."""
    from .mesh import make_mesh
    return make_mesh(scenario_axis=scenario_axis)


def process_info() -> dict:
    import jax
    return dict(process_index=jax.process_index(),
                process_count=jax.process_count(),
                local_devices=len(jax.local_devices()),
                global_devices=len(jax.devices()))
