"""Multi-host (multi-process) initialization.

The single-process mesh in `parallel.mesh` scales across hosts unchanged once
JAX's distributed runtime is initialized: `jax.devices()` then spans all
hosts, `make_mesh` lays the (view x space) axes over the global device set,
and only the image-stack broadcast crosses hosts (the hot loop has no
communication; SURVEY.md section 5).

Typical launch (one process per host; JAX needs the coordinator given):

    from lfinterpolator_tpu.parallel import distributed, mesh
    distributed.initialize("host0:1234", num_processes=2, process_id=rank)
    m = mesh.make_mesh()                # global mesh over all hosts
    interp = Interpolator(path, mesh=m)

Host-local input loading: every process loads the same light field (or rank 0
loads and the replicated device_put broadcasts); outputs are fetched per-shard
with jax.experimental.multihost_utils helpers if needed.
"""

from __future__ import annotations

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed (no-op if already initialized).

    With no arguments, relies on what the cluster environment provides;
    elsewhere pass the coordinator address, process count and id.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # jax raises "distributed.initialize should only be called once."
        # (0.9.0) / "...already initialized..." (other versions) -- both mean
        # the no-op case this wrapper promises.
        msg = str(e).lower()
        if "already" in msg or "only be called once" in msg:
            return
        raise


def is_multi_host() -> bool:
    return jax.process_count() > 1


def local_shard_info() -> dict:
    """Process/device topology summary for logging."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
