"""Worker for the 2-process jax.distributed test (see test_parallel.py).

Each process owns 4 virtual CPU devices; together they form the 8-device
(view x space) mesh the single-process tests use. Exercises the real
multi-process code paths that in-process tests cannot: distributed.initialize,
a sharded render spanning processes, and the process_allgather branches of
api._fetch.

Usage: _multihost_worker.py PORT RANK NPROCS
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def main() -> int:
    port, rank, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    from lfinterpolator_tpu.parallel import distributed, mesh as pmesh

    distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs,
        process_id=rank,
    )
    # Second call must be a no-op, not a crash (the wrapper's contract).
    distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs,
        process_id=rank,
    )
    assert distributed.is_multi_host()
    info = distributed.local_shard_info()
    assert info["process_count"] == nprocs, info
    assert info["global_devices"] == 4 * nprocs, info

    from lfinterpolator_tpu import api
    from lfinterpolator_tpu.core import geometry
    from lfinterpolator_tpu.ops import blend_xla, reference as oracle

    # Same deterministic scene in every process (host-local loading model).
    rng = np.random.default_rng(7)
    cols = rows = 2
    h, w, v = 16, 32, 8
    images = rng.integers(0, 256, (cols * rows, h, w, 4), dtype=np.uint8)
    start_end = geometry.parse_trajectory("0,0,1,1", (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(start_end, cols, rows, 3.0, v)
    ).astype(np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(start_end)
    )
    fo = geometry.focused_offsets(offsets, 0.3)

    mesh = pmesh.make_mesh()  # (view=2, space=4) over the 8 global devices
    imgs_d = pmesh.replicate(mesh, blend_xla.to_planar(jnp.asarray(images)))
    weights_d = pmesh.shard_weights(mesh, jnp.asarray(wm))
    views = pmesh.render_fixed_sharded(mesh, imgs_d, weights_d, jnp.asarray(fo))

    jax.block_until_ready(views)
    got = api._fetch(blend_xla.from_planar(views))  # full allgather branch
    want = oracle.blend_fixed(images[..., :3], wm, fo)
    np.testing.assert_array_equal(got, want)
    print(f"MULTIHOST_OK rank {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
