"""On-device quilt assembly (Looking Glass format).

Replaces the reference's out-of-process ImageMagick montage
(reference: scripts/viewsToQuilt.sh:2 -- 5x9 tiles). Runs as pure XLA data
movement on device; optional per-tile resize uses jax.image.

Tile order matches `montage`: row-major, top-left first.

Deviation from the reference script: viewsToQuilt.sh forces every tile to
1920x1080 and writes JPEG; here tiles default to the native view size and the
writer emits PNG (lossless). Pass ``tile_size=(1080, 1920)`` for
reference-shaped quilts.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def to_hwc(quilt_chw: jnp.ndarray) -> jnp.ndarray:
    return jnp.transpose(quilt_chw, (1, 2, 0))


@partial(jax.jit, static_argnames=("cols", "rows", "tile_size"))
def assemble_quilt(
    views: jnp.ndarray,  # [V, C, H, W] uint8
    *,
    cols: int = 5,
    rows: int = 9,
    tile_size: tuple[int, int] | None = None,  # (tile_h, tile_w)
) -> jnp.ndarray:
    """First cols*rows views -> [C, rows*tile_h, cols*tile_w] uint8."""
    v, c, h, w = views.shape
    n = cols * rows
    if v < n:
        raise ValueError(f"Quilt needs {n} views, got {v}")
    if tile_size is not None and tile_size != (h, w):
        th, tw = tile_size
        tiles = jax.image.resize(
            views[:n].astype(jnp.float32), (n, c, th, tw), method="bilinear"
        )
        tiles = jnp.clip(jnp.round(tiles), 0, 255).astype(jnp.uint8)
    else:
        th, tw = h, w
        tiles = views
    # Unrolled per-tile copies into the canvas: plain contiguous stores
    # (a transpose+reshape formulation interleaves the (cols, tw) minor
    # dims, which lowers to a transpose).
    canvas = jnp.zeros((c, rows * th, cols * tw), tiles.dtype)
    for i in range(n):
        r, col = divmod(i, cols)
        canvas = lax.dynamic_update_slice(
            canvas, tiles[i], (0, r * th, col * tw)
        )
    return canvas
