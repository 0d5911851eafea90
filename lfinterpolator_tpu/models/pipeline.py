"""The render pipeline: focus estimation + multi-view blend, jitted end to end.

This is the device-side equivalent of the reference's Interpolator::interpolate
orchestration (reference: src/interpolator.cu:248-297): optional focus-map
estimate + filter, then the blend, in one jit so XLA fuses across stages.
Method dispatch mirrors the reference:

  * "STD" -> float32 blend at HIGHEST precision; per-pixel focus reads the
             FILTERED map (src/kernels.cu:326)
  * "TEN" -> fp16-operand blend with float32 accumulation on the tensor
             cores (the reference's TEN_WM GEMM, src/kernels.cu:398-461);
             per-pixel focus reads the RAW map (src/kernels.cu:430)

Everything that changes per interpolate() call (trajectory, focus, weights,
offsets) is a traced argument -- switching them does not recompile. Only
shapes, method, and the use of the focus path are static.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import blend_xla, focus as focus_ops


@partial(jax.jit, static_argnames=("method",))
def render_fixed_focus(
    images: jnp.ndarray,  # [G, C, H, W] uint8
    weights: jnp.ndarray,  # [V, G] float32
    focused_offsets: jnp.ndarray,  # [G, 2] int32 (dx, dy)
    *,
    method: str = "STD",
) -> jnp.ndarray:
    """Fixed-focus render -> [V, C, H, W] uint8."""
    return blend_xla.render_fixed(images, weights, focused_offsets, method)


@partial(
    jax.jit,
    static_argnames=("radius", "filter_radius", "steps", "pad", "exact_taps"),
)
def compute_focus_maps(
    images: jnp.ndarray,  # [G, C, H, W] uint8
    offsets: jnp.ndarray,  # [G, 2] float32 (x, y)
    focus: jnp.ndarray,  # scalar f32
    focus_range: jnp.ndarray,  # scalar f32
    focus_ids: jnp.ndarray,  # [K] int32
    *,
    radius: tuple[int, int] = (2, 2),
    filter_radius: tuple[int, int] = (0, 0),
    steps: int = 32,
    pad: tuple[int, int] | None = None,
    exact_taps: bool = True,
) -> jnp.ndarray:
    """Estimate + filter -> maps [2, H, W] uint8 (raw, filtered).

    The view-independent first half of render_all_focus, callable on its
    own so view-batched renders (api.py) estimate once and blend per
    weight-row batch.
    """
    selected = images[focus_ids]  # [K, C, H, W]
    sel_offsets = offsets[focus_ids]
    map0 = focus_ops.estimate_focus_map(
        selected, sel_offsets, focus, focus_range, radius,
        steps=steps, pad=pad, exact_taps=exact_taps,
    )
    map1 = focus_ops.filter_focus_map(map0, filter_radius)
    return jnp.stack([map0, map1])


@partial(jax.jit, static_argnames=("method", "row_count"))
def select_allfocus(
    images: jnp.ndarray,  # [G, C, H, W] uint8
    offsets: jnp.ndarray,  # [G, 2] float32 (x, y)
    maps: jnp.ndarray,  # [2, H, W] uint8 (from compute_focus_maps)
    focus: jnp.ndarray,  # scalar f32
    focus_range: jnp.ndarray,  # scalar f32
    row_start: jnp.ndarray | int = 0,
    *,
    method: str = "STD",
    row_count: int | None = None,
) -> jnp.ndarray:
    """The weight-independent SELECT stage of blend_all_focus: every image
    shifted by its pixel's focus -> [G, C, rows, W] uint8.

    The map follows the reference's method asymmetry (STD: filtered map,
    TEN: raw map). `row_start`/`row_count` select one block of output rows
    (memory-pressured renders select block by block). View-batched renders
    (api.py) call this once per block and blend per weight-row batch;
    blend_selected(select_allfocus(...)) is bit-identical to
    blend_all_focus(...) by construction."""
    h, w = maps.shape[1:]
    rows = h if row_count is None else row_count
    fmap = maps[1] if method == "STD" else maps[0]
    fmap = jax.lax.dynamic_slice(
        fmap, (jnp.asarray(row_start, jnp.int32), jnp.int32(0)), (rows, w)
    )
    return blend_xla.allfocus_selected(
        images, offsets, fmap, focus, focus_range,
        row_start=row_start, row_count=rows,
    )


#: One-gather jit: memory-pressured renders materialize the focus views once
#: per step (plain indexing outside jit would dispatch an eager gather).
gather_views = jax.jit(lambda images, ids: images[ids])


def _row_slab(stack, r0, *, py, px, rc, top, bot):
    """Rows [r0, r0+rc+2py) of the full edge-pad of `stack`, rebuilt from
    the raw rows: slice + edge-pad(top, bot) replicates image row 0 / H-1
    exactly like the full pad would (top/bot > 0 only when the window clips
    the true image edge)."""
    n, c, _, w = stack.shape
    rows = rc + 2 * py - top - bot
    block = jax.lax.dynamic_slice(
        stack, (jnp.int32(0), jnp.int32(0), r0 - (py - top), jnp.int32(0)),
        (n, c, rows, w),
    )
    return jnp.pad(block, ((0, 0), (0, 0), (top, bot), (px, px)), mode="edge")


@partial(
    jax.jit,
    static_argnames=("radius", "steps", "pad", "exact_taps", "rc", "top", "bot"),
)
def estimate_focus_rows(
    selected: jnp.ndarray,  # [K, C, H, W] uint8 (the focus views)
    sel_offsets: jnp.ndarray,  # [K, 2] float32 (x, y)
    focus: jnp.ndarray,
    focus_range: jnp.ndarray,
    r0: jnp.ndarray | int,  # global first output row of the block
    *,
    radius: tuple[int, int],
    steps: int,
    pad: tuple[int, int],
    exact_taps: bool,
    rc: int,
    top: int,  # rows of the block's pad window clipped at the top edge
    bot: int,  # ... at the bottom edge
) -> jnp.ndarray:
    """The disparity-search estimate for ONE row block, padding only the
    rows the block's shifts read -> [rc, W] uint8 map block.

    The full edge-pad's rows [r0, r0+rc+2py) are rebuilt from the selected
    views as slice + edge-pad(top, bot). The pads use estimate_focus_map's
    effective floors max(pad, radius+1), and top/bot must be computed
    against the same floors (api.py does). Bit-identical to the same rows
    of the full estimate."""
    rx, ry = int(radius[0]), int(radius[1])
    px, py = max(int(pad[0]), rx + 1), max(int(pad[1]), ry + 1)
    r0 = jnp.asarray(r0, jnp.int32)
    slab = _row_slab(selected, r0, py=py, px=px, rc=rc, top=top, bot=bot)
    return focus_ops.estimate_focus_map(
        selected, sel_offsets, focus, focus_range, radius,
        steps=steps, pad=pad, row_count=rc, exact_taps=exact_taps,
        slab=slab, coord_row0=r0,
    )


@partial(jax.jit, static_argnames=("filter_radius",))
def assemble_focus_maps(
    map_blocks: tuple, filter_radius: tuple[int, int]
) -> jnp.ndarray:
    """Concatenate estimate_focus_rows blocks into the full raw map and
    filter it -> [2, H, W] uint8 (same layout as compute_focus_maps)."""
    map0 = jnp.concatenate(list(map_blocks), axis=0)
    map1 = focus_ops.filter_focus_map(map0, filter_radius)
    return jnp.stack([map0, map1])


@partial(jax.jit, static_argnames=("method",))
def blend_selected(
    selected: jnp.ndarray,  # select_allfocus output
    weights: jnp.ndarray,  # [Vb, G] float32
    *,
    method: str = "STD",
) -> jnp.ndarray:
    """Blend one weight-row batch against a select_allfocus stack
    -> [Vb, C, rows, W] uint8."""
    return blend_xla.blend(selected, weights, method)


@partial(jax.jit, static_argnames=("method",))
def blend_all_focus(
    images: jnp.ndarray,  # [G, C, H, W] uint8
    weights: jnp.ndarray,  # [V, G] float32
    offsets: jnp.ndarray,  # [G, 2] float32 (x, y)
    maps: jnp.ndarray,  # [2, H, W] uint8 (from compute_focus_maps)
    focus: jnp.ndarray,  # scalar f32
    focus_range: jnp.ndarray,  # scalar f32
    *,
    method: str = "STD",
) -> jnp.ndarray:
    """Per-pixel-focus blend -> views [V, C, H, W] uint8.

    The view-dependent second half of render_all_focus; see its docstring
    for the method dispatch and the reference's raw/filtered map asymmetry.
    """
    return blend_xla.blend(
        select_allfocus(
            images, offsets, maps, focus, focus_range, method=method
        ),
        weights, method,
    )


@partial(
    jax.jit,
    static_argnames=(
        "method", "radius", "filter_radius", "steps", "pad", "exact_taps",
    ),
)
def render_all_focus(
    images: jnp.ndarray,  # [G, C, H, W] uint8
    weights: jnp.ndarray,  # [V, G] float32
    offsets: jnp.ndarray,  # [G, 2] float32 (x, y)
    focus: jnp.ndarray,  # scalar f32
    focus_range: jnp.ndarray,  # scalar f32
    focus_ids: jnp.ndarray,  # [K] int32
    *,
    method: str = "STD",
    radius: tuple[int, int] = (2, 2),
    filter_radius: tuple[int, int] = (0, 0),
    steps: int = 32,
    pad: tuple[int, int] | None = None,
    exact_taps: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """All-in-focus render: estimate -> filter -> per-pixel blend.

    `pad` is the static shift bound from focus_ops.shift_pad_bound (enables
    the pre-padded fast path of the estimator). The per-pixel blend keeps
    the reference's map asymmetry (src/kernels.cu:326 vs :430): STD blends
    with the FILTERED map, TEN with the RAW estimator map; both select
    through one gather per image (faster on the GPU than scanning the
    map's byte levels at every measured shape, see PERF.md).

    Returns (views [V, C, H, W] uint8, maps [2, H, W] uint8).
    """
    maps = compute_focus_maps(
        images, offsets, focus, focus_range, focus_ids,
        radius=radius, filter_radius=filter_radius, steps=steps, pad=pad,
        exact_taps=exact_taps,
    )
    views = blend_all_focus(
        images, weights, offsets, maps, focus, focus_range, method=method,
    )
    return views, maps
