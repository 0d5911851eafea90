"""Multi-device rendering: shard_map over a (view, space) device mesh.

The reference is strictly single-GPU (SURVEY.md section 2.5); multi-device
scaling is new capability:

  * the problem is pixel- and view-parallel, so the natural mesh is 2-D:
    - "view"  axis: the [V, G] weight matrix (and the output view dim) is
      sharded like a tensor-parallel layer;
    - "space" axis: output rows are sharded; each shard renders only its row
      block by folding the block offset into the clamped-shift dynamic_slice
      (no halo exchange -- the image stack is replicated, so the hot loop has
      ZERO inter-device communication; the interconnect carries only the
      initial broadcast of inputs).
  * outputs stay sharded; gather them only at the host boundary.

Throughput therefore scales linearly in devices for the blend (each device
does V/nv x H/ns of the work).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import blend_xla


def make_mesh(
    devices: list | None = None, view_parallel: int | None = None
) -> Mesh:
    """Build a (view, space) mesh over the given (default: all) devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if view_parallel is None:
        # Prefer splitting views (weight rows) 2-way when possible; rows take
        # the rest. Views come in 64s, rows in thousands.
        view_parallel = 2 if n % 2 == 0 and n > 1 else 1
    if n % view_parallel != 0:
        raise ValueError(f"{n} devices not divisible by view_parallel={view_parallel}")
    arr = np.array(devices).reshape(view_parallel, n // view_parallel)
    return Mesh(arr, axis_names=("view", "space"))


def replicate(mesh: Mesh, x: jnp.ndarray) -> jnp.ndarray:
    """Place an array replicated over every device of the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_weights(mesh: Mesh, weights: jnp.ndarray, dim: int = 0) -> jnp.ndarray:
    """Shard a weight matrix's view dimension over the mesh's "view" axis."""
    spec = [None] * weights.ndim
    spec[dim] = "view"
    return jax.device_put(weights, NamedSharding(mesh, P(*spec)))


def shard_inputs(
    mesh: Mesh,
    images: jnp.ndarray,  # [G, C, H, W]
    weights: jnp.ndarray,  # [V, G]
):
    """Place the stack (replicated) and weights (view-sharded) on the mesh."""
    return replicate(mesh, images), shard_weights(mesh, weights)


@partial(jax.jit, static_argnames=("mesh", "method"))
def render_fixed_sharded(
    mesh: Mesh,
    images: jnp.ndarray,  # [G, C, H, W] uint8, replicated
    weights: jnp.ndarray,  # [V, G] float32, sharded over "view"
    focused_offsets: jnp.ndarray,  # [G, 2] int32, replicated
    method: str = "STD",
) -> jnp.ndarray:
    """Fixed-focus render sharded over (views x rows) -> [V, C, H, W] uint8,
    output sharded P('view', None, 'space', None)."""
    g, c, h, w = images.shape
    n_space = mesh.shape["space"]
    if h % n_space != 0:
        raise ValueError(f"H={h} must divide by the space axis ({n_space})")
    h_local = h // n_space

    def local_render(images_l, weights_l, offs_l):
        row0 = jax.lax.axis_index("space") * h_local

        def shift_one(img, o):
            out = blend_xla.shift_axis_clamped(
                img, o[1], axis=1, start=row0, size=h_local
            )
            return blend_xla.shift_axis_clamped(out, o[0], axis=2)

        shifted = jax.vmap(shift_one)(images_l, offs_l)  # [G, C, h_local, W]
        return blend_xla.blend(shifted, weights_l, method)

    return shard_map(
        local_render,
        mesh=mesh,
        in_specs=(P(), P("view", None), P()),
        out_specs=P("view", None, "space", None),
        check_vma=False,  # the STD blend's pallas_call (GPU) carries no vma
    )(images, weights, focused_offsets)


def _shard_slab(
    stack: jnp.ndarray,  # [N, C, H, W] uint8 (replicated raw stack)
    r0,  # traced global first output row of this shard's block
    *,
    px: int,
    py: int,
    rows: int,
    ids: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Rows [r0-py, r0-py+rows) x cols [-px, w+px) of the VIRTUAL full
    edge-pad of `stack`, built per shard -> [N|K, C, rows, w+2px] uint8.

    shard_map runs ONE program on every shard, so the static top/bot
    edge-clip counts of pipeline._row_slab (which differ between the first,
    interior, and last shards) cannot be used here. Instead the row window
    is built with a CLIPPED row gather: slab row i holds raw row
    clip(r0 - py + i, 0, H-1), which is exactly what slice + edge-pad
    produces at every shard position.

    `ids` additionally gathers a view subset (the focus views); the gather
    order (views-first vs rows-first) is chosen by whichever materializes
    fewer bytes."""
    n, c, h, w = stack.shape
    idx = jnp.clip(r0 - py + jnp.arange(rows, dtype=jnp.int32), 0, h - 1)
    if ids is not None and ids.shape[0] * h <= n * rows:
        stack = stack[ids]
        n = ids.shape[0]
        blk = jnp.take(stack, idx, axis=2)
    else:
        blk = jnp.take(stack, idx, axis=2)
        if ids is not None:
            blk = blk[ids]
            n = ids.shape[0]
    left = jnp.broadcast_to(blk[:, :, :, :1], (n, c, rows, px))
    right = jnp.broadcast_to(blk[:, :, :, w - 1 :], (n, c, rows, px))
    return jnp.concatenate([left, blk, right], axis=3)


def allfocus_shard_bytes(
    n_view: int, n_space: int,
    g: int, k: int, c: int, h: int, w: int, v: int, *,
    radius: tuple[int, int],
    pad: tuple[int, int],
) -> dict[str, int]:
    """PER-DEVICE byte arithmetic of render_all_focus_sharded (host-side;
    same statics as the render). Keys: 'stack' (the replicated resident),
    'estimate' and 'select_blend' (phase peaks incl. the stack), 'peak'
    (their max). Feed 'peak' to capacity.check_capacity before building the
    mesh render.
    """
    if h % n_space != 0 or v % n_view != 0:
        raise ValueError(
            f"H={h} / V={v} must divide by the mesh axes ({n_space}, {n_view})"
        )
    h_local = h // n_space
    v_local = v // n_view
    rx, ry = int(radius[0]), int(radius[1])
    pxe, pye = max(int(pad[0]), rx + 1), max(int(pad[1]), ry + 1)
    in_b = g * c * h * w
    maps_b = 3 * h * w  # shard map blocks + the all_gathered full map0

    est_rows = h_local + 2 * pye
    slab_b = k * c * est_rows * (w + 2 * pxe)
    build_b = min(k * h, g * est_rows) * c * w  # _shard_slab's gather order
    sweep_b = 2 * k * c * h_local * w  # the XLA sweep's temporaries
    estimate_b = in_b + build_b + slab_b + sweep_b + maps_b

    # gathered rows + int32 indices, then the blend's 4-byte operand and
    # per view the output with its float32 accumulator
    got = g * c * h_local * w
    out_b = v_local * 5 * c * h_local * w
    select_b = in_b + maps_b + got + max(4 * g * h_local * w, 4 * got + out_b)
    return {
        "stack": in_b,
        "estimate": estimate_b,
        "select_blend": select_b,
        "peak": max(estimate_b, select_b),
    }


def fixed_shard_bytes(
    n_view: int, n_space: int,
    g: int, c: int, h: int, w: int, v: int,
) -> int:
    """PER-DEVICE byte arithmetic of the sharded fixed-focus render:
    replicated raw stack + the shard's shifted rows, the blend's 4-byte
    operand copy of them, and the output with its float32 accumulator
    (plan_fixed_render's model, restricted to shard rows). Feed to
    capacity.check_capacity with capacity.MESH_HINT."""
    if h % n_space != 0 or v % n_view != 0:
        raise ValueError(
            f"H={h} / V={v} must divide by the mesh axes ({n_space}, {n_view})"
        )
    h_local = h // n_space
    v_local = v // n_view
    in_b = g * c * h * w
    shift_b = g * c * h_local * w
    out_b = v_local * (c * h_local * w + 4 * c * h_local * w)
    return in_b + shift_b + 4 * shift_b + out_b


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "method", "radius", "filter_radius", "steps", "pad",
        "exact_taps",
    ),
)
def render_all_focus_sharded(
    mesh: Mesh,
    images: jnp.ndarray,  # [G, C, H, W] uint8, replicated
    weights: jnp.ndarray,  # [V, G] float32, sharded over "view"
    offsets: jnp.ndarray,  # [G, 2] float32, replicated
    focus: jnp.ndarray,
    focus_range: jnp.ndarray,
    focus_ids: jnp.ndarray,  # [K] int32, replicated
    *,
    method: str = "STD",
    radius: tuple[int, int] = (2, 2),
    filter_radius: tuple[int, int] = (0, 0),
    steps: int = 32,
    pad: tuple[int, int] = (64, 64),
    exact_taps: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full all-in-focus pipeline over the (view x space) mesh.

    Per shard: estimate its own row block of the focus map (inputs are
    replicated, so the disparity search needs no halo exchange), all_gather
    the tiny [H, W] map over the space axis (the box filter's halo is the
    only cross-shard dependency in the whole pipeline), filter, select and
    blend its row block with its view-shard of the weight matrix.

    The estimate reads a [K, C, h_local+2py, W+2px] window built by
    _shard_slab (never the full-height focus-view gather or the full-frame
    padded copy), and the select gathers its rows straight from the
    replicated stack. Per-device feasibility is `allfocus_shard_bytes` --
    api.py checks it host-side before building the render, replacing the
    reference's abort-on-OOM (src/interpolator.cu:95-137).

    Returns (views sharded P('view', None, 'space', None),
             maps [2, H, W] sharded P(None, 'space', None)).
    """
    from ..ops import focus as focus_ops

    g, c, h, w = images.shape
    n_space = mesh.shape["space"]
    if h % n_space != 0:
        raise ValueError(f"H={h} must divide by the space axis ({n_space})")
    h_local = h // n_space
    rx, ry = int(radius[0]), int(radius[1])
    pxe, pye = max(int(pad[0]), rx + 1), max(int(pad[1]), ry + 1)

    def local_fn(images_l, weights_l, offsets_l, ids_l, focus, focus_range):
        row0 = jax.lax.axis_index("space") * h_local
        sel_slab = _shard_slab(
            images_l, row0, px=pxe, py=pye, rows=h_local + 2 * pye,
            ids=ids_l,
        )
        map0_l = focus_ops.estimate_focus_map(
            # slab mode reads only this argument's SHAPE; the gather is
            # dead code and XLA eliminates it
            images_l[ids_l],
            offsets_l[ids_l], focus, focus_range, radius,
            steps=steps, pad=pad, row_count=h_local,
            exact_taps=exact_taps, slab=sel_slab, coord_row0=row0,
        )
        # Only cross-shard dependency: the filter halo. The map is tiny.
        map0_full = jax.lax.all_gather(map0_l, "space", tiled=True)
        map1_l = focus_ops.filter_focus_map_block(
            map0_full, filter_radius, row0, h_local
        )
        views_l = blend_xla.render_allfocus(
            images_l, weights_l, offsets_l,
            map1_l if method == "STD" else map0_l, focus, focus_range,
            row_start=row0, row_count=h_local, method=method,
        )
        return views_l, jnp.stack([map0_l, map1_l])

    return shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P("view", None), P(), P(), P(), P()),
        out_specs=(
            P("view", None, "space", None),
            P(None, "space", None),
        ),
        check_vma=False,
    )(images, weights, offsets, focus_ids,
      jnp.asarray(focus, jnp.float32), jnp.asarray(focus_range, jnp.float32))


def gather_views(views: jnp.ndarray) -> np.ndarray:
    """Fetch a (possibly sharded) view stack to the host as [V, H, W, C]."""
    return np.asarray(blend_xla.from_planar(jax.device_get(views)))
