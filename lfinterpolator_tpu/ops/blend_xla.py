"""The shift and blend stages, in plain XLA (both methods; on the GPU the
STD blend runs in the ops/blend_triton kernel).

Re-design of the reference's Standard::process and Tensors::process kernels
(reference: src/kernels.cu:312-342, 398-461). Instead of per-thread pixel
loops, the multi-view blend is one contraction:

    views[v, c, h, w] = sum_g weights[v, g] * shifted[g, c, h, w]

and the per-image clamped shift (the CUDA kernel gets it for free via
cudaBoundaryModeClamp surface reads, src/kernels.cu:119-126) becomes pure data
movement: an edge-replicating pad followed by a dynamic_slice, which XLA
lowers to copies -- no gathers in the fixed-focus path. Shift amounts are
traced values, so changing focus/trajectory does NOT trigger recompilation.

Image layout is planar ``[G, C, H, W]`` uint8 (W innermost).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from . import blend_triton


def to_planar(images: jnp.ndarray, channels: int = 3) -> jnp.ndarray:
    """[G, H, W, C>=channels] -> [G, channels, H, W]."""
    return jnp.transpose(images[..., :channels], (0, 3, 1, 2))


def from_planar(views: jnp.ndarray) -> jnp.ndarray:
    """[V, C, H, W] -> [V, H, W, C]."""
    return jnp.transpose(views, (0, 2, 3, 1))


def shift_axis_clamped(
    x: jnp.ndarray,
    shift: jnp.ndarray,
    axis: int,
    pad: int = 0,
    start: jnp.ndarray | int = 0,
    size: int | None = None,
) -> jnp.ndarray:
    """out[..., q, ...] = x[..., clip(start + q + shift, 0, n-1), ...]
    for q in [-pad, size+pad).

    `shift` and `start` may be traced scalars; `start`/`size` select an output
    window (used by spatially-sharded rendering, where each shard produces its
    own row block). Implemented as edge-replicating pad + dynamic_slice (pure
    data movement; no gather). Shifts beyond +-n are semantically identical to
    +-n under the clamp, so they are clipped first.
    """
    n = x.shape[axis]
    if size is None:
        size = n
    shift = jnp.clip(shift, -n, n) + jnp.asarray(start, jnp.int32)
    first = lax.slice_in_dim(x, 0, 1, axis=axis)
    last = lax.slice_in_dim(x, n - 1, n, axis=axis)
    rep = n + pad
    padded = jnp.concatenate(
        [jnp.repeat(first, rep, axis), x, jnp.repeat(last, rep, axis)], axis=axis
    )
    starts = [jnp.int32(0)] * x.ndim
    starts[axis] = (n + shift).astype(jnp.int32)
    sizes = list(x.shape)
    sizes[axis] = size + 2 * pad
    return lax.dynamic_slice(padded, starts, sizes)


def shift_clamped(
    image: jnp.ndarray, dy: jnp.ndarray, dx: jnp.ndarray, pad_y: int = 0, pad_x: int = 0
) -> jnp.ndarray:
    """Clamped 2-D shift of one planar image [C, H, W].

    Returns [C, H + 2*pad_y, W + 2*pad_x] where output pixel (q_y, q_x) --
    indexed from (-pad_y, -pad_x) -- reads image[clip(q_y+dy), clip(q_x+dx)].
    """
    out = shift_axis_clamped(image, dy, axis=1, pad=pad_y)
    return shift_axis_clamped(out, dx, axis=2, pad=pad_x)


def trunc_offsets(
    q: jnp.ndarray,  # integer output coordinates (as f32-exact ints), [N, 1] or [1, N]
    f: jnp.ndarray,  # scalar fractional shift (focus * offset component), f32
) -> jnp.ndarray:
    """Per-coordinate delta of the oracle's truncated coordinate vs q+floor(f).

    The reference (and the oracle) compute `int(coord + shift)` -- a SINGLE
    f32 addition, rounded, then truncated toward zero (focusCoords,
    src/kernels.cu:78-82). Because the addition rounds, the result is NOT
    always q + floor(f): near integer boundaries the rounded sum can cross
    them in either direction, and negative values truncate upward. This
    computes d = trunc(f32(q + f)) - (q + floor(f)) elementwise with the
    oracle's own expression; d is in {-1, 0, 1}.
    """
    qf = q.astype(jnp.float32)
    t = jnp.trunc(qf + f)  # the oracle's coordinate, exactly
    # |d| <= 1 mathematically; the clip guards degenerate huge-shift values
    # where the f32 re-association here could wobble (those configurations
    # read edge-clamped pixels whatever d is).
    return jnp.clip((t - (qf + jnp.floor(f))).astype(jnp.int32), -1, 1)


def trunc_shifted_window(
    padded: jnp.ndarray,  # [C, H+2py, W+2px] edge-padded image
    fy: jnp.ndarray,  # true fractional row shift (focus * offset_y), f32
    fx: jnp.ndarray,  # true fractional col shift, f32
    *,
    px: int,
    py: int,
    h_out: int,
    w: int,
    ry: int = 0,
    rx: int = 0,
    row_start: jnp.ndarray | int = 0,
    coord_base: jnp.ndarray | int | None = None,
) -> jnp.ndarray:
    """Exact C-truncation shifted window from a pre-padded image.

    out[qy, qx] = img[clip(int(Y + fy), 0, H-1), clip(int(X + fx), 0, W-1)]
    for output coords qy in [row_start-ry, row_start+h_out+ry),
    qx in [-rx, w+rx), where int(Y + fy) is evaluated exactly as the
    reference's focusCoords cast does (src/kernels.cu:78-82): one rounded f32
    addition, truncated toward zero. Implemented as ONE dynamic slice of a
    (+1 each side) superset window plus per-row/column 3-way selects driven
    by the oracle's own trunc expression (see trunc_offsets) -- no gathers,
    bit-exact including f32 rounding at integer boundaries.

    `coord_base` overrides the GLOBAL output row of `padded`'s first output
    row (default: padded covers the whole image, so it equals row_start's
    origin, 0). A row-block SLAB -- padded rows [r0, r0 + rc + 2py) of the
    full edge-padded image, exactly the window a block's compute reads --
    passes its global base r0 here while row_start stays slab-local, so the
    per-pixel truncation still evaluates at the true global coordinate.
    """
    c = padded.shape[0]
    dyf = jnp.clip(jnp.floor(fy).astype(jnp.int32), -(py - ry - 1), py - ry - 1)
    dxf = jnp.clip(jnp.floor(fx).astype(jnp.int32), -(px - rx - 1), px - rx - 1)
    row_start = jnp.asarray(row_start, jnp.int32)
    sup = lax.dynamic_slice(
        padded,
        (jnp.int32(0), py - ry + dyf + row_start - 1, px - rx + dxf - 1),
        (c, h_out + 2 * ry + 2, w + 2 * rx + 2),
    )
    qy = (
        lax.broadcasted_iota(jnp.int32, (h_out + 2 * ry, 1), 0) - ry + row_start
        + (0 if coord_base is None else jnp.asarray(coord_base, jnp.int32))
    )
    qx = lax.broadcasted_iota(jnp.int32, (1, w + 2 * rx), 1) - rx
    dy = trunc_offsets(qy, fy)[None]  # [1, Hout, 1] in {-1, 0, 1}
    dx = trunc_offsets(qx, fx)[None]  # [1, 1, Wout]

    def pick_rows(off):  # rows at 1+off relative to the superset origin
        return lambda cols0: sup[:, 1 + off : 1 + off + h_out + 2 * ry,
                                 cols0 : cols0 + w + 2 * rx]

    def sel_axis(d, minus, base, plus):
        return jnp.where(d == 1, plus, jnp.where(d == -1, minus, base))

    def col_select(rowsel):
        return sel_axis(dx, rowsel(0), rowsel(1), rowsel(2))

    return sel_axis(
        dy,
        col_select(pick_rows(-1)),
        col_select(pick_rows(0)),
        col_select(pick_rows(1)),
    )


def shift_stack(images: jnp.ndarray, offsets_xy: jnp.ndarray) -> jnp.ndarray:
    """Shift every image of a stack [G, C, H, W] by its (dx, dy) int offsets."""
    return jax.vmap(lambda img, o: shift_clamped(img, o[1], o[0]))(images, offsets_xy)


def blend(
    shifted: jnp.ndarray,  # [G, C, H, W] uint8
    weights: jnp.ndarray,  # [V, G] float32
    method: str = "STD",
) -> jnp.ndarray:
    """Contraction over the grid dimension -> [V, C, H, W] uint8.

    STD: float32 accumulation and round-half-to-even output, matching the
    reference STD kernel (src/kernels.cu:292-310). On the GPU it is the
    blend_triton kernel, which sums the images in the reference's order, so
    view batches and row blocks never change a byte; elsewhere an f32
    contraction at HIGHEST precision (no TF32). TEN: fp16 operands with
    float32 accumulation on the tensor cores, the reference TEN_WM's GEMM
    (src/kernels.cu:398-461) with a wider accumulator. Both operands are
    exact in fp16 -- pixels are integers 0..255 and the weights are
    fp16-quantized (geometry.quantize_weights_f16) -- so TEN differs from
    STD only by accumulation order (<= 1 LSB).
    """
    g, c, h, w = shifted.shape
    v = weights.shape[0]
    flat = shifted.reshape(g, c * h * w)
    if method == "TEN":
        acc = lax.dot_general(
            weights.astype(jnp.float16), flat.astype(jnp.float16),
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32,
        )
    elif blend_triton.available(g, v, c * h * w):
        return blend_triton.blend(flat, weights).reshape(v, c, h, w)
    else:
        acc = jnp.einsum(
            "vg,gp->vp", weights, flat.astype(jnp.float32),
            precision=lax.Precision.HIGHEST,
        )
    out = jnp.clip(jnp.round(acc), 0, 255).astype(jnp.uint8)
    return out.reshape(v, c, h, w)


def render_fixed(
    images: jnp.ndarray,  # [G, C, H, W] uint8
    weights: jnp.ndarray,  # [V, G] float32 (pre-quantized if parity is wanted)
    focused_offsets: jnp.ndarray,  # [G, 2] int32 (dx, dy)
    method: str = "STD",
) -> jnp.ndarray:
    """Fixed-focus render: shift + blend (Standard::process<false>)."""
    return blend(shift_stack(images, focused_offsets), weights, method)


def no_fma(x: jnp.ndarray) -> jnp.ndarray:
    """Round an intermediate f32 product before it feeds an add.

    XLA fuses `a*b + c` into one loop and LLVM then contracts it into an
    FMA, skipping the product's IEEE rounding (an optimization barrier does
    not survive XLA's CPU and GPU pipelines). Any expression that later
    feeds a truncation (`int(coord + shift)`) must round exactly like the
    two-op oracle, or a 1-ulp difference flips the source pixel entirely.
    A select on the product sits between the multiply and the add, so the
    product is rounded on its own; it maps NaN to 0, which no caller
    produces.
    """
    return jnp.where(jnp.isnan(x), jnp.zeros_like(x), x)


def div_exact(a: jnp.ndarray, b) -> jnp.ndarray:
    """Correctly-rounded f32 division.

    XLA:GPU lowers f32 `/` to an approximate division that misrounds about
    30% of quotients by an ulp. Focus values and map bytes are quotients
    that feed C truncation / rounding, so a 1-ulp difference vs the
    IEEE-dividing oracle (and the reference's CUDA f32 divide) flips whole
    source pixels. Markstein correction: refine the quotient with an EXACT
    residual computed via Dekker/Veltkamp two-product; no_fma keeps every
    product rounded on its own, which the splitting relies on.
    """
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32) * jnp.ones_like(a)
    q = a / b
    # Dekker two-product: q*b = p + e exactly.
    split = jnp.float32(4097.0)  # 2^12 + 1 splitter for f32
    tq = no_fma(q * split)
    q_hi = tq - (tq - q)
    q_lo = q - q_hi
    tb = no_fma(b * split)
    b_hi = tb - (tb - b)
    b_lo = b - b_hi
    p = no_fma(q * b)
    e = (
        ((no_fma(q_hi * b_hi) - p) + no_fma(q_hi * b_lo))
        + no_fma(q_lo * b_hi)
    ) + no_fma(q_lo * b_lo)
    r = (a - p) - e  # exact residual a - q*b
    return q + r / b  # |r/b| < 1 ulp(q): final add rounds correctly


def focus_values_from_map(
    focus_map: jnp.ndarray, focus: jnp.ndarray, focus_range: jnp.ndarray
) -> jnp.ndarray:
    """uint8 map -> per-pixel focus (loadFocusFromMap, src/kernels.cu:134-137)."""
    return focus.astype(jnp.float32) + no_fma(
        div_exact(focus_map.astype(jnp.float32), jnp.float32(255))
        * focus_range.astype(jnp.float32)
    )


def allfocus_selected(
    images: jnp.ndarray,  # [G, C, H, W] uint8
    offsets: jnp.ndarray,  # [G, 2] float32 (x, y)
    focus_map: jnp.ndarray,  # [h_out, W] uint8
    focus: jnp.ndarray,
    focus_range: jnp.ndarray,
    row_start: jnp.ndarray | int = 0,
    row_count: int | None = None,
) -> jnp.ndarray:
    """Every image shifted by its pixel's focus -> [G, C, h_out, W] uint8.

    The weight-independent select of the per-pixel-focus render
    (Standard::process<true>, src/kernels.cu:312-342): source coordinates
    are int(coord + focusValue*offset) with C truncation toward zero
    (src/kernels.cu:78-82), clamped, read with one gather per image -- the
    reference's clamped surface reads. Exact for any map (the filtered map
    the STD method reads has arbitrary bytes).

    With `row_start`/`row_count`, selects only that block of output rows
    (read from the full stack); `focus_map` must then be the matching
    [row_count, W] block.
    """
    g, c, h, w = images.shape
    h_out = h if row_count is None else int(row_count)
    fv = focus_values_from_map(focus_map, focus, focus_range)  # [h_out, W]
    yy = lax.broadcasted_iota(jnp.float32, (h_out, w), 0) + jnp.asarray(
        row_start, jnp.float32
    )
    xx = lax.broadcasted_iota(jnp.float32, (h_out, w), 1)

    def one(img, off):
        cx = jnp.clip(jnp.trunc(xx + no_fma(fv * off[0])).astype(jnp.int32), 0, w - 1)
        cy = jnp.clip(jnp.trunc(yy + no_fma(fv * off[1])).astype(jnp.int32), 0, h - 1)
        flat_idx = (cy * w + cx).reshape(-1)  # [h_out*W]
        return jnp.take(img.reshape(c, h * w), flat_idx, axis=1)  # [C, h_out*W]

    return jax.vmap(one)(images, offsets).reshape(g, c, h_out, w)


def render_allfocus(
    images: jnp.ndarray,  # [G, C, H, W] uint8
    weights: jnp.ndarray,  # [V, G] float32
    offsets: jnp.ndarray,  # [G, 2] float32 (x, y)
    focus_map: jnp.ndarray,  # [h_out, W] uint8
    focus: jnp.ndarray,
    focus_range: jnp.ndarray,
    row_start: jnp.ndarray | int = 0,
    row_count: int | None = None,
    method: str = "STD",
) -> jnp.ndarray:
    """Per-pixel-focus render (Standard::process<true>): select + blend."""
    return blend(
        allfocus_selected(
            images, offsets, focus_map, focus, focus_range,
            row_start=row_start, row_count=row_count,
        ),
        weights, method,
    )
