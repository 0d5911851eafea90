"""Focus-map estimation and filtering.

The reference estimates a per-pixel focus (disparity) by looping 32 focus
candidates x 32 views x 9 stencil taps per pixel (~9.2K clamped surface reads
per output pixel, reference: src/kernels.cu:164-258). On the GPU that
loop nest runs blocked per output tile in a Triton kernel
(ops/estimate_triton.py). The plain-XLA form, used off the GPU and as the
kernel's reference, restructures it as a **focal-stack sweep**:

  for each candidate f (lax.scan):
    1. shift the K selected views by their per-view constant offset
       floor(f * offset) onto a radius-padded domain (pure data movement),
    2. reduce elementwise min/max over views (uint8-exact, one pass),
    3. Chebyshev color range per pixel, then sum the 9 stencil taps as 9
       static slices of that range map (integer-exact),
    4. running argmin over candidates.

This computes each source pixel once per (candidate, view) instead of 9x, and
every step is vectorized over the whole image.

Numerics: identical to the oracle except at image borders -- the oracle's
per-pixel C truncation int(x + f*offset) equals x + floor(f*offset) whenever
x + f*offset >= 0, i.e. everywhere except pixels pushed past the left/top
edge, where both versions clamp to nearly the same texels. Integer cost
accumulation is exact (values < 2^24, so the oracle's float32 sums are also
exact integers).

The box filter (reference: src/kernels.cu:260-280) becomes an integral-image
(2-pass cumsum) window sum -- bit-exact vs the oracle.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from . import estimate_triton
from .blend_xla import (
    div_exact,
    no_fma,
    shift_clamped,
    trunc_offsets,
    trunc_shifted_window as blend_xla_trunc_window,
)


def round_half_away(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(x >= 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5))


def shift_pad_bound(
    offsets, focus: float, focus_range: float, radius: tuple[int, int],
    h: int, w: int, bucket: int = 64,
) -> tuple[int, int]:
    """Static (px, py) pad bound for estimate_focus_map's fast path.

    Computed host-side from concrete offsets/focus; rounded up to `bucket` so
    nearby focus settings reuse the same compiled program. Capped at the
    image size + radius (beyond that every tap clamps to the border anyway).
    """
    import numpy as np  # host-side only

    offsets = np.asarray(offsets)
    cands = [float(focus), float(focus) + float(focus_range)]
    mx = max(abs(f) * float(np.abs(offsets[:, 0]).max()) for f in cands)
    my = max(abs(f) * float(np.abs(offsets[:, 1]).max()) for f in cands)
    # +2: trunc_shifted_window fetches a (+-1) superset and clips the floor
    # shift inside the pad, so the bound must strictly exceed the max shift
    # (an integral shift exactly at the bound would otherwise be clamped one
    # pixel short, silently shifting the whole window). Cap at dim+radius+2,
    # NOT dim: a clipped shift must still push every stencil tap (+-radius)
    # past the border for the clamp to be equivalent.
    px = min(int(np.ceil(mx)), w + int(radius[0]) + 2) + int(radius[0]) + 2
    py = min(int(np.ceil(my)), h + int(radius[1]) + 2) + int(radius[1]) + 2
    rnd = lambda v: -(-v // bucket) * bucket
    return rnd(px), rnd(py)


def _encode(idx, focus, focus_range, step):
    """Map byte of candidate index `idx` (f32): round((f_idx - focus) /
    range * 255), with the oracle's op-by-op f32 rounding."""
    best_focus = focus + no_fma(step * idx)
    normalized = div_exact(best_focus - focus, focus_range)
    return round_half_away(no_fma(normalized * jnp.float32(255))).astype(jnp.uint8)


@partial(
    jax.jit,
    static_argnames=(
        "radius", "steps", "pad", "row_count", "exact_taps", "engine",
        "interpret",
    ),
)
def estimate_focus_map(
    selected: jnp.ndarray,  # [K, C, H, W] uint8 (the focus views, pre-gathered)
    sel_offsets: jnp.ndarray,  # [K, 2] float32 (x, y) offsets of those views
    focus: jnp.ndarray,  # scalar f32
    focus_range: jnp.ndarray,  # scalar f32
    radius: tuple[int, int],  # (rx, ry) static
    steps: int = 32,
    pad: tuple[int, int] | None = None,  # (px, py) static >= max shift + radius
    row_start: jnp.ndarray | int = 0,
    row_count: int | None = None,
    exact_taps: bool = True,
    slab: jnp.ndarray | None = None,  # [K, C, row_count+2py, W+2px] uint8
    coord_row0: jnp.ndarray | int = 0,
    engine: str | None = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Disparity-search focus map (FocusMap::estimate, src/kernels.cu:239-258).

    When `pad` is given (a static upper bound on |shift|+radius, see
    `shift_pad_bound`), the view stack is edge-padded ONCE and every
    candidate's shift becomes a plain dynamic_slice -- 6x less data movement
    than re-padding inside the candidate scan. Without it, shifts clamp
    through the general (concat-based) path.

    `exact_taps` (default, requires `pad`) evaluates every stencil tap with
    the per-pixel C truncation rule at the CENTER pixel, exactly like the
    oracle (focusCoords is computed once per pixel, src/kernels.cu:205-210).
    With exact_taps=False the min/max maps are computed once per candidate
    and the 9 taps become slices of them, but the truncation rule is
    evaluated at the tap position, which can flip the argmin inside a
    radius-wide band at each view's coordinate sign change.

    `engine` picks the padded path's implementation: "triton" (the
    `estimate_triton` kernel, bit-identical to the sweep) or "xla" (the
    focal-stack sweep below). None picks the kernel on the GPU, where it
    was measured faster for both tap rules (PERF.md), and the sweep
    elsewhere. `interpret=True` runs the kernel through the Pallas
    interpreter (tests only).

    `row_start`/`row_count` restrict the output to a block of rows (used by
    spatially-sharded rendering; requires `pad`). `row_start` may be traced.

    `slab` replaces the internal full edge-pad of `selected` with ONE row
    block's padded window -- padded rows [r0, r0 + row_count + 2py), exactly
    what the block's shifts and supersets read -- so memory-pressured
    renders (api.py row-blocked plans) never materialize the full padded
    copy. `coord_row0` = the block's global first output row r0 (row_start
    must then be 0, the slab-local origin). Built by
    pipeline.estimate_focus_rows; bit-identical to the same rows of the
    full-stack estimate. NOTE the slab's pads must use this function's
    effective floors: px,py = max(pad, radius+1).

    Returns [row_count or H, W] uint8: round((best_focus - focus)/range * 255).
    """
    k, c, h, w = selected.shape
    rx, ry = int(radius[0]), int(radius[1])
    if row_count is None:
        row_count = h
    elif pad is None:
        raise ValueError("row blocks require the padded fast path (pass pad=)")
    h_out = int(row_count)

    if slab is not None and pad is None:
        raise ValueError("slab mode requires the padded fast path: pass pad=")
    row_start = jnp.asarray(row_start, jnp.int32)
    focus = jnp.asarray(focus, jnp.float32)
    focus_range = jnp.asarray(focus_range, jnp.float32)
    # div_exact/no_fma: candidate values must round like the oracle's
    # op-by-op numpy expression -- a reciprocal-division or an FMA fusion
    # would introduce 1-ulp differences that flip truncated coordinates.
    step = div_exact(focus_range, jnp.float32(steps - 1))
    candidates = focus + no_fma(
        step * jnp.arange(steps, dtype=jnp.float32)
    )  # [steps]
    # Per-candidate, per-view true fractional shifts; per-pixel C truncation
    # is applied by trunc_shifted_window (exact vs the oracle, except that
    # stencil taps evaluate the trunc rule at the tap rather than the center
    # pixel -- differing only in an rx/ry-wide band at each view's sign-change
    # column/row).
    fxs = no_fma(candidates[:, None] * sel_offsets[None, :, 0])  # [steps, K]
    fys = no_fma(candidates[:, None] * sel_offsets[None, :, 1])

    stencil = [(sx, sy) for sx in (-rx, 0, rx) for sy in (-ry, 0, ry)]

    if pad is not None:
        px, py = max(int(pad[0]), rx + 1), max(int(pad[1]), ry + 1)
        if slab is not None:
            padded = slab  # the block's window of the full pad, pre-built
        else:
            padded = jnp.pad(
                selected, ((0, 0), (0, 0), (py, py), (px, px)), mode="edge"
            )  # [K, C, H+2py, W+2px]
        if engine is None:
            engine = "triton" if estimate_triton.available(padded.size) else "xla"
        if engine == "triton":
            levels = _encode(
                jnp.arange(steps, dtype=jnp.float32), focus, focus_range, step
            )
            return estimate_triton.estimate(
                padded, fxs, fys, levels, row_start,
                0 if slab is None else coord_row0,
                h_out=h_out, w=w, px=px, py=py, rx=rx, ry=ry,
                exact=exact_taps, interpret=interpret,
            )

        def shift_views(fyi, fxi):
            return jax.vmap(
                lambda img, fy, fx: blend_xla_trunc_window(
                    img, fy, fx, px=px, py=py, h_out=h_out, w=w,
                    ry=ry, rx=rx, row_start=row_start,
                    coord_base=None if slab is None else coord_row0,
                )
            )(padded, fyi, fxi)

        def supersets(fyi, fxi):
            """Per-view superset windows covering all taps + the +-1 reads."""
            def one(img, fy, fx):
                dyf = jnp.clip(
                    jnp.floor(fy).astype(jnp.int32), -(py - ry - 1), py - ry - 1
                )
                dxf = jnp.clip(
                    jnp.floor(fx).astype(jnp.int32), -(px - rx - 1), px - rx - 1
                )
                return lax.dynamic_slice(
                    img,
                    (jnp.int32(0), py - ry + dyf + row_start - 1, px - rx + dxf - 1),
                    (c, h_out + 2 * ry + 2, w + 2 * rx + 2),
                )
            return jax.vmap(one)(padded, fyi, fxi)
    else:
        if exact_taps:
            raise ValueError(
                "exact_taps requires the pre-padded fast path: pass pad= "
                "(see shift_pad_bound), or explicitly request the "
                "approximate rule with exact_taps=False"
            )

        def shift_views(fyi, fxi):
            k_, c_, h_, w_ = selected.shape
            dyi = jnp.clip(jnp.floor(fyi), -h_, h_).astype(jnp.int32)
            dxi = jnp.clip(jnp.floor(fxi), -w_, w_).astype(jnp.int32)
            return jax.vmap(
                lambda img, sy, sx: shift_clamped(img, sy, sx, pad_y=ry, pad_x=rx)
            )(selected, dyi, dxi)

    def minmax_views(shifted):
        """min AND max over the view axis in ONE pass over the data (two
        separate reduces would each re-read -- or re-compute -- the shifted
        stack; measured 1.66x on the fast path)."""
        return lax.reduce(
            (shifted, shifted),
            (jnp.asarray(255, shifted.dtype), jnp.asarray(0, shifted.dtype)),
            lambda a, b: (jnp.minimum(a[0], b[0]), jnp.maximum(a[1], b[1])),
            [0],
        )

    def cost_fast(fxi, fyi):
        """Hoisted min/max: taps are slices of one per-candidate cheby map."""
        shifted = shift_views(fyi, fxi)
        mn, mx = minmax_views(shifted)
        # Costs fit i16 (<= 9 cells * 255): halves accumulator traffic.
        cheby = jnp.max(
            mx.astype(jnp.int16) - mn.astype(jnp.int16), axis=0
        )  # [h_out+2ry, W+2rx]
        cost = jnp.zeros((h_out, w), jnp.int16)
        for sx, sy in stencil:
            cost = cost + lax.dynamic_slice(cheby, (ry + sy, rx + sx), (h_out, w))
        return cost

    def cost_exact(fxi, fyi):
        """Oracle-exact: per-cell min/max, truncation evaluated at the CENTER
        pixel with the oracle's own rounded-f32 expression (trunc_offsets)."""
        sup = supersets(fyi, fxi)  # [K,C,h+2ry+2,w+2rx+2], origin -1
        qy = (
            lax.broadcasted_iota(jnp.int32, (h_out, 1), 0) + row_start
            + (0 if slab is None else jnp.asarray(coord_row0, jnp.int32))
        )
        qx = lax.broadcasted_iota(jnp.int32, (1, w), 1)
        # d in {-1,0,1} per (view, center row/col): [K, 1, h_out, 1] / [K, 1, 1, w]
        dys = jax.vmap(lambda f: trunc_offsets(qy, f))(fyi)[:, None]
        dxs = jax.vmap(lambda f: trunc_offsets(qx, f))(fxi)[:, None]

        def sel(d, minus, base, plus):
            return jnp.where(d == 1, plus, jnp.where(d == -1, minus, base))

        cost = jnp.zeros((h_out, w), jnp.int16)
        for sy in (-ry, 0, ry):
            oy = ry + 1 + sy
            # Row-rule select hoisted across the 3 sx cells of this row.
            rows = sel(
                dys,
                sup[:, :, oy - 1 : oy - 1 + h_out, :],
                sup[:, :, oy : oy + h_out, :],
                sup[:, :, oy + 1 : oy + 1 + h_out, :],
            )  # [K, C, h_out, w+2rx+2]
            for sx in (-rx, 0, rx):
                ox = rx + 1 + sx
                tap = sel(
                    dxs,
                    rows[:, :, :, ox - 1 : ox - 1 + w],
                    rows[:, :, :, ox : ox + w],
                    rows[:, :, :, ox + 1 : ox + 1 + w],
                )  # [K, C, h_out, w]
                mn, mx = minmax_views(tap)
                rng = mx.astype(jnp.int16) - mn.astype(jnp.int16)
                # Costs fit i16 (<= 9 * 255): halves accumulator traffic.
                cost = cost + jnp.max(rng, axis=0)
        return cost

    cost_fn = cost_exact if exact_taps else cost_fast

    def one_candidate(carry, inputs):
        best_cost, best_idx, i = carry
        fxi, fyi = inputs[0], inputs[1]  # [K], [K]
        cost = cost_fn(fxi, fyi)
        better = cost < best_cost  # strict: first minimum wins, like MinDispersion
        best_cost = jnp.where(better, cost, best_cost)
        best_idx = jnp.where(better, i, best_idx)
        return (best_cost, best_idx, i + jnp.int16(1)), None

    init = (
        jnp.full((h_out, w), jnp.iinfo(jnp.int16).max, jnp.int16),
        jnp.zeros((h_out, w), jnp.int16),
        jnp.int16(0),
    )
    (best_cost, best_idx, _), _ = lax.scan(one_candidate, init, (fxs, fys))
    return _encode(best_idx.astype(jnp.float32), focus, focus_range, step)


@partial(jax.jit, static_argnames=("radius",))
def filter_focus_map(focus_map: jnp.ndarray, radius: tuple[int, int]) -> jnp.ndarray:
    """Box filter via integral image (FocusMap::filter, src/kernels.cu:260-280).

    Window x in [cx-rx, cx+rx), y in [cy-ry, cy+ry), clamped taps, average
    rounded half away from zero. Bit-exact vs the oracle. Radius 0 copies.
    """
    rx, ry = int(radius[0]), int(radius[1])
    if rx == 0 or ry == 0:
        return focus_map
    h, w = focus_map.shape
    padded = jnp.pad(focus_map, ((ry, ry), (rx, rx)), mode="edge").astype(jnp.int32)
    ii = jnp.pad(jnp.cumsum(jnp.cumsum(padded, axis=0), axis=1), ((1, 0), (1, 0)))
    # window sum for pixel (y, x) covers padded[y : y+2ry, x : x+2rx]
    s = (
        ii[2 * ry : 2 * ry + h, 2 * rx : 2 * rx + w]
        - ii[0:h, 2 * rx : 2 * rx + w]
        - ii[2 * ry : 2 * ry + h, 0:w]
        + ii[0:h, 0:w]
    )
    avg = div_exact(s.astype(jnp.float32), jnp.float32(4 * rx * ry))
    return round_half_away(avg).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("radius", "row_count"))
def filter_focus_map_block(
    focus_map: jnp.ndarray,  # [H, W] uint8 (the FULL map)
    radius: tuple[int, int],
    row_start: jnp.ndarray | int,
    row_count: int,
) -> jnp.ndarray:
    """Box filter restricted to an output row block (sharded rendering).

    Takes the full map (the +-ry halo crosses shard boundaries; the map is
    tiny, so sharded callers all_gather it first) and returns rows
    [row_start, row_start+row_count). Bit-exact vs filter_focus_map.
    """
    rx, ry = int(radius[0]), int(radius[1])
    h, w = focus_map.shape
    if rx == 0 or ry == 0:
        return lax.dynamic_slice(focus_map, (jnp.asarray(row_start, jnp.int32), 0), (row_count, w))
    padded = jnp.pad(focus_map, ((ry, ry), (rx, rx)), mode="edge").astype(jnp.int32)
    local = lax.dynamic_slice(
        padded, (jnp.asarray(row_start, jnp.int32), 0), (row_count + 2 * ry, w + 2 * rx)
    )
    ii = jnp.pad(jnp.cumsum(jnp.cumsum(local, axis=0), axis=1), ((1, 0), (1, 0)))
    s = (
        ii[2 * ry : 2 * ry + row_count, 2 * rx : 2 * rx + w]
        - ii[0:row_count, 2 * rx : 2 * rx + w]
        - ii[2 * ry : 2 * ry + row_count, 0:w]
        + ii[0:row_count, 0:w]
    )
    avg = div_exact(s.astype(jnp.float32), jnp.float32(4 * rx * ry))
    return round_half_away(avg).astype(jnp.uint8)
