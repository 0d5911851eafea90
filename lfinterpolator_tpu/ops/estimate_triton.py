"""Disparity-search kernel for the GPU (Pallas, Triton route).

The blocked form of the reference's per-thread focus loop
(src/kernels.cu:164-258): one program per [BH, BW] output tile loops over
the focus candidates and, inside, over the K focus views, and reads the
9 stencil taps x C channels of every pixel as gathered byte loads from the
edge-padded view stack (L1/L2 serve their reuse). The per-tap minimum and
maximum, the Chebyshev cost and the running argmin stay in registers, and
each pixel is stored once as its map byte -- no [steps, K, ...]
intermediate touches device memory.

The per-pixel C truncation of the shifted coordinates is resolved outside
the kernel, in XLA, into two small tables of absolute padded-stack
rows/columns per (candidate, view, coordinate) -- the same
`blend_xla.trunc_offsets` expression the XLA sweep evaluates, so the
kernel's map is bit-identical to `focus.estimate_focus_map`'s sweep. One
static switch picks the tap rule: `exact` reads every tap at its centre
pixel's truncated coordinate plus the stencil offset (the oracle's rule);
otherwise each tap is truncated at its own position (`--fast-focus`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .blend_xla import trunc_offsets

#: Output tile (rows, columns) of one program; powers of two for Triton.
#: Chosen on the card among tiles of 256-1024 pixels and two loop orders
#: (PERF.md): a small tile keeps the 2 x 9 x C running min/max in registers.
BLOCK = (8, 32)
NUM_WARPS = 4
NUM_STAGES = 1


def available(stack_bytes: int) -> bool:
    """Whether the compiled kernel serves a padded stack of `stack_bytes`:
    only on the GPU backend, and only while the kernel's flat int32 byte
    indices into the stack cannot overflow."""
    return jax.default_backend() == "gpu" and stack_bytes < 2**31


def _tables(fys, fxs, *, py, px, ry, rx, h_out, w, row_start, coord_base):
    """Absolute padded-stack rows [S, K, h_out+2ry] and columns
    [S, K, w+2rx] of every shifted coordinate.

    Entry i of the row table is the padded row that output-local row
    i-ry reads for that (candidate, view): py + local row + the clipped
    floor shift + the truncation correction evaluated at the row's
    global coordinate (the XLA sweep's trunc_shifted_window/supersets
    arithmetic, term for term). Columns likewise, with no row offset."""
    dyf = jnp.clip(jnp.floor(fys).astype(jnp.int32), -(py - ry - 1), py - ry - 1)
    dxf = jnp.clip(jnp.floor(fxs).astype(jnp.int32), -(px - rx - 1), px - rx - 1)
    qy = jnp.arange(h_out + 2 * ry, dtype=jnp.int32) - ry + row_start
    qx = jnp.arange(w + 2 * rx, dtype=jnp.int32) - rx
    dy = trunc_offsets((qy + coord_base)[None, None, :], fys[:, :, None])
    dx = trunc_offsets(qx[None, None, :], fxs[:, :, None])
    ty = py + qy[None, None, :] + dyf[:, :, None] + dy
    tx = px + qx[None, None, :] + dxf[:, :, None] + dx
    return ty, tx


def _kernel(ty_ref, tx_ref, lv_ref, src_ref, out_ref, *, steps, k, c, h_out,
            w, hs, wp, ry, rx, exact):
    bh, bw = BLOCK
    r_raw = pl.program_id(0) * bh + jnp.arange(bh, dtype=jnp.int32)
    c_raw = pl.program_id(1) * bw + jnp.arange(bw, dtype=jnp.int32)
    # Overhanging rows/columns recompute the last valid pixel, so every
    # read stays in bounds.
    rows = jnp.minimum(r_raw, h_out - 1)
    cols = jnp.minimum(c_raw, w - 1)
    ny, nx = h_out + 2 * ry, w + 2 * rx
    plane = hs * wp
    offs_y, offs_x = (-ry, 0, ry), (-rx, 0, rx)

    def candidate(s, carry):
        best_cost, best_lv = carry

        def view(kk, acc):
            # One view's 9 taps x C channels: the table rows/columns are
            # loaded once per (candidate, view) and shared by the channels.
            mns, mxs = acc
            tyb = (s * k + kk) * ny + ry
            txb = (s * k + kk) * nx + rx
            if exact:
                r0 = ty_ref[tyb + rows]
                c0 = tx_ref[txb + cols]
                rsel = [r0 + o for o in offs_y]
                csel = [c0 + o for o in offs_x]
            else:
                rsel = [ty_ref[tyb + o + rows] for o in offs_y]
                csel = [tx_ref[txb + o + cols] for o in offs_x]
            new_mn, new_mx = [], []
            for ci in range(c):
                base = (kk * c + ci) * plane
                for a in range(3):
                    rb = (base + rsel[a] * wp)[:, None]
                    for b in range(3):
                        v = src_ref[rb + csel[b][None, :]].astype(jnp.int32)
                        t = 9 * ci + 3 * a + b
                        new_mn.append(jnp.minimum(mns[t], v))
                        new_mx.append(jnp.maximum(mxs[t], v))
            return tuple(new_mn), tuple(new_mx)

        init = (
            (jnp.full((bh, bw), 255, jnp.int32),) * (9 * c),
            (jnp.zeros((bh, bw), jnp.int32),) * (9 * c),
        )
        mns, mxs = lax.fori_loop(0, k, view, init)
        cost = None
        for t in range(9):
            cheby = mxs[t] - mns[t]
            for ci in range(1, c):
                cheby = jnp.maximum(cheby, mxs[9 * ci + t] - mns[9 * ci + t])
            cost = cheby if cost is None else cost + cheby
        # strict: the first minimum wins, like the sweep and MinDispersion
        better = cost < best_cost
        lv = lv_ref[s]
        return jnp.where(better, cost, best_cost), jnp.where(better, lv, best_lv)

    init = (
        jnp.full((bh, bw), jnp.iinfo(jnp.int32).max, jnp.int32),
        jnp.zeros((bh, bw), jnp.int32),
    )
    _, best_lv = lax.fori_loop(0, steps, candidate, init)
    # The output is allocated in whole tiles, so every store is in bounds
    # and unmasked; the caller crops the overhang.
    idx = r_raw[:, None] * (pl.num_programs(1) * bw) + c_raw[None, :]
    out_ref[idx] = best_lv.astype(jnp.uint8)


def mismatches(selected, sel_offsets, focus, focus_range, radius, *,
               steps, pad, exact, interpret=False, row_start=0,
               row_count=None) -> int:
    """Map pixels where this kernel and the XLA sweep disagree for the
    same `focus.estimate_focus_map` call (the kernel's contract is 0).
    The compiled-kernel test and chip_smoke.py both run this check."""
    from . import focus as focus_ops

    def run(engine, **kw):
        return focus_ops.estimate_focus_map(
            selected, sel_offsets, jnp.float32(focus),
            jnp.float32(focus_range), radius, steps=steps, pad=pad,
            exact_taps=exact, row_start=row_start, row_count=row_count,
            engine=engine, **kw,
        )

    return int(jnp.sum(run("triton", interpret=interpret) != run("xla")))


@functools.partial(
    jax.jit,
    static_argnames=(
        "h_out", "w", "px", "py", "rx", "ry", "exact", "interpret",
    ),
)
def estimate(
    padded: jnp.ndarray,  # [K, C, Hs, W+2px] uint8, edge-padded stack/slab
    fxs: jnp.ndarray,  # [S, K] float32 true fractional column shifts
    fys: jnp.ndarray,  # [S, K] float32 true fractional row shifts
    levels: jnp.ndarray,  # [S] uint8 map byte of each candidate
    row_start: jnp.ndarray | int,
    coord_base: jnp.ndarray | int,
    *,
    h_out: int,
    w: int,
    px: int,
    py: int,
    rx: int,
    ry: int,
    exact: bool,
    interpret: bool = False,
) -> jnp.ndarray:
    """Focus map [h_out, w] uint8 of one output row block.

    `padded` holds padded rows [0, Hs) whose output-local row q sits at
    padded row py + row_start + q; `coord_base` is the global row of
    local row 0 (non-zero for a row-block slab). `interpret=True` runs the
    kernel through the Pallas interpreter (CPU tests); otherwise it is
    compiled by Triton for the GPU."""
    k, c, hs, wp = padded.shape
    steps = fxs.shape[0]
    ty, tx = _tables(
        fys, fxs, py=py, px=px, ry=ry, rx=rx, h_out=h_out, w=w,
        row_start=jnp.asarray(row_start, jnp.int32),
        coord_base=jnp.asarray(coord_base, jnp.int32),
    )
    bh, bw = BLOCK
    nby, nbx = pl.cdiv(h_out, bh), pl.cdiv(w, bw)
    kernel = functools.partial(
        _kernel, steps=steps, k=k, c=c, h_out=h_out, w=w, hs=hs, wp=wp,
        ry=ry, rx=rx, exact=exact,
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((nby * bh * nbx * bw,), jnp.uint8),
        grid=(nby, nbx),
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        backend="triton",
        interpret=interpret,
        name="lfi_focus_estimate",
    )(
        ty.reshape(-1), tx.reshape(-1), levels.astype(jnp.int32),
        padded.reshape(-1),
    )
    return out.reshape(nby * bh, nbx * bw)[:h_out, :w]
