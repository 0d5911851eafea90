"""The Triton disparity-search kernel (ops/estimate_triton.py).

On the CPU the kernel runs through the Pallas interpreter, which these tests
request explicitly; production code never does (see the routing tests). The
kernel's contract is a map bit-identical to the XLA focal-stack sweep for
both tap rules, and, for the exact rule, to the numpy oracle. The compiled
kernel is checked by the `gpu`-marked test here and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.models import pipeline
from lfinterpolator_tpu.ops import estimate_triton
from lfinterpolator_tpu.ops import focus as focus_ops
from lfinterpolator_tpu.ops import reference as oracle


def _setup(rng, h, w, k, focus, frange, radius, cols=4, rows=4, aspect=1.3):
    se = np.array([0, 0, cols - 1.0, rows - 1.0], np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, aspect, geometry.trajectory_center(se)
    )
    ids = np.asarray(geometry.select_focus_views(se, cols, rows, k))
    pad = focus_ops.shift_pad_bound(offsets, focus, frange, radius, h, w)
    sel = jnp.asarray(rng.integers(0, 256, (k, 3, h, w), dtype=np.uint8))
    return offsets, ids, pad, sel, jnp.asarray(offsets)[jnp.asarray(ids)]


CASES = {
    # name: (H, W, K, steps, focus, range, radius, row block or None)
    "base": (24, 72, 6, 6, 0.1, 0.4, (4, 2), None),
    "negative_focus": (24, 72, 6, 6, -0.3, 0.5, (4, 2), None),
    "odd_view_count": (24, 72, 5, 6, 0.1, 0.4, (4, 2), None),
    "big_radius": (40, 96, 6, 8, 0.0, 0.6, (10, 6), None),
    "odd_radius": (24, 72, 6, 6, 0.1, 0.4, (5, 3), None),
    "row_block": (40, 72, 6, 6, 0.1, 0.4, (4, 2), (13, 19)),
    "unaligned_sizes": (21, 67, 6, 6, 0.1, 0.4, (4, 2), None),
    "overshoot_tiles": (17, 33, 6, 6, 0.1, 0.4, (4, 2), None),  # 1-row/col tails
}


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_sweep(rng, case, exact):
    h, w, k, steps, focus, frange, radius, rows = CASES[case]
    _, _, pad, sel, sel_off = _setup(rng, h, w, k, focus, frange, radius)
    r0, rc = rows or (0, None)
    n = estimate_triton.mismatches(
        sel, sel_off, focus, frange, radius, steps=steps, pad=pad,
        exact=exact, interpret=True, row_start=r0, row_count=rc,
    )
    assert n == 0


@pytest.mark.parametrize(
    "h,w,k,focus,frange,radius",
    [(14, 40, 5, 0.1, 0.4, (4, 2)), (11, 29, 7, -0.2, 0.5, (3, 3)),
     (16, 48, 4, 0.0, 0.8, (6, 2))],
)
def test_exact_kernel_matches_oracle(rng, h, w, k, focus, frange, radius):
    """Exact taps: the kernel's map equals the reference's per-pixel loop."""
    offsets, ids, pad, _, _ = _setup(rng, h, w, k, focus, frange, radius)
    images = rng.integers(0, 256, (16, h, w, 4), dtype=np.uint8)
    planar = jnp.asarray(images[..., :3].transpose(0, 3, 1, 2))
    got = focus_ops.estimate_focus_map(
        planar[jnp.asarray(ids)], jnp.asarray(offsets)[jnp.asarray(ids)],
        jnp.float32(focus), jnp.float32(frange), radius, steps=6, pad=pad,
        engine="triton", interpret=True,
    )
    want = oracle.focus_map_estimate(
        images, offsets, ids, focus, frange, radius, steps=6
    )
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("h,rb", [(21, 8), (37, 16)])
def test_slab_blocks_match_full_sweep(rng, h, rb, exact):
    """Row-block slabs (the memory-pressured and mesh estimates): each
    block's padded window, built as pipeline.estimate_focus_rows builds it,
    gives the kernel the same rows as the full-frame sweep -- unaligned h,
    a block size that does not divide it, and windows clipped at both image
    edges included."""
    w, k, steps, focus, frange, radius = 45, 5, 6, 0.1, 0.4, (4, 2)
    _, _, pad, sel, sel_off = _setup(rng, h, w, k, focus, frange, radius)
    want = focus_ops.estimate_focus_map(
        sel, sel_off, jnp.float32(focus), jnp.float32(frange), radius,
        steps=steps, pad=pad, exact_taps=exact, engine="xla",
    )
    px, py = max(pad[0], radius[0] + 1), max(pad[1], radius[1] + 1)
    blocks = []
    for r0 in range(0, h, rb):
        rc = min(rb, h - r0)
        slab = pipeline._row_slab(
            sel, jnp.int32(r0), py=py, px=px, rc=rc,
            top=max(0, py - r0), bot=max(0, r0 + rc + py - h),
        )
        blocks.append(np.asarray(focus_ops.estimate_focus_map(
            sel, sel_off, jnp.float32(focus), jnp.float32(frange), radius,
            steps=steps, pad=pad, row_count=rc, exact_taps=exact, slab=slab,
            coord_row0=r0, engine="triton", interpret=True,
        )))
    np.testing.assert_array_equal(np.concatenate(blocks), np.asarray(want))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_small_user_pad_gets_the_floor(rng, exact):
    """A pad no larger than the radius gets the same radius+1 floor on both
    engines, so the kernel stays bit-identical instead of reading short."""
    h, w, k, focus, frange, radius = 24, 72, 6, 0.1, 0.4, (4, 2)
    _, _, _, sel, sel_off = _setup(rng, h, w, k, focus, frange, radius)
    n = estimate_triton.mismatches(
        sel, sel_off, focus, frange, radius, steps=6, pad=radius,
        exact=exact, interpret=True,
    )
    assert n == 0


def test_tables_shapes_and_bounds():
    """The coordinate tables hold absolute padded-stack rows/columns of
    every (candidate, view, window coordinate), all inside the stack."""
    fxs = jnp.asarray([[-30.7, 0.0, 12.25], [5.5, -1.0, 29.9]], jnp.float32)
    fys = -fxs / 2
    h_out, w, px, py, rx, ry = 10, 20, 40, 24, 4, 2
    ty, tx = estimate_triton._tables(
        fys, fxs, py=py, px=px, ry=ry, rx=rx, h_out=h_out, w=w,
        row_start=jnp.int32(3), coord_base=jnp.int32(0),
    )
    assert ty.shape == (2, 3, h_out + 2 * ry) and tx.shape == (2, 3, w + 2 * rx)
    hs, wp = 3 + h_out + 2 * py, w + 2 * px
    # centre taps +- the stencil offset stay in the padded stack
    assert int(ty[:, :, ry:-ry].min()) - ry >= 0
    assert int(ty[:, :, ry:-ry].max()) + ry < hs
    assert int(tx[:, :, rx:-rx].min()) - rx >= 0
    assert int(tx[:, :, rx:-rx].max()) + rx < wp


def test_routes_to_xla_off_the_gpu(rng, monkeypatch):
    """On the CPU backend the default engine is the XLA sweep: the kernel
    is never traced, so it can never run interpreted by accident."""
    calls = []
    monkeypatch.setattr(
        estimate_triton, "estimate", lambda *a, **k: calls.append(k)
    )
    _, _, pad, sel, sel_off = _setup(rng, 16, 40, 4, 0.1, 0.4, (4, 2))
    focus_ops.estimate_focus_map.__wrapped__(
        sel, sel_off, jnp.float32(0.1), jnp.float32(0.4), (4, 2), steps=4,
        pad=pad,
    )
    assert calls == []


def test_routes_to_compiled_kernel_on_the_gpu(rng, monkeypatch):
    """With a GPU backend the default engine is the kernel, compiled
    (interpret=False), with the padded stack and the candidates' levels."""
    calls = []

    def fake(padded, fxs, fys, levels, row_start, coord_base, **kw):
        calls.append(kw)
        return jnp.zeros((kw["h_out"], kw["w"]), jnp.uint8)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(estimate_triton, "estimate", fake)
    _, _, pad, sel, sel_off = _setup(rng, 16, 40, 4, 0.1, 0.4, (4, 2))
    for exact in (True, False):
        focus_ops.estimate_focus_map.__wrapped__(
            sel, sel_off, jnp.float32(0.1), jnp.float32(0.4), (4, 2),
            steps=4, pad=pad, exact_taps=exact,
        )
    assert [c["interpret"] for c in calls] == [False, False]
    assert [c["exact"] for c in calls] == [True, False]


def test_int32_index_bound_routes_to_xla(monkeypatch):
    """A padded stack of 2 GiB or more would overflow the kernel's flat
    int32 indices: such estimates stay on the sweep even on the GPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert estimate_triton.available(2**31 - 1)
    assert not estimate_triton.available(2**31)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert not estimate_triton.available(1)


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_compiled_kernel_matches_sweep(rng, exact):
    """The kernel compiled by Triton for the GPU (no interpreter) against
    the sweep on a full-width row block; chip_smoke.py runs the same check
    at the headline shape."""
    h, w, k, focus, frange, radius = 96, 1920, 32, 0.1, 0.3, (20, 2)
    _, _, pad, sel, sel_off = _setup(
        rng, h, w, k, focus, frange, radius, cols=8, rows=8
    )
    n = estimate_triton.mismatches(
        sel, sel_off, focus, frange, radius, steps=32, pad=pad,
        exact=exact, row_start=7, row_count=53,
    )
    assert n == 0
