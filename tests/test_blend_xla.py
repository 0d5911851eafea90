"""Golden tests: pure-XLA blend paths vs the NumPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.ops import blend_xla, reference as oracle


def _setup(rng, cols=3, rows=3, h=24, w=32, v=8, effect=3.0):
    g = cols * rows
    images = rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8)
    start_end = np.array([0.0, 0.0, cols - 1.0, rows - 1.0], dtype=np.float32)
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(start_end, cols, rows, effect, v)
    )
    center = geometry.trajectory_center(start_end)
    offsets = geometry.compute_offsets(cols, rows, w, h, 1.0, center)
    return images, wm, offsets


def test_shift_axis_clamped_matches_numpy(rng):
    x = rng.integers(0, 256, size=(2, 6, 9), dtype=np.uint8)
    for shift in [-20, -6, -3, 0, 2, 5, 9, 30]:
        got = np.asarray(blend_xla.shift_axis_clamped(jnp.asarray(x), shift, axis=2))
        idx = np.clip(np.arange(9) + shift, 0, 8)
        np.testing.assert_array_equal(got, x[:, :, idx], err_msg=f"shift={shift}")


def test_shift_axis_clamped_with_padding(rng):
    x = rng.integers(0, 256, size=(1, 4, 7), dtype=np.uint8)
    pad = 3
    got = np.asarray(
        blend_xla.shift_axis_clamped(jnp.asarray(x), 2, axis=2, pad=pad)
    )
    assert got.shape == (1, 4, 7 + 2 * pad)
    idx = np.clip(np.arange(-pad, 7 + pad) + 2, 0, 6)
    np.testing.assert_array_equal(got, x[:, :, idx])


def test_render_fixed_matches_oracle(rng):
    images, wm, offsets = _setup(rng)
    for focus in [0.0, 0.37, -0.5, 1.2]:
        fo = geometry.focused_offsets(offsets, focus)
        want = oracle.blend_fixed(images, wm, fo)
        got = blend_xla.render_fixed(
            blend_xla.to_planar(jnp.asarray(images)),
            jnp.asarray(wm.astype(np.float32)),
            jnp.asarray(fo),
        )
        got = np.asarray(blend_xla.from_planar(got))
        # float32 accumulation order differs (sequential vs the library
        # GEMM) so values on exact rounding boundaries may differ by 1 LSB.
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1, f"focus={focus}: max diff {diff.max()}"
        assert (diff > 0).mean() < 0.01, f"focus={focus}: mismatch rate too high"


def test_render_fixed_large_shift_clamps(rng):
    # Shifts larger than the image must behave like full clamp (edge colors).
    images, wm, offsets = _setup(rng, h=16, w=20)
    fo = geometry.focused_offsets(offsets, 50.0)  # enormous shifts
    want = oracle.blend_fixed(images, wm, fo)
    got = np.asarray(
        blend_xla.from_planar(
            blend_xla.render_fixed(
                blend_xla.to_planar(jnp.asarray(images)),
                jnp.asarray(wm.astype(np.float32)),
                jnp.asarray(fo),
            )
        )
    )
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1


def test_render_allfocus_matches_oracle(rng):
    images, wm, offsets = _setup(rng)
    h, w = images.shape[1:3]
    fmap = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    focus, frange = 0.05, 0.4
    want = oracle.blend_allfocus(images, wm, offsets, fmap, focus, frange)
    got = np.asarray(
        blend_xla.from_planar(
            blend_xla.render_allfocus(
                blend_xla.to_planar(jnp.asarray(images)),
                jnp.asarray(wm.astype(np.float32)),
                jnp.asarray(offsets),
                jnp.asarray(fmap),
                jnp.float32(focus),
                jnp.float32(frange),
            )
        )
    )
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


def test_render_allfocus_negative_focus_truncation(rng):
    # Negative focus exercises the trunc-toward-zero (not floor) semantics.
    images, wm, offsets = _setup(rng, cols=2, rows=2, h=12, w=12, v=4)
    h, w = images.shape[1:3]
    fmap = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    focus, frange = -0.6, 0.3
    want = oracle.blend_allfocus(images, wm, offsets, fmap, focus, frange)
    got = np.asarray(
        blend_xla.from_planar(
            blend_xla.render_allfocus(
                blend_xla.to_planar(jnp.asarray(images)),
                jnp.asarray(wm.astype(np.float32)),
                jnp.asarray(offsets),
                jnp.asarray(fmap),
                jnp.float32(focus),
                jnp.float32(frange),
            )
        )
    )
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1


def test_planar_roundtrip(rng):
    images = rng.integers(0, 256, size=(3, 5, 7, 4), dtype=np.uint8)
    p = blend_xla.to_planar(jnp.asarray(images))
    assert p.shape == (3, 3, 5, 7)
    back = np.asarray(blend_xla.from_planar(p))
    np.testing.assert_array_equal(back, images[..., :3])


def test_trunc_shifted_window_f32_rounding_adversarial(rng):
    """The oracle truncates the ROUNDED f32 sum coord+shift; shifts within an
    ulp of an integer must reproduce that, not floor(shift)+correction
    (regression for a review finding: a shift of nextafter(2.0, 0) moved the
    whole frame one source row)."""
    import math

    img = rng.integers(0, 256, size=(3, 24, 40), dtype=np.uint8)
    h, w = 24, 40
    px = py = 64
    padded = np.pad(img, ((0, 0), (py, py), (px, px)), mode="edge")
    adversarial = [
        np.float32(math.nextafter(2.0, 0.0)),
        np.float32(math.nextafter(2.0, 4.0)),
        np.float32(-math.nextafter(2.0, 0.0)),
        np.float32(math.nextafter(-3.0, 0.0)),
        np.float32(1.9999999),
        np.float32(-0.0),
        np.float32(7.5),
        np.float32(-7.5),
        np.float32(2.0),
    ]
    for fy in adversarial:
        for fx in adversarial[::2]:
            got = np.asarray(
                blend_xla.trunc_shifted_window(
                    jnp.asarray(padded), jnp.float32(fy), jnp.float32(fx),
                    px=px, py=py, h_out=h, w=w,
                )
            )
            # oracle semantics: per-pixel trunc of the rounded f32 sum
            qy = np.arange(h, dtype=np.float32)
            qx = np.arange(w, dtype=np.float32)
            cy = np.clip(np.trunc(qy + fy).astype(np.int64), 0, h - 1)
            cx = np.clip(np.trunc(qx + fx).astype(np.int64), 0, w - 1)
            want = img[:, cy[:, None], cx[None, :]]
            np.testing.assert_array_equal(got, want, err_msg=f"fy={fy} fx={fx}")


def test_allfocus_near_integer_shift(rng):
    """End-to-end regression: per-pixel shifts within an ulp of an integer."""
    import math

    h, w, g, v, steps = 16, 24, 4, 4, 4
    images = rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8)
    wm = np.full((v, g), 0.25, dtype=np.float16)
    # Choose offsets so byte 255 (f = focus + range) lands a shift of
    # nextafter(2.0, 0) in y for image 0.
    target = np.float32(math.nextafter(2.0, 0.0))
    offsets = np.array(
        [[0.3, float(target) / 0.5], [1.0, -2.0], [-1.7, 0.9], [0.0, 0.0]],
        np.float32,
    )
    focus, frange = 0.0, 0.5
    lev = np.round(np.arange(steps) / (steps - 1) * 255).astype(np.uint8)
    fmap = lev[rng.integers(0, steps, size=(h, w))]
    want = oracle.blend_allfocus(images, wm, offsets, fmap, focus, frange)
    got = np.asarray(
        blend_xla.from_planar(
            jax.jit(blend_xla.render_allfocus)(
                blend_xla.to_planar(jnp.asarray(images)),
                jnp.asarray(wm.astype(np.float32)),
                jnp.asarray(offsets),
                jnp.asarray(fmap),
                jnp.float32(focus),
                jnp.float32(frange),
            )
        )
    )
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_div_exact_matches_ieee(rng):
    """div_exact == IEEE f32 division bit-for-bit, for any operands and for
    the map decode's byte/255 quotients."""
    a = ((rng.random(50000) - 0.3) * np.exp2(rng.integers(-8, 12, 50000))).astype(np.float32)
    b = ((rng.random(50000) + 1e-3) * np.exp2(rng.integers(-4, 10, 50000))).astype(np.float32)
    got = np.asarray(blend_xla.div_exact(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.view(np.uint32), (a / b).view(np.uint32))
    bytes_ = np.arange(256, dtype=np.float32)
    got2 = np.asarray(blend_xla.div_exact(jnp.asarray(bytes_), jnp.float32(255)))
    np.testing.assert_array_equal(
        got2.view(np.uint32), (bytes_ / np.float32(255)).view(np.uint32)
    )


@pytest.mark.parametrize("method", ["STD", "TEN"])
@pytest.mark.parametrize("cols,rows", [(2, 2), (3, 3), (4, 4), (5, 5), (6, 6),
                                       (8, 8), (9, 9)])
def test_blend_matches_oracle_grid_sizes(rng, cols, rows, method):
    """STD (f32 HIGHEST) and TEN (fp16 operands, f32 accumulation) blends
    vs the oracle over grids of 4..81 images, a batch of 5 views and an
    unaligned 13x21 frame: within 1 LSB (accumulation order only)."""
    images, wm, offsets = _setup(rng, cols=cols, rows=rows, h=13, w=21, v=5)
    fo = geometry.focused_offsets(offsets, 0.3)
    want = oracle.blend_fixed(images, wm, fo)
    got = jax.jit(blend_xla.render_fixed, static_argnums=3)(
        blend_xla.to_planar(jnp.asarray(images)),
        jnp.asarray(wm.astype(np.float32)), jnp.asarray(fo), method,
    )
    got = np.asarray(blend_xla.from_planar(got))
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


SHIFT_CASES = [
    # (G, C, H, W, shift bound x, shift bound y)
    (4, 3, 96, 512, 128, 64),
    (3, 3, 100, 300, 128, 128),  # odd H/W
    (2, 1, 37, 130, 256, 256),  # shifts beyond the frame
    (2, 3, 64, 256, 640, 320),  # far beyond the frame: full clamp
    (2, 3, 216, 640, 384, 384),
]


@pytest.mark.parametrize(
    "case", SHIFT_CASES, ids=lambda c: f"g{c[0]}c{c[1]}_{c[2]}x{c[3]}"
)
def test_shift_stack_matches_oracle(case, rng):
    """The edge-pad + dynamic-slice clamped shift equals the oracle's
    clamped reads for every image of the stack."""
    g, c, h, w, bx, by = case
    raw = rng.integers(0, 256, (g, c, h, w), dtype=np.uint8)
    fo = (rng.uniform(-1, 1, (g, 2)) * np.array([bx, by])).astype(np.int32)
    got = np.asarray(jax.jit(blend_xla.shift_stack)(jnp.asarray(raw),
                                                    jnp.asarray(fo)))
    for i in range(g):
        want = oracle._shift_clamped(
            raw[i].transpose(1, 2, 0), fo[i, 1], fo[i, 0]
        ).transpose(2, 0, 1)
        np.testing.assert_array_equal(got[i], want, err_msg=f"image {i}")


def test_shift_row_window_matches_oracle(rng):
    """A row window (start, size) of the clamped shift -- what each mesh
    shard renders -- equals the same rows of the oracle's full shift."""
    raw = rng.integers(0, 256, (3, 40, 56), dtype=np.uint8)
    for shift in (-70, -9, 0, 5, 41):
        full = oracle._shift_clamped(raw.transpose(1, 2, 0), shift, 0)
        for start, size in ((0, 10), (10, 10), (30, 10), (13, 17)):
            got = np.asarray(blend_xla.shift_axis_clamped(
                jnp.asarray(raw), jnp.int32(shift), axis=1,
                start=jnp.int32(start), size=size,
            ))
            np.testing.assert_array_equal(
                got, full[start : start + size].transpose(2, 0, 1),
                err_msg=f"shift={shift} rows {start}+{size}",
            )


def _estimator_map(rng, h, w, focus, frange, steps):
    """A map restricted to the estimator's byte levels (TEN's raw map)."""
    from lfinterpolator_tpu.ops import focus as focus_ops

    step = np.float32(frange) / np.float32(steps - 1)
    cand = np.float32(focus) + step * np.arange(steps, dtype=np.float32)
    lev = np.asarray(focus_ops.round_half_away(
        jnp.asarray((cand - np.float32(focus)) / np.float32(frange)
                    * np.float32(255))
    )).astype(np.uint8)
    return lev[rng.integers(0, steps, size=(h, w))]


ALLFOCUS_CASES = [
    # (cols, rows, H, W, focus, range)
    (3, 3, 24, 32, 0.05, 0.4),
    (2, 3, 17, 45, -0.3, 0.5),  # negative focus: truncation toward zero
    (4, 4, 20, 28, 0.1, 3.0),  # shifts far beyond the frame
]


@pytest.mark.parametrize("method", ["STD", "TEN"])
@pytest.mark.parametrize("case", ALLFOCUS_CASES, ids=str)
def test_allfocus_select_matches_oracle(rng, case, method):
    """The per-pixel gather select + blend vs the oracle, on TEN's raw map
    (the estimator's levels) and on STD's filtered map (any of 256 bytes),
    both compiled: maps that feed truncated coordinates must decode and
    shift exactly like the oracle's two-rounding f32 expression."""
    from lfinterpolator_tpu.ops import focus as focus_ops

    cols, rows, h, w, focus, frange = case
    images, wm, offsets = _setup(rng, cols=cols, rows=rows, h=h, w=w, v=6)
    fmap = _estimator_map(rng, h, w, focus, frange, 32)
    if method == "STD":
        fmap = np.asarray(focus_ops.filter_focus_map(jnp.asarray(fmap), (2, 2)))
    want = oracle.blend_allfocus(images, wm, offsets, fmap, focus, frange)
    got = jax.jit(blend_xla.render_allfocus, static_argnames="method")(
        blend_xla.to_planar(jnp.asarray(images)),
        jnp.asarray(wm.astype(np.float32)), jnp.asarray(offsets),
        jnp.asarray(fmap), jnp.float32(focus), jnp.float32(frange),
        method=method,
    )
    got = np.asarray(blend_xla.from_planar(got))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_allfocus_selected_row_blocks_match_full(rng):
    """Row blocks of the select (memory-pressured renders and mesh shards)
    concatenate to exactly the full-frame select."""
    g, c, h, w = 9, 3, 52, 70
    images = jnp.asarray(rng.integers(0, 256, (g, c, h, w), dtype=np.uint8))
    offsets = jnp.asarray(rng.uniform(-60, 60, (g, 2)).astype(np.float32))
    fmap = rng.integers(0, 256, (h, w), dtype=np.uint8)
    f, fr = jnp.float32(0.1), jnp.float32(0.3)
    sel = jax.jit(blend_xla.allfocus_selected, static_argnames="row_count")
    full = np.asarray(sel(images, offsets, jnp.asarray(fmap), f, fr))
    for rb in (16, 20):
        blocks = [
            np.asarray(sel(images, offsets, jnp.asarray(fmap[r0 : r0 + rb]),
                           f, fr, row_start=r0, row_count=min(rb, h - r0)))
            for r0 in range(0, h, rb)
        ]
        np.testing.assert_array_equal(np.concatenate(blocks, axis=2), full)


def test_no_fma_keeps_products_rounded_under_jit():
    """Compiled `c + a*b` chains must round the product like the oracle:
    XLA fuses the multiply into the add's loop, where LLVM would contract
    it into an FMA unless no_fma separates them."""
    q = np.arange(256, dtype=np.float32)
    off = np.linspace(-700.5, 700.3, 64, dtype=np.float32)
    fv_ref = np.float32(0.1) + (q / np.float32(255)) * np.float32(0.3)
    want = np.trunc(
        np.arange(96, dtype=np.float32)[None, None, :]
        + fv_ref[None, :, None] * off[:, None, None]
    )

    @jax.jit
    def coords(m, off):
        fv = blend_xla.focus_values_from_map(m, jnp.float32(0.1),
                                             jnp.float32(0.3))
        xx = jnp.arange(96, dtype=jnp.float32)
        return fv, jnp.trunc(xx[None, None, :] + blend_xla.no_fma(
            fv[None, :, None] * off[:, None, None]))

    fv, got = coords(jnp.arange(256, dtype=jnp.uint8), jnp.asarray(off))
    np.testing.assert_array_equal(np.asarray(fv), fv_ref)
    np.testing.assert_array_equal(np.asarray(got), want)
