"""Randomized end-to-end configurations vs the oracle.

Each case draws a random (grid, resolution, views, focus, effect, aspect,
method) configuration and checks the full pipeline against the bit-faithful
oracle. Catches interactions the targeted tests miss (odd sizes, rectangular
grids, negative focus, extreme aspect).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.models import pipeline
from lfinterpolator_tpu.ops import blend_xla, focus as focus_ops
from lfinterpolator_tpu.ops import reference as oracle

CASES = list(range(10))


def _random_cfg(seed):
    r = np.random.default_rng(seed)
    cols = int(r.integers(2, 6))
    rows = int(r.integers(2, 6))
    h = int(r.integers(12, 49))
    w = int(r.integers(16, 65))
    v = int(r.choice([1, 3, 8, 16]))
    focus = float(r.uniform(-0.8, 0.8))
    effect = float(r.choice([1.0, 3.0, 7.0]))
    aspect = float(r.choice([0.5, 1.0, 1.783, 2.276]))
    traj = r.uniform(0, 1, 4)
    return cols, rows, h, w, v, focus, effect, aspect, traj


@pytest.mark.parametrize("seed", CASES)
def test_fixed_focus_random_config(seed, rng):
    cols, rows, h, w, v, focus, effect, aspect, traj = _random_cfg(seed)
    g = cols * rows
    images = rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8)
    se = geometry.parse_trajectory(",".join(str(x) for x in traj), (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, effect, v)
    )
    offsets = geometry.compute_offsets(
        cols, rows, w, h, aspect, geometry.trajectory_center(se)
    )
    fo = geometry.focused_offsets(offsets, focus)
    want = oracle.blend_fixed(images, wm, fo)
    got = np.asarray(
        blend_xla.from_planar(
            pipeline.render_fixed_focus(
                blend_xla.to_planar(jnp.asarray(images)),
                jnp.asarray(wm.astype(np.float32)),
                jnp.asarray(fo),
                method="STD",
            )
        )
    )
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"seed={seed} cfg={(cols, rows, h, w, v, focus)}"


@pytest.mark.parametrize(
    "seed",
    [CASES[0]] + [pytest.param(s, marks=pytest.mark.full) for s in CASES[1:5]],
)
@pytest.mark.full
def test_all_focus_random_config(seed, rng):
    cols, rows, h, w, v, focus, effect, aspect, traj = _random_cfg(seed + 100)
    focus_range = abs(focus) + 0.1
    g = cols * rows
    k = min(8, g)
    steps = 8
    images = rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8)
    se = geometry.parse_trajectory(",".join(str(x) for x in traj), (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, effect, v)
    )
    offsets = geometry.compute_offsets(
        cols, rows, w, h, aspect, geometry.trajectory_center(se)
    )
    ids = geometry.select_focus_views(se, cols, rows, k)
    radius = geometry.block_radius(w, h)
    frad = (radius[0] // 10, radius[1] // 10)
    pad = focus_ops.shift_pad_bound(offsets, focus, focus_range, radius, h, w)

    # oracle: estimate -> filter -> both blends
    map0 = oracle.focus_map_estimate(
        images, offsets, ids, focus, focus_range, radius, steps=steps
    )
    map1 = oracle.focus_map_filter(map0, frad)

    planar = blend_xla.to_planar(jnp.asarray(images))
    for method, want_map in (("STD", map1), ("TEN", map0)):
        views, maps = pipeline.render_all_focus(
            planar,
            jnp.asarray(wm.astype(np.float32)),
            jnp.asarray(offsets),
            jnp.float32(focus),
            jnp.float32(focus_range),
            jnp.asarray(ids),
            method=method,
            radius=radius,
            filter_radius=frad,
            steps=steps,
            pad=pad,
        )
        np.testing.assert_array_equal(
            np.asarray(maps[0]), map0, err_msg=f"seed={seed} map0"
        )
        np.testing.assert_array_equal(
            np.asarray(maps[1]), map1, err_msg=f"seed={seed} map1"
        )
        want = oracle.blend_allfocus(
            images, wm, offsets, want_map, focus, focus_range
        )
        got = np.asarray(blend_xla.from_planar(views))
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, (
            f"seed={seed} method={method} cfg={(cols, rows, h, w, v, focus)}"
        )


@pytest.mark.parametrize("seed", CASES[:6])
def test_ten_blend_random_config(seed, rng):
    """Fuzz the TEN blend (fp16 operands, f32 accumulation) across random
    configs: within 1 LSB of the oracle."""
    cols, rows, h, w, v, focus, effect, aspect, traj = _random_cfg(seed + 500)
    v = max(2, v)
    g = cols * rows
    images = rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8)
    se = geometry.parse_trajectory(",".join(str(x) for x in traj), (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, effect, v)
    )
    offsets = geometry.compute_offsets(
        cols, rows, w, h, aspect, geometry.trajectory_center(se)
    )
    fo = geometry.focused_offsets(offsets, focus)
    want = oracle.blend_fixed(images, wm, fo)
    got = np.asarray(
        blend_xla.from_planar(
            pipeline.render_fixed_focus(
                blend_xla.to_planar(jnp.asarray(images)),
                jnp.asarray(wm.astype(np.float32)),
                jnp.asarray(fo),
                method="TEN",
            )
        )
    )
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"seed={seed} cfg={(cols, rows, h, w, v, focus)}"


@pytest.mark.parametrize("seed", CASES[:6])
def test_allfocus_select_random_config(seed, rng):
    """The compiled per-pixel gather select + blend vs the oracle on random
    geometries, shift amplitudes and arbitrary-byte maps."""
    import jax

    r = np.random.default_rng(seed + 500)
    g = int(r.integers(2, 7))
    h = int(r.integers(17, 90))
    w = int(r.integers(20, 130))
    v = int(r.choice([1, 4, 8]))
    focus = float(r.uniform(-0.4, 0.4))
    frange = float(r.uniform(0.05, 0.6))
    oamp = float(r.uniform(5.0, 120.0))
    method = ("STD", "TEN")[seed % 2]
    images = rng.integers(0, 256, (g, h, w, 4), dtype=np.uint8)
    wm = (np.abs(rng.normal(size=(v, g))) / g).astype(np.float16)
    offsets = rng.uniform(-oamp, oamp, (g, 2)).astype(np.float32)
    fmap = rng.integers(0, 256, (h, w), dtype=np.uint8)
    want = oracle.blend_allfocus(images, wm, offsets, fmap, focus, frange)
    got = jax.jit(blend_xla.render_allfocus, static_argnames="method")(
        blend_xla.to_planar(jnp.asarray(images)),
        jnp.asarray(wm.astype(np.float32)), jnp.asarray(offsets),
        jnp.asarray(fmap), jnp.float32(focus), jnp.float32(frange),
        method=method,
    )
    got = np.asarray(blend_xla.from_planar(got))
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"seed={seed} cfg={(g, h, w, v, focus, frange)}"


@pytest.mark.parametrize(
    "seed",
    [CASES[0]] + [pytest.param(s, marks=pytest.mark.full) for s in CASES[1:4]],
)
@pytest.mark.full
def test_estimate_kernels_random_config(seed, rng):
    """The Triton estimate kernel (interpret mode), both tap rules, equals
    the XLA sweep bit for bit on random geometries."""
    from lfinterpolator_tpu.ops import estimate_triton

    r = np.random.default_rng(1000 + seed)
    cols = rows = 4
    h = int(r.integers(9, 40))
    w = int(r.integers(20, 110))
    K = int(r.choice([4, 7, 8]))
    steps = int(r.choice([4, 8, 12]))
    focus = float(r.uniform(-0.4, 0.4))
    frange = float(r.uniform(0.2, 0.6))
    radius = (int(r.integers(2, 8)), int(r.integers(2, 6)))
    se = np.array([0, 0, cols - 1.0, rows - 1.0], np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, float(r.choice([1.0, 1.783])),
        geometry.trajectory_center(se),
    )
    ids = np.asarray(geometry.select_focus_views(se, cols, rows, K))
    pad = focus_ops.shift_pad_bound(offsets, focus, frange, radius, h, w)
    sel_img = jnp.asarray(rng.integers(0, 256, (K, 3, h, w), dtype=np.uint8))
    sel_off = jnp.asarray(offsets)[jnp.asarray(ids)]
    for exact in (True, False):
        n = estimate_triton.mismatches(
            sel_img, sel_off, focus, frange, radius, steps=steps, pad=pad,
            exact=exact, interpret=True,
        )
        assert n == 0, (
            f"seed={seed} exact={exact} "
            f"cfg={(h, w, K, steps, focus, frange, radius)}"
        )
