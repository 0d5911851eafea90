"""End-to-end test of the scene regression harness (focusMapCompare parity)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from lfinterpolator_tpu.io import codec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


@pytest.mark.full
def test_focus_map_compare_harness(tmp_path, rng):
    # Two of the canonical scenes, tiny synthetic 6x6 grids (the harness's
    # focus search needs >=32 images by default; it runs with defaults, so
    # give it 36).
    root = tmp_path / "inputs"
    for scene in ("cornell", "bonfire"):
        d = root / scene
        d.mkdir(parents=True)
        tex = rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)
        for c in range(6):
            for r in range(6):
                img = np.zeros((64, 80, 4), np.uint8)
                img[:, :, :3] = tex[r * 2 : r * 2 + 64, c * 2 : c * 2 + 80]
                img[:, :, 3] = 255
                codec.encode_png(str(d / f"{c}_{r}.png"), img)

    out = subprocess.run(
        [
            sys.executable, f"{REPO}/scripts/focus_map_compare.py",
            "--input-root", str(root),
            "--out", str(tmp_path / "comparison"),
            "--scenes", "cornell,bonfire",
        ],
        capture_output=True, text=True, env=ENV, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    for scene in ("cornell", "bonfire"):
        common = tmp_path / "comparison" / f"{scene}C" / "0.png"
        single = tmp_path / "comparison" / scene / "0.png"
        assert common.exists() and single.exists()
        a = codec.decode(str(common))
        b = codec.decode(str(single))
        assert a.shape == b.shape == (64, 80, 4)


@pytest.mark.full
def test_render_video_script(tmp_path, rng):
    root = tmp_path / "video"
    for f in range(3):
        d = root / f"frame{f:03d}"
        d.mkdir(parents=True)
        for c in range(2):
            for r in range(2):
                img = rng.integers(0, 256, (12, 16, 4), dtype=np.uint8)
                codec.encode_png(str(d / f"{c}_{r}.png"), img)
    out = tmp_path / "rendered"
    res = subprocess.run(
        [sys.executable, f"{REPO}/scripts/render_video.py",
         "-i", str(root), "-o", str(out), "-t", "0,0,1,1", "-m", "STD"],
        capture_output=True, text=True, env=ENV, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert sorted(os.listdir(out)) == ["frame_00000", "frame_00001", "frame_00002"]
    assert len(os.listdir(out / "frame_00001")) == 64
    # resume: a second run renders nothing new but succeeds
    res2 = subprocess.run(
        [sys.executable, f"{REPO}/scripts/render_video.py",
         "-i", str(root), "-o", str(out), "-t", "0,0,1,1", "-m", "STD",
         "--resume"],
        capture_output=True, text=True, env=ENV, timeout=600,
    )
    assert res2.returncode == 0 and "3 frames" in res2.stdout


def test_occlusion_scene_properties(rng):
    """The parallax-occlusion scene (utils/scenes.py) must actually occlude:
    identical seeds reproduce it, corner cameras disagree (parallax), and a
    known-background pixel is covered by a foreground occluder in SOME
    camera but not all (visibility changes across the grid -- the property
    the band scenes lack)."""
    from lfinterpolator_tpu.utils.scenes import make_occlusion_scene

    cols = rows = 4
    h, w = 64, 96
    a = make_occlusion_scene(cols, rows, h, w, seed=3)
    b = make_occlusion_scene(cols, rows, h, w, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (16, h, w, 4) and a.dtype == np.uint8
    assert (a[..., 3] == 255).all()
    # parallax: corner cameras must differ over most of the frame
    d = np.abs(a[0, :, :, :3].astype(int) - a[15, :, :, :3].astype(int))
    assert (d.max(axis=2) > 0).mean() > 0.5
    # occlusion: some pixel equals the background texture in one camera but
    # is covered (differs from every other camera's value there) in another.
    # Proxy: the per-pixel count of distinct values across cameras exceeds
    # what pure per-camera background shift produces for >1% of pixels near
    # occluder borders -- measured via the scene's own foreground masks by
    # rebuilding with zero foreground layers.
    bg_only = make_occlusion_scene(
        cols, rows, h, w, seed=3, n_occluders=(0, 0)
    )
    fg = (a[..., :3] != bg_only[..., :3]).any(axis=3)  # [G, h, w]
    cover_count = fg.sum(axis=0)
    partial = (cover_count > 0) & (cover_count < 16)
    assert partial.mean() > 0.01, "no partially-occluded pixels = no parallax occlusion"


@pytest.mark.full
def test_occlusion_scene_pipeline_parity(rng):
    """Exact estimate + both blends on the occlusion scene match the CPU
    oracle bit-for-bit (content must not affect parity)."""
    import jax.numpy as jnp
    from lfinterpolator_tpu.core import geometry
    from lfinterpolator_tpu.models import pipeline
    from lfinterpolator_tpu.ops import blend_xla, reference as oracle
    from lfinterpolator_tpu.ops import focus as focus_ops
    from lfinterpolator_tpu.utils.scenes import (
        make_occlusion_scene, occlusion_foci,
    )

    cols = rows = 4
    h, w, v, steps = 48, 64, 4, 8
    focus, frange = 0.1, 0.3
    images = make_occlusion_scene(
        cols, rows, h, w,
        plane_foci=occlusion_foci(focus, frange, steps), seed=5,
    )
    se = np.array([0, 0, cols - 1.0, rows - 1.0], np.float32)
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    ).astype(np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    ids = geometry.select_focus_views(se, cols, rows, 8)
    radius = geometry.block_radius(w, h)
    frad = (max(radius[0] // 10, 1), max(radius[1] // 10, 1))
    pad = focus_ops.shift_pad_bound(offsets, focus, frange, radius, h, w)

    map0 = oracle.focus_map_estimate(
        images, offsets, ids, focus, frange, radius, steps=steps
    )
    map1 = oracle.focus_map_filter(map0, frad)
    planar = blend_xla.to_planar(jnp.asarray(images))
    for method, fmap in (("STD", map1), ("TEN", map0)):
        views, maps = pipeline.render_all_focus(
            planar, jnp.asarray(wm), jnp.asarray(offsets),
            jnp.float32(focus), jnp.float32(frange), jnp.asarray(ids),
            method=method, radius=radius, filter_radius=frad, steps=steps,
            pad=pad,
        )
        np.testing.assert_array_equal(np.asarray(maps[0]), map0)
        want = oracle.blend_allfocus(
            images, wm, offsets, fmap, focus, frange
        )
        np.testing.assert_array_equal(
            np.asarray(blend_xla.from_planar(views)), want, err_msg=method
        )
