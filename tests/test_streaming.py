"""Streaming pipeline tests (CPU, small frames)."""

import os

import pytest

import numpy as np

from lfinterpolator_tpu.core.config import RenderConfig
from lfinterpolator_tpu.streaming import StreamingRenderer
from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.ops import reference as oracle


def _frames(rng, n, g, h, w):
    return [
        rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8) for _ in range(n)
    ]


def test_stream_matches_per_frame_oracle(rng):
    cols = rows = 2
    h, w, v = 16, 32, 4
    frames = _frames(rng, 3, cols * rows, h, w)
    sr = StreamingRenderer(
        cols, rows, w, h, "0.0,0.0,1.0,1.0",
        config=RenderConfig(view_count=v, focus=0.4),
    )
    outs = list(sr.render_stream(iter(frames)))
    assert len(outs) == 3

    se = geometry.parse_trajectory("0.0,0.0,1.0,1.0", (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    )
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    fo = geometry.focused_offsets(offsets, 0.4)
    for frame, got in zip(frames, outs):
        want = oracle.blend_fixed(frame, wm, fo)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_stream_ten_matches_oracle(rng):
    """The TEN (fp16 tensor-core) stream stays within 1 LSB of the oracle."""
    cols = rows = 2
    h, w, v = 32, 256, 4
    frames = _frames(rng, 2, cols * rows, h, w)
    sr = StreamingRenderer(
        cols, rows, w, h, "0.0,0.0,1.0,1.0",
        config=RenderConfig(view_count=v, focus=0.4, method="TEN"),
    )
    outs = list(sr.render_stream(iter(frames)))

    se = geometry.parse_trajectory("0.0,0.0,1.0,1.0", (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    )
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    fo = geometry.focused_offsets(offsets, 0.4)
    for frame, got in zip(frames, outs):
        want = oracle.blend_fixed(frame, wm, fo)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_stream_empty():
    sr = StreamingRenderer(2, 2, 16, 16, "0,0,1,1", config=RenderConfig(view_count=2))
    assert list(sr.render_stream(iter([]))) == []


def test_render_to_dir(tmp_path, rng):
    cols = rows = 2
    frames = _frames(rng, 2, 4, 12, 16)
    sr = StreamingRenderer(
        cols, rows, 16, 12, "0,0,1,1", config=RenderConfig(view_count=2)
    )
    stats = sr.render_to_dir(iter(frames), str(tmp_path / "stream"))
    assert stats.frames == 2
    assert stats.fps > 0
    for i in range(2):
        files = os.listdir(tmp_path / "stream" / f"frame_{i:05d}")
        assert len(files) == 2


def test_stream_propagates_decode_errors(rng):
    from lfinterpolator_tpu.streaming import StreamingRenderer
    from lfinterpolator_tpu.core.config import RenderConfig

    def frames():
        yield rng.integers(0, 256, size=(4, 8, 16, 4), dtype=np.uint8)
        raise RuntimeError("corrupt frame 2")

    sr = StreamingRenderer(2, 2, 16, 8, "0,0,1,1", config=RenderConfig(view_count=2))
    with pytest.raises(RuntimeError, match="corrupt frame 2"):
        list(sr.render_stream(frames()))


def test_render_to_dir_resume_skips_complete_frames(tmp_path, rng):
    frames = [
        rng.integers(0, 256, size=(4, 12, 16, 4), dtype=np.uint8)
        for _ in range(3)
    ]
    sr = StreamingRenderer(
        2, 2, 16, 12, "0,0,1,1", config=RenderConfig(view_count=2)
    )
    out = str(tmp_path / "resume")
    stats1 = sr.render_to_dir(iter(frames[:2]), out)
    assert stats1.frames == 2
    # restart with all 3 frames: the first two are complete and skipped,
    # but indices still line up (frame 2 renders into frame_00002)
    stats2 = sr.render_to_dir(iter(frames), out, resume=True)
    assert stats2.frames == 3
    assert sorted(os.listdir(out)) == ["frame_00000", "frame_00001", "frame_00002"]
    assert len(os.listdir(tmp_path / "resume" / "frame_00002")) == 2


def test_render_to_dir_resume_ignores_stray_pngs(tmp_path, rng):
    """A frame dir holding only stray PNGs (a quilt, leftovers from a larger
    view count) must NOT be treated as complete: the check looks for the
    exact filenames write_views produces."""
    frames = [
        rng.integers(0, 256, size=(4, 12, 16, 4), dtype=np.uint8)
        for _ in range(2)
    ]
    sr = StreamingRenderer(
        2, 2, 16, 12, "0,0,1,1", config=RenderConfig(view_count=2)
    )
    out = str(tmp_path / "stray")
    d = tmp_path / "stray" / "frame_00000"
    d.mkdir(parents=True)
    # two stray PNGs: same count as view_count, wrong names
    (d / "quilt.png").write_bytes(b"junk")
    (d / "05.png").write_bytes(b"junk")
    stats = sr.render_to_dir(iter(frames), out, resume=True)
    assert stats.skipped == 0
    assert (d / "00.png").exists() and (d / "01.png").exists()


def test_stream_allfocus_matches_pipeline(rng):
    """focus_range > 0 streams per-frame all-focus (views, maps) matching
    the non-streaming pipeline (no silent fixed-focus downgrade)."""
    import jax.numpy as jnp

    from lfinterpolator_tpu.models import pipeline
    from lfinterpolator_tpu.ops import blend_xla
    from lfinterpolator_tpu.ops import focus as focus_ops

    cols = rows = 2
    h, w, v = 16, 32, 4
    cfg = RenderConfig(
        view_count=v, focus=0.1, focus_range=0.4,
        focus_map_views=4, focus_steps=8,
    )
    frames = _frames(rng, 2, cols * rows, h, w)
    sr = StreamingRenderer(cols, rows, w, h, "0.0,0.0,1.0,1.0", config=cfg)
    assert sr._uses_focus_map
    outs = list(sr.render_stream(iter(frames)))
    assert len(outs) == 2

    se = geometry.parse_trajectory("0.0,0.0,1.0,1.0", (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    ).astype(np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    radius = geometry.block_radius(w, h, cfg.pixel_size_factor)
    frad = (
        radius[0] // cfg.filter_radius_divisor,
        radius[1] // cfg.filter_radius_divisor,
    )
    ids = jnp.asarray(
        geometry.select_focus_views(se, cols, rows, cfg.focus_map_views)
    )
    pad = focus_ops.shift_pad_bound(
        offsets, cfg.focus, cfg.focus_range, radius, h, w
    )
    for frame, (views, maps) in zip(frames, outs):
        planar = blend_xla.to_planar(jnp.asarray(frame))
        want_views, want_maps = pipeline.render_all_focus(
            planar, jnp.asarray(wm), jnp.asarray(offsets),
            jnp.float32(cfg.focus), jnp.float32(cfg.focus_range), ids,
            method="STD", radius=radius, filter_radius=frad,
            steps=cfg.focus_steps, pad=pad,
        )
        np.testing.assert_array_equal(maps, np.asarray(want_maps))
        np.testing.assert_array_equal(
            views, np.asarray(blend_xla.from_planar(want_views))
        )


@pytest.mark.full
def test_stream_allfocus_ten_kernel(rng):
    """The TEN all-focus stream matches the non-streaming TEN pipeline."""
    import jax.numpy as jnp

    from lfinterpolator_tpu.models import pipeline
    from lfinterpolator_tpu.ops import blend_xla
    from lfinterpolator_tpu.ops import focus as focus_ops

    cols = rows = 2
    h, w, v = 32, 256, 4
    cfg = RenderConfig(
        view_count=v, focus=0.1, focus_range=0.4, method="TEN",
        focus_map_views=4, focus_steps=8,
    )
    frames = _frames(rng, 1, cols * rows, h, w)
    sr = StreamingRenderer(cols, rows, w, h, "0.0,0.0,1.0,1.0", config=cfg)
    ((views, maps),) = list(sr.render_stream(iter(frames)))

    se = geometry.parse_trajectory("0.0,0.0,1.0,1.0", (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    ).astype(np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    radius = geometry.block_radius(w, h, cfg.pixel_size_factor)
    frad = (
        radius[0] // cfg.filter_radius_divisor,
        radius[1] // cfg.filter_radius_divisor,
    )
    ids = jnp.asarray(
        geometry.select_focus_views(se, cols, rows, cfg.focus_map_views)
    )
    pad = focus_ops.shift_pad_bound(
        offsets, cfg.focus, cfg.focus_range, radius, h, w
    )
    planar = blend_xla.to_planar(jnp.asarray(frames[0]))
    want_views, want_maps = pipeline.render_all_focus(
        planar, jnp.asarray(wm), jnp.asarray(offsets),
        jnp.float32(cfg.focus), jnp.float32(cfg.focus_range), ids,
        method="TEN", radius=radius, filter_radius=frad,
        steps=cfg.focus_steps, pad=pad,
    )
    np.testing.assert_array_equal(maps, np.asarray(want_maps))
    np.testing.assert_array_equal(
        views, np.asarray(blend_xla.from_planar(want_views))
    )


def test_render_to_dir_allfocus_writes_maps(tmp_path, rng):
    frames = _frames(rng, 2, 4, 16, 32)
    sr = StreamingRenderer(
        2, 2, 32, 16, "0,0,1,1",
        config=RenderConfig(
            view_count=2, focus=0.0, focus_range=0.4,
            focus_map_views=4, focus_steps=4,
        ),
    )
    out = str(tmp_path / "af_stream")
    stats = sr.render_to_dir(iter(frames), out)
    assert stats.frames == 2
    for i in range(2):
        files = sorted(os.listdir(tmp_path / "af_stream" / f"frame_{i:05d}"))
        assert files == ["00.png", "01.png", "map0.png", "map1.png"]
    # resume treats map files as part of frame completeness
    stats2 = sr.render_to_dir(iter(frames), out, resume=True)
    assert stats2.skipped == 2


def test_stream_allfocus_map_refresh(rng):
    """--map-refresh N: maps re-estimated every N frames and reused in
    between -- frame t's maps equal compute_focus_maps of frame (t//N)*N,
    views equal blend_all_focus of frame t's images with those maps; the
    anchor frames are bit-identical to the refresh=1 stream."""
    import jax.numpy as jnp

    from lfinterpolator_tpu.models import pipeline
    from lfinterpolator_tpu.ops import blend_xla
    from lfinterpolator_tpu.ops import focus as focus_ops

    cols = rows = 2
    h, w, v, n = 16, 32, 4, 5
    cfg = RenderConfig(
        view_count=v, focus=0.1, focus_range=0.4,
        focus_map_views=4, focus_steps=8, focus_map_refresh=2,
    )
    frames = _frames(rng, n, cols * rows, h, w)
    sr = StreamingRenderer(cols, rows, w, h, "0.0,0.0,1.0,1.0", config=cfg)
    outs = list(sr.render_stream(iter(frames)))
    assert len(outs) == n

    se = geometry.parse_trajectory("0.0,0.0,1.0,1.0", (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    ).astype(np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    radius = geometry.block_radius(w, h, cfg.pixel_size_factor)
    frad = (
        radius[0] // cfg.filter_radius_divisor,
        radius[1] // cfg.filter_radius_divisor,
    )
    ids = jnp.asarray(
        geometry.select_focus_views(se, cols, rows, cfg.focus_map_views)
    )
    pad = focus_ops.shift_pad_bound(
        offsets, cfg.focus, cfg.focus_range, radius, h, w
    )
    offj = jnp.asarray(offsets)
    anchors = {}
    for t in range(n):
        a = (t // cfg.focus_map_refresh) * cfg.focus_map_refresh
        if a not in anchors:
            anchors[a] = pipeline.compute_focus_maps(
                blend_xla.to_planar(jnp.asarray(frames[a])), offj,
                jnp.float32(cfg.focus), jnp.float32(cfg.focus_range), ids,
                radius=radius, filter_radius=frad, steps=cfg.focus_steps,
                pad=pad,
            )
        views, maps = outs[t]
        np.testing.assert_array_equal(maps, np.asarray(anchors[a]))
        want = pipeline.blend_all_focus(
            blend_xla.to_planar(jnp.asarray(frames[t])), jnp.asarray(wm),
            offj, anchors[a], jnp.float32(cfg.focus),
            jnp.float32(cfg.focus_range), method="STD",
        )
        np.testing.assert_array_equal(
            views, np.asarray(blend_xla.from_planar(want))
        )
    # distinct anchor maps (otherwise the reuse assertion is vacuous)
    assert not np.array_equal(np.asarray(anchors[0]), np.asarray(anchors[2]))
    assert not np.array_equal(outs[1][1], outs[2][1])
