"""End-to-end tests: loader -> Interpolator -> writer -> CLI."""

import os

import numpy as np
import pytest

from lfinterpolator_tpu import cli
from lfinterpolator_tpu.api import Interpolator, interpolate
from lfinterpolator_tpu.core.config import RenderConfig
from lfinterpolator_tpu.io import codec, loader
from lfinterpolator_tpu.ops import reference as oracle
from lfinterpolator_tpu.core import geometry


@pytest.fixture
def scene_dir(tmp_path, small_lf):
    images, (cols, rows) = small_lf
    d = tmp_path / "scene"
    d.mkdir()
    for c in range(cols):
        for r in range(rows):
            codec.encode_png(str(d / f"{c:02d}_{r:02d}.png"), images[c * rows + r])
    return str(d), images, (cols, rows)


def test_loader_roundtrip(scene_dir):
    d, images, (cols, rows) = scene_dir
    lf = loader.load_light_field(d, progress=False)
    assert (lf.cols, lf.rows) == (cols, rows)
    np.testing.assert_array_equal(lf.images, images)


def test_loader_reference_order_transposes_placement(scene_dir):
    """reference_order=True reproduces the reference binary's transposed grid
    (src/lfLoader.cpp:64): image a_b.png lands at (col=b, row=a)."""
    d, images, (cols, rows) = scene_dir
    lf = loader.load_light_field(d, progress=False, reference_order=True)
    assert (lf.cols, lf.rows) == (rows, cols)
    for c in range(cols):
        for r in range(rows):
            np.testing.assert_array_equal(
                lf.image(r, c), images[c * rows + r]
            )


def test_loader_missing_dir():
    with pytest.raises(FileNotFoundError):
        loader.load_light_field("/nonexistent/path", progress=False)


def test_loader_no_grid_files(tmp_path):
    d = tmp_path / "bad"
    d.mkdir()
    (d / "notagrid.png").write_bytes(b"x")
    with pytest.raises(ValueError, match="No grid images found"):
        loader.load_light_field(str(d), progress=False)


def test_loader_skips_stray_files(tmp_path, rng):
    d = tmp_path / "stray"
    d.mkdir()
    img = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    for c in range(2):
        for r in range(2):
            codec.encode_png(str(d / f"{c}_{r}.png"), img)
    (d / ".DS_Store").write_bytes(b"junk")
    (d / "quilt.png").write_bytes(b"junk")
    lf = loader.load_light_field(str(d), progress=False)
    assert (lf.cols, lf.rows) == (2, 2)


def test_loader_empty_dir(tmp_path):
    d = tmp_path / "empty"
    d.mkdir()
    with pytest.raises(ValueError, match="empty"):
        loader.load_light_field(str(d), progress=False)


def test_loader_incomplete_grid(tmp_path, rng):
    d = tmp_path / "holes"
    d.mkdir()
    img = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    for name in ["00_00.png", "00_01.png", "01_00.png"]:  # missing 01_01
        codec.encode_png(str(d / name), img)
    with pytest.raises(ValueError, match="missing images"):
        loader.load_light_field(str(d), progress=False)


def test_interpolator_fixed_focus_matches_oracle(scene_dir):
    d, images, (cols, rows) = scene_dir
    interp = Interpolator(d, config=RenderConfig(view_count=8), progress=False)
    result = interp.interpolate("0.0,0.0,1.0,1.0", focus=0.25, progress=False)
    assert result.views.shape == (8, images.shape[1], images.shape[2], 3)
    assert result.maps is None

    se = geometry.parse_trajectory("0.0,0.0,1.0,1.0", (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, 8)
    )
    offsets = geometry.compute_offsets(
        cols, rows, images.shape[2], images.shape[1], 1.0,
        geometry.trajectory_center(se),
    )
    want = oracle.blend_fixed(images, wm, geometry.focused_offsets(offsets, 0.25))
    diff = np.abs(result.views.astype(int) - want.astype(int))
    assert diff.max() <= 1


def test_interpolator_allfocus_produces_maps(scene_dir):
    d, images, _ = scene_dir
    interp = Interpolator(
        d, config=RenderConfig(view_count=4, focus_map_views=8, focus_steps=8),
        progress=False,
    )
    result = interp.interpolate(
        "0.0,0.0,1.0,1.0", focus=0.0, focus_range=0.5, progress=False
    )
    assert result.maps is not None
    assert result.maps.shape == (2, images.shape[1], images.shape[2])


def test_interpolator_single_position_views_identical(scene_dir):
    # start == end -> all views identical (the reference renders 64 copies)
    d, _, _ = scene_dir
    interp = Interpolator(d, config=RenderConfig(view_count=4), progress=False)
    result = interp.interpolate("0.5,0.5,0.5,0.5", progress=False)
    for v in range(1, 4):
        np.testing.assert_array_equal(result.views[v], result.views[0])


def test_interpolator_rejects_unknown_method(scene_dir):
    d, _, _ = scene_dir
    interp = Interpolator(d, progress=False)
    with pytest.raises(ValueError, match="does not exist"):
        interp.interpolate("0,0,1,1", method="WHAT", progress=False)


def test_one_shot_interpolate_writes_outputs(scene_dir, tmp_path):
    d, _, _ = scene_dir
    out = str(tmp_path / "out")
    res = interpolate(d, out, "0.0,0.0,1.0,1.0", progress=False)
    files = sorted(os.listdir(out))
    assert len(files) == res.views.shape[0]
    assert files[0] == "00.png"
    back = codec.decode(os.path.join(out, "00.png"))
    np.testing.assert_array_equal(back[:, :, :3], res.views[0])
    assert (back[:, :, 3] == 255).all()


def test_cli_help():
    assert cli.main(["-h"]) == 0


def test_cli_missing_required(capsys):
    assert cli.main(["-i", "/tmp"]) == 1
    assert "Missing required parameters" in capsys.readouterr().err


def test_cli_end_to_end(scene_dir, tmp_path, capsys):
    d, _, _ = scene_dir
    out = str(tmp_path / "cli_out")
    rc = cli.main(
        ["-i", d, "-o", out, "-t", "0.0,0.0,1.0,1.0", "-m", "STD",
         "-f", "0.2", "--json", "--no-progress"]
    )
    assert rc == 0
    assert "00.png" in os.listdir(out)
    assert '"views": 64' in capsys.readouterr().out


def test_cli_bad_input_path(tmp_path, capsys):
    rc = cli.main(
        ["-i", "/nonexistent", "-o", str(tmp_path), "-t", "0,0,1,1", "-m", "STD"]
    )
    assert rc == 1


def test_cli_validates_before_loading(tmp_path, capsys):
    """A typo'd -m or -t must fail fast, BEFORE the grid load / device
    upload: with a nonexistent input dir the reported error must be the
    method/trajectory one, proving validation ran first."""
    rc = cli.main(
        ["-i", "/nonexistent", "-o", str(tmp_path), "-t", "0,0,1,1",
         "-m", "WHAT"]
    )
    assert rc == 1
    # match the method-specific text: the loader's missing-dir error also
    # says "does not exist", which would mask an ordering regression
    assert "interpolation method" in capsys.readouterr().err
    rc = cli.main(
        ["-i", "/nonexistent", "-o", str(tmp_path), "-t", "0,0,1",
         "-m", "STD"]
    )
    assert rc == 1
    assert "4 comma-separated values" in capsys.readouterr().err


def test_interpolate_batch_matches_individual(scene_dir):
    d, _, _ = scene_dir
    interp = Interpolator(d, config=RenderConfig(view_count=4), progress=False)
    trajs = ["0.0,0.0,1.0,1.0", "0.2,0.2,0.8,0.8", "0.5,0.5,0.5,0.5"]
    batch = interp.interpolate_batch(trajs, focus=0.3, progress=False)
    assert len(batch) == 3
    # All three share the grid center, so every entry is exact vs its solo run.
    for t, res in zip(trajs, batch):
        solo = interp.interpolate(t, focus=0.3, progress=False)
        np.testing.assert_array_equal(res.views, solo.views, err_msg=t)


@pytest.mark.full
def test_interpolate_batch_allfocus_matches_individual(scene_dir, monkeypatch):
    """All-focus batch: same-center trajectories share one estimate + one
    per-pixel-focus select; every entry must equal its solo run byte for
    byte (incl. the shared maps), for both methods."""
    d, _, _ = scene_dir
    trajs = ["0.0,0.0,1.0,1.0", "0.2,0.2,0.8,0.8", "0.5,0.5,0.5,0.5"]
    for m in ("STD", "TEN"):
        interp = Interpolator(
            d, config=RenderConfig(method=m, view_count=4, focus_map_views=8),
            progress=False,
        )
        batch = interp.interpolate_batch(
            trajs, focus=0.1, focus_range=0.2, progress=False
        )
        for t, res in zip(trajs, batch):
            solo = interp.interpolate(
                t, focus=0.1, focus_range=0.2, progress=False
            )
            np.testing.assert_array_equal(res.maps, solo.maps, err_msg=t)
            np.testing.assert_array_equal(res.views, solo.views, err_msg=t)


def test_interpolate_batch_mixed_centers_matches_individual(scene_dir):
    """Trajectories with differing centers are grouped and still exact."""
    d, _, _ = scene_dir
    interp = Interpolator(d, config=RenderConfig(view_count=4), progress=False)
    # centers: (0.5,0.5), (0.25,0.25), (0.5,0.5) -- two groups, caller order
    trajs = ["0.0,0.0,1.0,1.0", "0.0,0.0,0.5,0.5", "0.2,0.2,0.8,0.8"]
    batch = interp.interpolate_batch(trajs, focus=0.3, progress=False)
    assert len(batch) == 3
    for t, res in zip(trajs, batch):
        solo = interp.interpolate(t, focus=0.3, progress=False)
        np.testing.assert_array_equal(res.views, solo.views, err_msg=t)


@pytest.mark.full
def test_interpolate_batch_allfocus_mixed_centers(scene_dir, monkeypatch):
    """All-focus batch across TWO center groups: each group gets its own
    estimate/maps; every entry (views AND maps) equals its solo run."""
    d, _, _ = scene_dir
    interp = Interpolator(
        d, config=RenderConfig(view_count=4, focus_map_views=8),
        progress=False,
    )
    trajs = ["0.0,0.0,1.0,1.0", "0.0,0.0,0.5,0.5", "0.2,0.2,0.8,0.8"]
    batch = interp.interpolate_batch(
        trajs, focus=0.1, focus_range=0.2, progress=False
    )
    maps_seen = set()
    for t, res in zip(trajs, batch):
        solo = interp.interpolate(t, focus=0.1, focus_range=0.2, progress=False)
        np.testing.assert_array_equal(res.maps, solo.maps, err_msg=t)
        np.testing.assert_array_equal(res.views, solo.views, err_msg=t)
        maps_seen.add(res.maps.tobytes())
    assert len(maps_seen) == 2  # two centers -> two distinct map sets


@pytest.mark.full
def test_interpolate_batch_center_tolerance(scene_dir, monkeypatch):
    """center_tolerance merges near-equal centers into ONE group (shared
    maps, first member's center); tolerance 0 keeps exact per-center
    grouping. The far trajectory stays its own group either way."""
    d, _, _ = scene_dir
    interp = Interpolator(
        d, config=RenderConfig(view_count=4, focus_map_views=8),
        progress=False,
    )
    # centers: (1, 1), (1.002, 1.002) -- jitter 0.003 apart -- and (1.5, 1.5)
    trajs = ["0.0,0.0,1.0,1.0", "0.0,0.0,1.002,1.002", "0.5,0.5,1.0,1.0"]
    exact = interp.interpolate_batch(
        trajs, focus=0.1, focus_range=0.2, progress=False
    )
    assert len({r.maps.tobytes() for r in exact}) == 3

    merged = interp.interpolate_batch(
        trajs, focus=0.1, focus_range=0.2, center_tolerance=0.01,
        progress=False,
    )
    # jittered pair shares the FIRST member's maps; far center unmerged
    np.testing.assert_array_equal(merged[0].maps, merged[1].maps)
    np.testing.assert_array_equal(merged[0].maps, exact[0].maps)
    np.testing.assert_array_equal(merged[0].views, exact[0].views)
    assert merged[2].maps.tobytes() == exact[2].maps.tobytes()
    assert merged[1].maps.tobytes() != exact[1].maps.tobytes()

    # tolerance large enough to swallow everything -> one group
    one = interp.interpolate_batch(
        trajs, focus=0.1, focus_range=0.2, center_tolerance=2.0,
        progress=False,
    )
    assert len({r.maps.tobytes() for r in one}) == 1


def test_loader_single_image_grid(tmp_path, rng):
    """A 1x1 grid exercises the batch path's empty-remainder call."""
    d = tmp_path / "single"
    d.mkdir()
    img = rng.integers(0, 256, (16, 24, 4), dtype=np.uint8)
    img[:, :, 3] = 255
    codec.encode_png(str(d / "00_00.png"), img)
    lf = loader.load_light_field(str(d), progress=False)
    assert (lf.cols, lf.rows) == (1, 1)
    np.testing.assert_array_equal(lf.images[0], img)


def test_cli_quilt_reference_shape(scene_dir, tmp_path):
    """--quilt-reference requests the reference script's exact quilt
    geometry: 5x9 tiles resized to 1080x1920 (scripts/viewsToQuilt.sh:2).
    (The full-size assembly is exercised at small tile sizes below; here the
    save is spied to keep the test light.)"""
    from unittest import mock

    from lfinterpolator_tpu.api import RenderResult

    d, _, _ = scene_dir
    out = str(tmp_path / "cli_quilt")
    with mock.patch.object(
        RenderResult, "save_quilt", return_value="quilt.png"
    ) as spy:
        rc = cli.main(
            ["-i", d, "-o", out, "-t", "0.0,0.0,1.0,1.0", "-m", "STD",
             "--quilt-reference", "--no-progress"]
        )
    assert rc == 0
    assert spy.call_count == 1
    assert spy.call_args.kwargs["tile_size"] == (1080, 1920)


def test_cli_quilt_tile_flag(scene_dir, tmp_path, capsys):
    d, _, (cols, rows) = scene_dir
    out = str(tmp_path / "cli_quilt_tile")
    rc = cli.main(
        ["-i", d, "-o", out, "-t", "0.0,0.0,1.0,1.0", "-m", "STD",
         "--quilt-tile", "24x32", "--no-progress"]
    )
    assert rc == 0
    q = codec.decode(os.path.join(out, "quilt.png"))
    assert q.shape[:2] == (9 * 24, 5 * 32)
    rc = cli.main(
        ["-i", d, "-o", out, "-t", "0.0,0.0,1.0,1.0", "-m", "STD",
         "--quilt-tile", "junk", "--no-progress"]
    )
    assert rc == 1
    assert "quilt-tile" in capsys.readouterr().err


def test_cli_quilt_tile_rejected_before_render(scene_dir, tmp_path, capsys):
    """Bad --quilt-tile values (non-numeric, zero, negative) fail BEFORE
    the render: exit 1, clear message, and no output directory created."""
    d, _, _ = scene_dir
    for bad in ("junk", "0x32", "24x-32"):
        out = str(tmp_path / f"never_{bad}")
        rc = cli.main(
            ["-i", d, "-o", out, "-t", "0.0,0.0,1.0,1.0", "-m", "STD",
             "--quilt-tile", bad, "--no-progress"]
        )
        assert rc == 1, bad
        assert "quilt-tile" in capsys.readouterr().err
        assert not os.path.exists(out), bad


@pytest.fixture
def aligned_scene_dir(tmp_path, rng):
    """A 2x2 grid of 16x128 views."""
    cols, rows, h, w = 2, 2, 16, 128
    d = tmp_path / "aligned"
    d.mkdir()
    tex = rng.integers(0, 256, size=(h + 8, w + 8, 3), dtype=np.uint8)
    for c in range(cols):
        for r in range(rows):
            img = np.zeros((h, w, 4), np.uint8)
            img[:, :, 3] = 255
            img[:, :, :3] = tex[r * 2 : r * 2 + h, c * 2 : c * 2 + w]
            codec.encode_png(str(d / f"{c:02d}_{r:02d}.png"), img)
    return str(d)


def test_render_quilt_fused_matches_two_stage(aligned_scene_dir, monkeypatch):
    """The quilt-only render (API surface) must be byte-identical to the
    render-all-views + host-side assembly route."""
    interp = Interpolator(
        aligned_scene_dir, config=RenderConfig(method="TEN", view_count=8),
        progress=False,
    )
    q = interp.render_quilt(
        "0,0,1,1", focus=0.1, cols=2, rows=3, progress=False
    )
    assert q.quilt.shape == (3 * 16, 2 * 128, 3)
    # two-stage reference: full render, host-side assembly of the first 6
    res = interp.interpolate("0,0,1,1", focus=0.1, progress=False)
    want = np.concatenate(
        [
            np.concatenate(res.views[r * 2 : r * 2 + 2], axis=1)
            for r in range(3)
        ],
        axis=0,
    )
    np.testing.assert_array_equal(q.quilt, want)


@pytest.mark.full
def test_render_quilt_falls_back(scene_dir, monkeypatch):
    """Both methods on an unaligned geometry produce the correct canvas."""
    d, _, _ = scene_dir  # 48x64 views
    for m in ("STD", "TEN"):
        interp = Interpolator(
            d, config=RenderConfig(method=m, view_count=8), progress=False
        )
        q = interp.render_quilt(
            "0,0,1,1", focus=0.2, cols=2, rows=3, progress=False
        )
        res = interp.interpolate("0,0,1,1", focus=0.2, progress=False)
        want = np.concatenate(
            [
                np.concatenate(res.views[r * 2 : r * 2 + 2], axis=1)
                for r in range(3)
            ],
            axis=0,
        )
        np.testing.assert_array_equal(q.quilt, want)


def test_render_quilt_too_few_views(scene_dir):
    d, _, _ = scene_dir
    interp = Interpolator(
        d, config=RenderConfig(view_count=4), progress=False
    )
    with pytest.raises(ValueError, match="view_count"):
        interp.render_quilt("0,0,1,1", cols=5, rows=9, progress=False)


def test_cli_quilt_only(aligned_scene_dir, tmp_path, capsys, monkeypatch):
    """--quilt-only writes quilt.png and NOTHING else."""
    out = tmp_path / "qonly"
    rc = cli.main(
        ["-i", aligned_scene_dir, "-o", str(out), "-t", "0,0,1,1",
         "-m", "TEN_WM", "-f", "0.1", "--quilt-only", "--json"]
    )
    assert rc == 0
    import json as _json

    line = capsys.readouterr().out.strip().splitlines()[-1]
    summary = _json.loads(line)
    assert summary["files_written"] == 1
    assert sorted(os.listdir(out)) == ["quilt.png"]
    q = codec.decode(str(out / "quilt.png"))[:, :, :3]
    assert q.shape == (9 * 16, 5 * 128, 3)
