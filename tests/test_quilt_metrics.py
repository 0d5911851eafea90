"""Tests for on-device quilt assembly and quality metrics."""

import numpy as np
import jax.numpy as jnp
import pytest

from lfinterpolator_tpu.ops import quilt
from lfinterpolator_tpu.utils import metrics


def test_quilt_tile_order_row_major(rng):
    v, c, h, w = 45, 3, 4, 6
    views = rng.integers(0, 256, size=(v, c, h, w), dtype=np.uint8)
    q = np.asarray(quilt.assemble_quilt(jnp.asarray(views), cols=5, rows=9))
    assert q.shape == (3, 9 * h, 5 * w)
    # view k sits at row k//5, col k%5 (montage order)
    for k in [0, 4, 5, 44]:
        r, cidx = divmod(k, 5)
        np.testing.assert_array_equal(
            q[:, r * h : (r + 1) * h, cidx * w : (cidx + 1) * w], views[k]
        )


def test_quilt_resize(rng):
    views = rng.integers(0, 256, size=(45, 3, 8, 8), dtype=np.uint8)
    q = np.asarray(
        quilt.assemble_quilt(jnp.asarray(views), cols=5, rows=9, tile_size=(4, 4))
    )
    assert q.shape == (3, 36, 20)


def test_quilt_too_few_views(rng):
    views = rng.integers(0, 256, size=(10, 3, 4, 4), dtype=np.uint8)
    with pytest.raises(ValueError, match="needs 45"):
        quilt.assemble_quilt(jnp.asarray(views), cols=5, rows=9)


@pytest.mark.parametrize(
    "v,h,w,cols,rows",
    [(6, 16, 128, 2, 3), (45, 5, 7, 5, 9), (12, 9, 33, 4, 3), (8, 1, 1, 2, 2)],
)
def test_quilt_matches_numpy_montage(rng, v, h, w, cols, rows):
    """The canvas equals a host montage of the first cols*rows views
    (row-major, no resize), for aligned, odd and degenerate tiles."""
    views = rng.integers(0, 256, size=(v, 3, h, w), dtype=np.uint8)
    got = np.asarray(
        quilt.assemble_quilt(jnp.asarray(views), cols=cols, rows=rows)
    )
    want = np.concatenate(
        [np.concatenate(list(views[r * cols : (r + 1) * cols]), axis=2)
         for r in range(rows)],
        axis=1,
    )
    np.testing.assert_array_equal(got, want)


def test_psnr_identical_and_known(rng):
    a = rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    assert metrics.psnr(a, a) == float("inf")
    b = a.astype(np.int32).copy()
    b = np.clip(b + 1, 0, 255)  # off-by-one everywhere -> MSE ~1
    p = metrics.psnr(a, b.astype(np.uint8))
    assert 47.0 < p < 48.5  # 10*log10(255^2/1) = 48.13, minus clip effects


def test_ssim_bounds(rng):
    a = rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
    assert metrics.ssim(a, a) == pytest.approx(1.0)
    noise = rng.integers(0, 256, size=a.shape, dtype=np.uint8)
    assert metrics.ssim(a, noise) < 0.2


def test_metrics_shape_mismatch(rng):
    a = np.zeros((4, 4)), np.zeros((5, 5))
    with pytest.raises(ValueError):
        metrics.psnr(*a)


def test_quilt_same_size_tile_is_a_copy(rng):
    """tile_size equal to the view size takes no resize."""
    views = jnp.asarray(rng.integers(0, 256, (8, 3, 16, 24), dtype=np.uint8))
    a = np.asarray(quilt.assemble_quilt(views, cols=2, rows=3))
    b = np.asarray(
        quilt.assemble_quilt(views, cols=2, rows=3, tile_size=(16, 24))
    )
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# VMAF parse path (reference: scripts/imageQualityMetrics.sh:10-11).
# ffmpeg/libvmaf is absent in this environment, so the subprocess + parse
# path is exercised end-to-end against a fake ffmpeg that reproduces the
# real filter's output format (vf_libvmaf logs "VMAF score: %f" to stderr;
# standalone libvmaf v1 printed "VMAF score = %f" — both canned below).


def _write_fake_ffmpeg(tmp_path, vmaf_line):
    script = tmp_path / "ffmpeg"
    script.write_text(
        "#!/bin/sh\n"
        'if [ "$2" = "-filters" ]; then\n'
        '  echo " ... V->V       libvmaf           Calculate the VMAF"\n'
        "  exit 0\n"
        "fi\n"
        f"echo '{vmaf_line}' >&2\n"
        "exit 0\n"
    )
    script.chmod(0o755)
    return str(script)


@pytest.mark.parametrize(
    "line, want",
    [
        # ffmpeg vf_libvmaf (all released versions): "VMAF score: %f"
        ("[Parsed_libvmaf_0 @ 0x5600a1b2c3d0] VMAF score: 92.345678", 92.345678),
        # libvmaf v1 standalone / vmafossexec format
        ("VMAF score = 76.668905", 76.668905),
        # integer score edge case
        ("[libvmaf @ 0x7f] VMAF score: 100", 100.0),
    ],
)
def test_vmaf_regex_real_formats(line, want):
    m = metrics._VMAF_RE.search(line)
    assert m is not None
    assert float(m.group(1)) == pytest.approx(want)


def test_vmaf_end_to_end_fake_ffmpeg(tmp_path, rng):
    from lfinterpolator_tpu.io import codec

    a = tmp_path / "a.png"
    b = tmp_path / "b.png"
    img = rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    codec.encode_png(str(a), img)
    codec.encode_png(str(b), img)

    fake = _write_fake_ffmpeg(
        tmp_path, "[Parsed_libvmaf_0 @ 0x5600a1b2c3d0] VMAF score: 92.345678"
    )
    assert metrics.vmaf_available(fake)
    score = metrics.vmaf(str(a), str(b), ffmpeg=fake)
    assert score == pytest.approx(92.345678)
    # compare_files should surface it under the "vmaf" key
    got = metrics.compare_files(str(a), str(b), with_vmaf=True)
    assert got["psnr"] == float("inf")
    # compare_files uses the default "ffmpeg" binary, absent here -> no key,
    # proving the graceful-skip branch alongside the parse branch
    assert "vmaf" not in got or isinstance(got["vmaf"], float)


def test_vmaf_unparseable_output_returns_none(tmp_path, rng):
    from lfinterpolator_tpu.io import codec

    a = tmp_path / "a.png"
    img = rng.integers(0, 256, size=(4, 4, 3), dtype=np.uint8)
    codec.encode_png(str(a), img)
    fake = _write_fake_ffmpeg(tmp_path, "frame I/O summary, no score here")
    assert metrics.vmaf(str(a), str(a), ffmpeg=fake) is None


def test_vmaf_missing_binary_returns_none(tmp_path):
    assert metrics.vmaf("x.png", "y.png", ffmpeg=str(tmp_path / "nope")) is None
    assert not metrics.vmaf_available(str(tmp_path / "nope"))
