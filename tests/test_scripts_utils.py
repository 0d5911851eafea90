"""Tests for the evaluation scripts and profiling utilities."""

import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from lfinterpolator_tpu.io import codec
from lfinterpolator_tpu.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


def _write(tmp_path, name, arr):
    p = str(tmp_path / name)
    codec.encode_png(p, arr)
    return p


def test_image_quality_metrics_script(tmp_path, rng):
    a = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
    pa = _write(tmp_path, "a.png", a)
    out = subprocess.run(
        [sys.executable, f"{REPO}/scripts/image_quality_metrics.py", pa, pa],
        capture_output=True, text=True, env=ENV,
    )
    assert out.returncode == 0
    psnr, ssim = out.stdout.split()
    assert psnr == "inf" and float(ssim) == pytest.approx(1.0)


def test_vmaf_skips_gracefully_without_ffmpeg(monkeypatch, tmp_path, rng):
    """No libvmaf-enabled ffmpeg on PATH -> vmaf() is None, metrics still work."""
    from lfinterpolator_tpu.utils import metrics

    monkeypatch.setattr("shutil.which", lambda _: None)
    monkeypatch.setattr(
        "lfinterpolator_tpu.utils.metrics._vmaf_probe_cache", {}
    )
    pa = _write(tmp_path, "a.png", rng.integers(0, 256, (16, 16, 4), dtype=np.uint8))
    assert not metrics.vmaf_available()
    assert metrics.vmaf(pa, pa) is None
    result = metrics.compare_files(pa, pa)
    assert "vmaf" not in result and result["psnr"] == float("inf")


def test_vmaf_parses_ffmpeg_output(monkeypatch, tmp_path, rng):
    """With a (fake) libvmaf ffmpeg, the score is parsed from stderr and
    reported next to psnr/ssim (reference: scripts/imageQualityMetrics.sh:10-11)."""
    from lfinterpolator_tpu.utils import metrics

    fake = tmp_path / "ffmpeg"
    fake.write_text(
        "#!/bin/sh\n"
        'case "$*" in *-filters*) echo "libvmaf";; '
        '*) echo "[libvmaf] VMAF score: 93.421" 1>&2;; esac\n'
    )
    fake.chmod(0o755)
    monkeypatch.setattr(
        "lfinterpolator_tpu.utils.metrics._vmaf_probe_cache", {}
    )
    pa = _write(tmp_path, "a.png", rng.integers(0, 256, (8, 8, 4), dtype=np.uint8))
    assert metrics.vmaf_available(str(fake))
    assert metrics.vmaf(pa, pa, ffmpeg=str(fake)) == pytest.approx(93.421)


def test_compare_dirs_script(tmp_path, rng):
    d1 = tmp_path / "d1"; d2 = tmp_path / "d2"
    d1.mkdir(); d2.mkdir()
    img = rng.integers(0, 256, (12, 12, 4), dtype=np.uint8)
    _write(d1, "x.png", img)
    noisy = np.clip(img.astype(int) + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)
    _write(d2, "x.png", noisy)
    out = subprocess.run(
        [sys.executable, f"{REPO}/scripts/compare_dirs.py", str(d1), str(d2), "--json"],
        capture_output=True, text=True, env=ENV,
    )
    assert out.returncode == 0
    data = json.loads(out.stdout)
    assert "x.png" in data["files"] and data["avg_psnr"] > 30


def test_views_to_quilt_script(tmp_path, rng):
    d = tmp_path / "views"; d.mkdir()
    for i in range(6):
        _write(d, f"{i:02d}.png", rng.integers(0, 256, (8, 10, 4), dtype=np.uint8))
    out = subprocess.run(
        [sys.executable, f"{REPO}/scripts/views_to_quilt.py", str(d),
         "--cols", "3", "--rows", "2"],
        capture_output=True, text=True, env=ENV,
    )
    assert out.returncode == 0, out.stderr
    q = codec.decode(str(d / "quilt.png"))
    assert q.shape == (16, 30, 4)


@pytest.mark.parametrize("scene", ["plane", "occlusion"])
def test_quality_gate_script(scene):
    """The quality gate passes at a small size on both scenes: every gated
    path >= 45 dB against the oracle, --fast-focus reported alongside."""
    out = subprocess.run(
        [sys.executable, f"{REPO}/scripts/quality_gate.py", "--size",
         "24x40", "--grid", "4x4", "--scene", scene],
        capture_output=True, text=True, env=ENV, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["pass"] is True
    assert set(summary["psnr_db"]) == {
        "fixed/STD", "fixed/TEN", "allfocus/STD", "allfocus/TEN",
        "allfocus-fast/STD", "allfocus-fast/TEN",
    }


def test_validate_batching_script():
    """Every reachable batched arm is byte-identical to the unbatched
    render at a small size."""
    out = subprocess.run(
        [sys.executable, f"{REPO}/scripts/validate_batching.py", "--size",
         "24x40", "--grid", "4x4"],
        capture_output=True, text=True, env=ENV, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "batched_arm_failures": 0
    }
    assert "views_eq=True" in out.stdout


def test_benchmark_harness():
    calls = []

    def step(i):
        calls.append(i)
        return jnp.ones((4,)) * i

    res = profiling.benchmark(step, out_pixels=1000, runs=5, warmup=2)
    assert len(res.times_s) == 5
    assert len(calls) == 7
    assert res.gpixels_per_s > 0
    assert set(res.to_dict()) == {"runs", "avg_ms", "min_ms", "gpixels_per_s"}


def test_timer_sync():
    with profiling.Timer() as t:
        x = t.sync(jnp.arange(10) * 2)
    assert t.elapsed_s >= 0
    assert int(x.sum()) == 90


@pytest.mark.full
def test_map_refresh_quality_harness(tmp_path):
    """The --map-refresh temporal-quality harness runs end-to-end and
    reports stale-frame dB for each refresh interval (strict JSON even
    when stale frames are bit-identical)."""
    import json
    import subprocess

    out = subprocess.run(
        [
            sys.executable, f"{REPO}/scripts/map_refresh_quality.py",
            "--size", "48x64", "--grid", "4x4", "--frames", "6",
            "--speed", "2", "--refresh", "3", "--steps", "8",
        ],
        capture_output=True, text=True,
        env=ENV, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    r = summary["refresh"]["3"]
    assert r["stale_frames"] == 4
    assert r["min_db"] > 10
