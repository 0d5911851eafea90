"""Test configuration.

Tests run on the CPU backend with 8 virtual devices so that multi-device
sharding tests work without accelerators; this must happen before jax is
imported anywhere. Tests marked `gpu` compile a GPU kernel and skip here
(chip_smoke.py runs the same checks on the card).
"""

import os

# Force CPU: tests must be hermetic and run on virtual CPU devices.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_collection_modifyitems(config, items):
    if jax.default_backend() == "gpu":
        return
    skip = pytest.mark.skip(
        reason="compiles a GPU kernel (no interpret mode); needs a GPU"
    )
    for item in items:
        if "gpu" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def small_lf(rng):
    """A small synthetic 4x4 light field with structured content.

    Images simulate a textured plane at nonzero disparity so that the focus
    search has real signal: each camera sees the same texture shifted
    proportionally to its grid position.
    """
    cols, rows = 4, 4
    h, w = 48, 64
    texture = rng.integers(0, 256, size=(h * 2, w * 2, 3), dtype=np.uint8)
    # Smooth the texture a bit so disparity search is well conditioned.
    t = texture.astype(np.float32)
    t = (t + np.roll(t, 1, 0) + np.roll(t, 1, 1) + np.roll(t, 2, 0)) / 4.0
    texture = t.astype(np.uint8)
    images = np.zeros((cols * rows, h, w, 4), dtype=np.uint8)
    for c in range(cols):
        for r in range(rows):
            dy, dx = r * 2, c * 2
            images[c * rows + r, :, :, :3] = texture[dy : dy + h, dx : dx + w]
            images[c * rows + r, :, :, 3] = 255
    return images, (cols, rows)
