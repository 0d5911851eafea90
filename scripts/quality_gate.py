#!/usr/bin/env python
"""Quality gate: PSNR/SSIM of every render path against the NumPy oracle.

BASELINE.md target: >= 45 dB PSNR vs the bit-faithful oracle. Renders a
synthetic structured scene through the library paths (STD and TEN,
fixed-focus and all-in-focus) and prints one JSON line per path plus PASS/FAIL.

Runs on whatever backend JAX selects (CPU, or the GPU with the compiled
estimate kernel). Sizes are kept modest so device->host fetches stay cheap.

Usage: quality_gate.py [--size HxW] [--grid CxR]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_scene(rng, cols, rows, h, w):
    """Textured plane with per-camera disparity (structured, not noise)."""
    tex = rng.integers(0, 256, size=(h * 2, w * 2, 3), dtype=np.uint8)
    t = tex.astype(np.float32)
    t = (t + np.roll(t, 1, 0) + np.roll(t, 1, 1) + np.roll(t, 2, 0)) / 4.0
    tex = t.astype(np.uint8)
    images = np.zeros((cols * rows, h, w, 4), dtype=np.uint8)
    for c in range(cols):
        for r in range(rows):
            images[c * rows + r, :, :, :3] = tex[r * 2 : r * 2 + h, c * 2 : c * 2 + w]
            images[c * rows + r, :, :, 3] = 255
    return images


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", default="192x256")
    p.add_argument("--grid", default="6x6")
    p.add_argument("--threshold-db", type=float, default=45.0)
    p.add_argument(
        "--scene", choices=("plane", "occlusion"), default="plane",
        help="'plane': textured plane with per-camera disparity; "
             "'occlusion': parallax-occlusion scene (foreground occluders "
             "at distinct disparities over a background plane, "
             "utils/scenes.py) -- the content class the reference's real "
             "captured scenes exercise",
    )
    args = p.parse_args()
    h, w = (int(x) for x in args.size.lower().split("x"))
    cols, rows = (int(x) for x in args.grid.lower().split("x"))

    import jax.numpy as jnp
    from lfinterpolator_tpu.core import geometry
    from lfinterpolator_tpu.models import pipeline
    from lfinterpolator_tpu.ops import blend_xla, focus as focus_ops
    from lfinterpolator_tpu.ops import reference as oracle
    from lfinterpolator_tpu.utils import compile_cache, metrics

    compile_cache.enable()
    rng = np.random.default_rng(99)
    if args.scene == "occlusion":
        from lfinterpolator_tpu.utils.scenes import (
            make_occlusion_scene, occlusion_foci,
        )

        # layer foci on the gate sweep's candidate grid (focus/frange below)
        images = make_occlusion_scene(
            cols, rows, h, w, plane_foci=occlusion_foci(0.1, 0.4, 32),
            seed=99,
        )
    else:
        images = make_scene(rng, cols, rows, h, w)
    v = 16
    se = np.array([0.0, 0.0, cols - 1.0, rows - 1.0], np.float32)
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    )
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    focus, frange = 0.1, 0.4
    radius = geometry.block_radius(w, h)
    frad = (radius[0] // 10, radius[1] // 10)
    ids = geometry.select_focus_views(se, cols, rows, min(32, cols * rows))
    pad = focus_ops.shift_pad_bound(offsets, focus, frange, radius, h, w)

    planar = blend_xla.to_planar(jnp.asarray(images))
    weights = jnp.asarray(wm.astype(np.float32))
    offj = jnp.asarray(offsets)

    results = {}

    # fixed focus, both methods
    fo = geometry.focused_offsets(offsets, focus)
    want_fixed = oracle.blend_fixed(images, wm, fo)
    for method in ("STD", "TEN"):
        got = np.asarray(
            blend_xla.from_planar(
                pipeline.render_fixed_focus(
                    planar, weights, jnp.asarray(fo), method=method
                )
            )
        )
        results[f"fixed/{method}"] = metrics.psnr(got, want_fixed)

    # all-in-focus, both methods (oracle maps + oracle blends)
    map0 = oracle.focus_map_estimate(
        images, offsets, ids, focus, frange, radius, steps=32
    )
    map1 = oracle.focus_map_filter(map0, frad)
    want_std = oracle.blend_allfocus(images, wm, offsets, map1, focus, frange)
    want_ten = oracle.blend_allfocus(images, wm, offsets, map0, focus, frange)
    for method, want in (("STD", want_std), ("TEN", want_ten)):
        views, _ = pipeline.render_all_focus(
            planar, weights, offj,
            jnp.float32(focus), jnp.float32(frange), jnp.asarray(ids),
            method=method, radius=radius, filter_radius=frad, steps=32, pad=pad,
        )
        got = np.asarray(blend_xla.from_planar(views))
        results[f"allfocus/{method}"] = metrics.psnr(got, want)

    # --fast-focus (tap-rule truncation): a documented approximation, so it
    # is reported against the same exact-oracle renders to quantify the
    # deviation rather than gate on bit-exactness.
    for method, want in (("STD", want_std), ("TEN", want_ten)):
        views, _ = pipeline.render_all_focus(
            planar, weights, offj,
            jnp.float32(focus), jnp.float32(frange), jnp.asarray(ids),
            method=method, radius=radius, filter_radius=frad, steps=32,
            pad=pad, exact_taps=False,
        )
        got = np.asarray(blend_xla.from_planar(views))
        results[f"allfocus-fast/{method}"] = metrics.psnr(got, want)

    # allfocus-fast/* quantify the documented --fast-focus approximation
    # against the EXACT oracle; they are informational, not gated.
    ok = all(
        v >= args.threshold_db
        for k, v in results.items()
        if not k.startswith("allfocus-fast/")
    )
    print(json.dumps({
        "psnr_db": {k: (round(v, 2) if np.isfinite(v) else "inf")
                    for k, v in results.items()},
        "threshold_db": args.threshold_db,
        "pass": ok,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
