#!/usr/bin/env python
"""Temporal quality of --map-refresh N (StreamingRenderer's stale-map reuse).

`--map-refresh N` re-estimates the focus maps every Nth streaming frame and
blends the in-between frames with the latest maps (streaming.py:217-230) --
an approximation whose error depends on how fast the DEPTH STRUCTURE moves.
This harness quantifies it: an animated parallax-occlusion scene
(utils/scenes.py, occluders drifting `--speed` px/frame over the background)
is rendered frame by frame twice -- once with per-frame estimation (the
exact streaming loop) and once with maps refreshed every N frames -- and the
stale-map frames are scored against the per-frame ones (PSNR over all views).
Refresh frames (t % N == 0) are bit-identical by construction and excluded
from the min/mean.

Prints one JSON line: per-N mean/min dB plus the per-frame-estimate
amortization context. Runs on whatever backend JAX selects (CPU or GPU).

Usage: map_refresh_quality.py [--size HxW] [--grid CxR] [--frames F]
                              [--speed PX] [--refresh N,N,...]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", default="96x128")
    p.add_argument("--grid", default="4x4")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--speed", type=float, default=2.0,
                   help="occluder drift in px/frame (depth-edge motion)")
    p.add_argument("--refresh", default="4,8")
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--steps", type=int, default=32)
    args = p.parse_args()
    h, w = (int(x) for x in args.size.lower().split("x"))
    cols, rows = (int(x) for x in args.grid.lower().split("x"))
    refreshes = [int(x) for x in args.refresh.split(",")]

    import jax.numpy as jnp
    from lfinterpolator_tpu.core import geometry
    from lfinterpolator_tpu.models import pipeline
    from lfinterpolator_tpu.ops import blend_xla, focus as focus_ops
    from lfinterpolator_tpu.utils import compile_cache, metrics
    from lfinterpolator_tpu.utils.scenes import (
        make_occlusion_scene, occlusion_foci,
    )

    compile_cache.enable()
    focus, frange = 0.1, 0.3
    se = np.array([0.0, 0.0, cols - 1.0, rows - 1.0], np.float32)
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, args.views)
    ).astype(np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    radius = geometry.block_radius(w, h)
    frad = (max(radius[0] // 10, 1), max(radius[1] // 10, 1))
    ids = geometry.select_focus_views(
        se, cols, rows, min(32, cols * rows)
    )
    pad = focus_ops.shift_pad_bound(offsets, focus, frange, radius, h, w)
    weights = jnp.asarray(wm)
    offj = jnp.asarray(offsets)
    idsj = jnp.asarray(ids)
    foci = occlusion_foci(focus, frange, args.steps)

    # per-frame animated scene + per-frame exact maps (the N=1 reference)
    frames, maps_exact = [], []
    for t in range(args.frames):
        imgs = make_occlusion_scene(
            cols, rows, h, w, plane_foci=foci, seed=21,
            occluder_shift=(0.0, args.speed * t),
        )
        planar = blend_xla.to_planar(jnp.asarray(imgs))
        frames.append(planar)
        maps_exact.append(pipeline.compute_focus_maps(
            planar, offj, jnp.float32(focus), jnp.float32(frange), idsj,
            radius=radius, filter_radius=frad, steps=args.steps, pad=pad,
        ))

    def blend(planar, maps):
        return np.asarray(blend_xla.from_planar(pipeline.blend_all_focus(
            planar, weights, offj, maps, jnp.float32(focus),
            jnp.float32(frange), method="TEN",
        )))

    exact_views = [blend(frames[t], maps_exact[t]) for t in range(args.frames)]

    result = {
        "scene": {"size": f"{h}x{w}", "grid": f"{cols}x{rows}",
                  "frames": args.frames, "speed_px_per_frame": args.speed},
        "refresh": {},
    }
    for n in refreshes:
        scores = []
        for t in range(args.frames):
            if t % n == 0:
                continue  # bit-identical by construction
            stale = blend(frames[t], maps_exact[(t // n) * n])
            scores.append(metrics.psnr(stale, exact_views[t]))
        finite = [s for s in scores if np.isfinite(s)]
        result["refresh"][str(n)] = {
            "stale_frames": len(scores),
            # stale frames whose maps happen to still be exact (slow motion)
            "identical_frames": len(scores) - len(finite),
            "mean_db": round(float(np.mean(finite)), 2) if finite else None,
            "min_db": round(float(np.min(scores)), 2),
        }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
