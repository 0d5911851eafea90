#!/usr/bin/env python
"""Benchmarks over the BASELINE.json configs, on the GPU.

    python bench.py [--config NAME|all]      (or LFI_BENCH_CONFIG=NAME)

Configs: headline, c1_2x2_512, c2_4x4_1024, c3_allfocus_1080,
c3_fast_allfocus_1080, c3_occlusion_1080, c4_quilt_1080, c5_video_4k,
c6_serving_batch, c7_serving_allfocus, c7_tol_serving_allfocus,
c8_stream_allfocus_1080, c8_std_stream_allfocus_1080,
c8_refresh_allfocus_1080, c8_refresh_allfocus_4k, c8_stream_allfocus_4k.
The default is the headline: 8x8 grid, 1080p, 64 novel views, TEN blend.

Each config prints one JSON line naming the metric, its value and unit, the
median milliseconds per step, and the device (platform, device_kind,
device_count). Every step is timed to jax.block_until_ready after WARMUP
untimed calls; the median over LFI_BENCH_RUNS (default 50) timed calls is
reported (the mean for --map-refresh, whose cost is amortized). The script refuses to run without a GPU.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.models import pipeline
from lfinterpolator_tpu.ops import blend_xla, focus as focus_ops, quilt
from lfinterpolator_tpu.utils import compile_cache

RUNS = int(os.environ.get("LFI_BENCH_RUNS", "50"))
WARMUP = 3


def _time(step, runs: int = RUNS, stat=np.median) -> float:
    """Seconds per `step(i)` call (median by default), each call synced
    on its outputs."""
    for i in range(WARMUP):
        jax.block_until_ready(step(i))
    times = []
    for i in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(step(WARMUP + i))
        times.append(time.perf_counter() - t0)
    return float(stat(times))


def _emit(metric: str, value: float, unit: str, per_s: float, **extra):
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": metric, "value": value, "unit": unit, "ms": 1000 * per_s,
        **extra,
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }), flush=True)


def _weights(start_end, cols, rows, v, effect=3.0):
    return geometry.quantize_weights_f16(
        geometry.weight_matrix(start_end, cols, rows, effect, v)
    ).astype(np.float32)


def _diagonal(cols, rows):
    """The corner-to-corner trajectory, in grid coordinates."""
    return np.array([0.0, 0.0, cols - 1.0, rows - 1.0], np.float32)


def _setup(cols, rows, h, w, v):
    """(trajectory, weights [V, G], offsets [G, 2], random planar stack)."""
    start_end = _diagonal(cols, rows)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(start_end)
    )
    # The synthetic light field is made on the device (set-up, not timed).
    planar = jax.random.randint(
        jax.random.key(0), (cols * rows, 3, h, w), 0, 255, jnp.int32
    ).astype(jnp.uint8)
    return start_end, _weights(start_end, cols, rows, v), offsets, planar


_render_fixed = jax.jit(blend_xla.render_fixed, static_argnums=3)


def _fixed_step(planar, wm, offsets, method="TEN"):
    weights = jnp.asarray(wm)
    fo = jnp.asarray(geometry.focused_offsets(offsets, 0.25))
    return lambda i: _render_fixed(planar, weights, fo, method)


def _structured_scene(
    cols, rows, h, w,
    # candidates are 0.1 + k*0.3/31; planes sit ON the grid (k=3, 13, 26)
    # so the sweep can lock them exactly -- off-grid planes leave a
    # shallow cost minimum that truncation noise wins
    plane_foci=(0.1 + 3 * 0.3 / 31, 0.1 + 13 * 0.3 / 31, 0.1 + 26 * 0.3 / 31),
):
    """Multi-plane light field made on the device: 3 depth bands, each
    texture-shifted per camera, aligned at the given FOCUS VALUES (the
    per-camera pixel shift of a plane at focus f is f * w/cols per grid
    cell, the compute_offsets scale). Focus estimation on iid noise is
    meaningless, so the all-focus configs use this structured content."""
    dpx = [f * w / cols for f in plane_foci]
    dpy = [f * w / rows for f in plane_foci]
    maxp = max((cols - 1) / 2, (rows - 1) / 2)
    m = int(np.ceil(maxp * max(dpx + dpy))) + 8
    tex = jax.random.randint(
        jax.random.key(7), (3, h + 2 * m, w + 2 * m), 0, 255, jnp.int32
    )
    t = tex.astype(jnp.float32)
    t = (t + jnp.roll(t, 1, 1) + jnp.roll(t, 1, 2) + jnp.roll(t, 2, 1)) / 4
    tex = t.astype(jnp.uint8)
    band = h // 3
    pos = jnp.asarray(
        [[c - (cols - 1) / 2, r - (rows - 1) / 2]
         for c in range(cols) for r in range(rows)], jnp.float32
    )

    @jax.jit
    def make():
        def one(p):
            def plane(dx_px, dy_px):
                dx = (p[0] * dx_px).astype(jnp.int32) + m
                dy = (p[1] * dy_px).astype(jnp.int32) + m
                return lax.dynamic_slice(tex, (0, dy, dx), (3, h, w))
            near, mid, far = (
                plane(dpx[2], dpy[2]), plane(dpx[1], dpy[1]),
                plane(dpx[0], dpy[0]),
            )
            yy = lax.broadcasted_iota(jnp.int32, (1, h, 1), 1)
            return jnp.where(
                yy < band, near, jnp.where(yy < 2 * band, mid, far)
            )
        return jax.vmap(one)(pos)

    return jax.block_until_ready(make())


def _allfocus(cols, rows, h, w, k, start_end=None, planar=None):
    """Static and device inputs of one all-focus render at focus 0.1,
    range 0.3, 32 candidates: a dict of render_all_focus keywords plus
    the planar stack, offsets and focus-view ids."""
    if start_end is None:
        start_end = _diagonal(cols, rows)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(start_end)
    )
    radius = geometry.block_radius(w, h)
    return dict(
        planar=_structured_scene(cols, rows, h, w) if planar is None else planar,
        offsets=jnp.asarray(offsets),
        ids=jnp.asarray(geometry.select_focus_views(start_end, cols, rows, k)),
        kw=dict(
            radius=radius, filter_radius=(radius[0] // 10, radius[1] // 10),
            steps=32, pad=focus_ops.shift_pad_bound(
                offsets, 0.1, 0.3, radius, h, w
            ),
        ),
    )


def _allfocus_step(a, weights, method="TEN", **kw):
    weights = jnp.asarray(weights)
    return lambda i: pipeline.render_all_focus(
        a["planar"], weights, a["offsets"], jnp.float32(0.1),
        jnp.float32(0.3), a["ids"], method=method, **a["kw"], **kw,
    )


def _estimate_step(a):
    return lambda i: pipeline.compute_focus_maps(
        a["planar"], a["offsets"], jnp.float32(0.1), jnp.float32(0.3),
        a["ids"], **a["kw"],
    )


def bench_headline():
    h, w, v = 1080, 1920, 64
    _, wm, offsets, planar = _setup(8, 8, h, w, v)
    per = _time(_fixed_step(planar, wm, offsets))
    _emit("8x8-grid 1080p 64-view TEN blend throughput",
          v * h * w / per / 1e9, "GP/s", per)


def bench_c1():
    # 2x2 grid, 512x512, SINGLE center novel view (start == end, like the
    # reference's degenerate trajectory), STD blend.
    h = w = 512
    start_end = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    wm = _weights(start_end, 2, 2, 1)
    offsets = geometry.compute_offsets(
        2, 2, w, h, 1.0, geometry.trajectory_center(start_end)
    )
    _, _, _, planar = _setup(2, 2, h, w, 1)
    per = _time(_fixed_step(planar, wm, offsets, "STD"), RUNS * 4)
    _emit("2x2-grid 512px single center view, STD", h * w / per / 1e9,
          "GP/s", per)


def bench_c2():
    # 4x4 grid, 1024px, trajectory of 8 novel views.
    h = w = 1024
    _, wm, offsets, planar = _setup(4, 4, h, w, 8)
    per = _time(_fixed_step(planar, wm, offsets), RUNS * 2)
    _emit("4x4-grid 1024px 8-view TEN blend", 8 * h * w / per / 1e9, "GP/s",
          per)


def bench_c3(exact_taps=True):
    # 4x4 grid, 1080p, per-pixel focus-map disparity search + blend.
    h, w, v = 1080, 1920, 64
    wm = _weights(_diagonal(4, 4), 4, 4, v)
    a = _allfocus(4, 4, h, w, 16)
    per = _time(_allfocus_step(a, wm, exact_taps=exact_taps), max(4, RUNS // 4))
    rule = "exact taps" if exact_taps else "--fast-focus tap rule"
    _emit(f"4x4-grid 1080p all-in-focus pipeline, {rule}",
          v * h * w / per / 1e9, "GP/s", per)


def bench_c3_fast():
    bench_c3(exact_taps=False)


def bench_c3_occ():
    # c3 on the parallax-OCCLUSION scene (utils/scenes.py): occluders at
    # distinct disparities, so the maps carry occlusion argmin noise
    # instead of clean locked bands. Both methods; TEN is the metric.
    from lfinterpolator_tpu.utils.scenes import (
        make_occlusion_scene, occlusion_foci,
    )

    h, w, v = 1080, 1920, 64
    wm = _weights(_diagonal(4, 4), 4, 4, v)
    imgs = make_occlusion_scene(
        4, 4, h, w, plane_foci=occlusion_foci(0.1, 0.3, 32), seed=7
    )
    planar = jax.device_put(
        np.ascontiguousarray(imgs[..., :3].transpose(0, 3, 1, 2))
    )
    a = _allfocus(4, 4, h, w, 16, planar=planar)
    per_ten = _time(_allfocus_step(a, wm, "TEN"), max(4, RUNS // 4))
    per_std = _time(_allfocus_step(a, wm, "STD"), max(4, RUNS // 4))
    _emit("4x4-grid 1080p all-in-focus, parallax-occlusion scene, TEN",
          v * h * w / per_ten / 1e9, "GP/s", per_ten, std_ms=1000 * per_std)


def bench_c4():
    # 45-view 5x9 quilt (Looking Glass): TEN blend, then the canvas copy.
    h, w, v = 1080, 1920, 64
    _, wm, offsets, planar = _setup(8, 8, h, w, v)
    blend = _fixed_step(planar, wm, offsets)
    per = _time(lambda i: quilt.assemble_quilt(blend(i), cols=5, rows=9))
    _emit("8x8-grid 1080p 45-view quilt, blend + canvas copy",
          45 * h * w / per / 1e9, "GP/s", per)


def bench_c5():
    # Video light field at 4K: one full shift+blend of the raw stack per
    # frame.
    h, w, v = 2160, 3840, 64
    _, wm, offsets, planar = _setup(8, 8, h, w, v)
    per = _time(_fixed_step(planar, wm, offsets), max(16, RUNS // 2))
    _emit("8x8-grid 4K video streaming blend, 64 views", 1.0 / per,
          "frames/s", per)


def bench_c6():
    # Serving: 8 same-center trajectories fused into ONE [512, G] blend
    # (the interpolate_batch pattern): the image stack is read once.
    h, w, v, n = 1080, 1920, 64, 8
    _, _, offsets, planar = _setup(8, 8, h, w, v)
    big = np.concatenate([
        _weights(np.array([0.1 * t, 0.1 * t, 7 - 0.1 * t, 7 - 0.1 * t],
                          np.float32), 8, 8, v)
        for t in range(n)
    ])
    per = _time(_fixed_step(planar, big, offsets))
    _emit("8x8-grid 1080p serving: 8 trajectories x 64 views fused",
          n * v * h * w / per / 1e9, "GP/s", per, traj_per_s=n / per)


def bench_c7():
    # All-focus serving: 8 same-center trajectories fused into ONE [512, G]
    # per-pixel blend sharing a single estimate + select.
    h, w, v, n = 1080, 1920, 64, 8
    big = np.concatenate([
        _weights(np.array([0.05 * t, 0.05 * t, 3 - 0.05 * t, 3 - 0.05 * t],
                          np.float32), 4, 4, v)
        for t in range(n)
    ])
    a = _allfocus(4, 4, h, w, 16)
    per = _time(_allfocus_step(a, big), max(4, RUNS // 4))
    _emit("4x4-grid 1080p all-focus serving: 8 trajectories x 64 views, "
          "one shared estimate+select", n * v * h * w / per / 1e9, "GP/s",
          per, traj_per_s=n / per)


def bench_c7_tol():
    # interpolate_batch's center_tolerance: 8 trajectories whose centers
    # are jittered within 0.04 grid cells. tolerance=0 keeps 8 groups (8
    # estimates + selects); a small tolerance merges them into ONE group.
    h, w, v, n = 1080, 1920, 64, 8
    planar = _structured_scene(4, 4, h, w)
    rng = np.random.default_rng(7)
    ses = []
    for _ in range(n):
        d = rng.uniform(-0.02, 0.02, 2).astype(np.float32)
        ses.append(np.array([0.2 + d[0], 0.2 + d[1], 2.8 + d[0], 2.8 + d[1]],
                            np.float32))
    groups = [_allfocus(4, 4, h, w, 16, start_end=se, planar=planar)
              for se in ses]
    pad = tuple(max(g["kw"]["pad"][j] for g in groups) for j in (0, 1))
    for g in groups:  # one static bound: one compile for every member
        g["kw"]["pad"] = pad
    solo = [_allfocus_step(g, _weights(se, 4, 4, v))
            for g, se in zip(groups, ses)]
    merged = _allfocus_step(
        groups[0], np.concatenate([_weights(se, 4, 4, v) for se in ses])
    )
    per_solo = _time(lambda i: [s(i) for s in solo], max(3, RUNS // 8))
    per_merged = _time(merged, max(4, RUNS // 4))
    _emit("4x4-grid 1080p all-focus serving, 8 center-jittered trajectories "
          "merged into one estimate", n / per_merged, "traj/s", per_merged,
          unmerged_ms=1000 * per_solo)


def _stream(cols, rows, h, w, k, label, method="TEN"):
    # Streaming all-focus frame loop (StreamingRenderer's focus_range > 0
    # path), with the estimate timed on its own.
    v = 64
    wm = _weights(_diagonal(cols, rows), cols, rows, v)
    a = _allfocus(cols, rows, h, w, k)
    runs = max(4, RUNS // 4)
    per = _time(_allfocus_step(a, wm, method), runs)
    per_est = _time(_estimate_step(a), runs)
    _emit(f"{label} streaming all-focus, {method}", 1.0 / per, "frames/s",
          per, estimate_ms=1000 * per_est)


def bench_c8():
    _stream(8, 8, 1080, 1920, 32, "8x8-grid 1080p")


def bench_c8_std():
    _stream(8, 8, 1080, 1920, 32, "8x8-grid 1080p", method="STD")


def bench_c8_4k():
    _stream(4, 4, 2160, 3840, 16, "4x4-grid 4K")


def _refresh(cols, rows, h, w, k, label, n=8):
    # Streaming all-focus with --map-refresh 8: estimate every 8th frame,
    # blend every frame with the latest maps.
    v = 64
    wm = _weights(_diagonal(cols, rows), cols, rows, v)
    a = _allfocus(cols, rows, h, w, k)
    weights = jnp.asarray(wm)
    est = _estimate_step(a)
    maps = [None]

    def step(i):
        if i % n == 0:
            maps[0] = est(i)
        return pipeline.blend_all_focus(
            a["planar"], weights, a["offsets"], maps[0], jnp.float32(0.1),
            jnp.float32(0.3), method="TEN",
        )

    per = _time(step, max(2, RUNS // (2 * n)) * n, stat=np.mean)
    _emit(f"{label} streaming all-focus, --map-refresh {n}, amortized",
          1.0 / per, "frames/s", per)


def bench_c8_refresh():
    _refresh(8, 8, 1080, 1920, 32, "8x8-grid 1080p")


def bench_c8_refresh_4k():
    _refresh(4, 4, 2160, 3840, 16, "4x4-grid 4K")


CONFIGS = {
    "headline": bench_headline,
    "c1_2x2_512": bench_c1,
    "c2_4x4_1024": bench_c2,
    "c3_allfocus_1080": bench_c3,
    "c3_fast_allfocus_1080": bench_c3_fast,
    "c3_occlusion_1080": bench_c3_occ,
    "c4_quilt_1080": bench_c4,
    "c5_video_4k": bench_c5,
    "c6_serving_batch": bench_c6,
    "c7_serving_allfocus": bench_c7,
    "c7_tol_serving_allfocus": bench_c7_tol,
    "c8_stream_allfocus_1080": bench_c8,
    "c8_std_stream_allfocus_1080": bench_c8_std,
    "c8_refresh_allfocus_1080": bench_c8_refresh,
    "c8_refresh_allfocus_4k": bench_c8_refresh_4k,
    "c8_stream_allfocus_4k": bench_c8_4k,
}


def main() -> int:
    name = os.environ.get("LFI_BENCH_CONFIG", "headline")
    if "--config" in sys.argv:
        i = sys.argv.index("--config")
        if i + 1 >= len(sys.argv):
            print(f"--config needs a value: {list(CONFIGS)} or all",
                  file=sys.stderr)
            return 2
        name = sys.argv[i + 1]
    if name != "all" and name not in CONFIGS:
        print(f"Unknown config {name!r}; valid: {list(CONFIGS)} or all",
              file=sys.stderr)
        return 2
    if jax.default_backend() != "gpu":
        print(f"bench.py: needs a GPU; JAX's backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    compile_cache.enable()
    for fn in CONFIGS.values() if name == "all" else [CONFIGS[name]]:
        fn()
    return 0


if __name__ == "__main__":
    sys.exit(main())
