"""Real 64-view 8K all-focus render, end to end on one device -- both methods.

A full 4320x7680 / 8x8-grid / 64-view / K=32 / steps=32 all-focus render
through the capacity planner's arms under the device's own budget (no
LFI_HBM_BYTES forcing), mirroring the reference's self-proving benchmark loop
(reference: src/interpolator.cu:271-295).

Phases are timed by wrapping the pipeline entry points with
block_until_ready timers (one instrumented run, one clean run). Correctness
is checked on a row band against the same row-block pipeline functions run
on the host CPU backend (bit-identity of the row-block seams vs full frames
is covered by the test suite; CPU vs device execution is the cross-check
here).

Usage:  python -u scripts/bench_8k.py [--method TEN|STD|both] [--no-verify]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

H, W = 4320, 7680
COLS = ROWS = 8
FOCUS, FRANGE = 0.0, 0.04
TRAJ = "0,0,1,1"
SEED = 8


def build_scene() -> np.ndarray:
    """Structured multi-plane 8K light field, host-side ([G, H, W, 4] u8).

    Three depth bands whose per-camera texture shifts correspond to focus
    values {0.035, 0.015, 0.0} inside the searched [0, 0.04] window, so the
    disparity estimate has real signal (iid noise has no coherent
    disparity). Seeded and pure numpy: the CPU oracle rebuilds it exactly.
    """
    rng = np.random.default_rng(SEED)
    m = 128
    tex = rng.integers(0, 256, (3, H + 2 * m, W + 2 * m), dtype=np.uint8)
    t = tex.astype(np.float32)
    t = (t + np.roll(t, 1, 1) + np.roll(t, 1, 2) + np.roll(t, 2, 1)) / 4
    tex = t.astype(np.uint8)
    del t
    band = H // 3
    # plane texture shift per grid cell (px): f_plane = s / 960 for the
    # x-offsets of an 8x8 grid at 7680 wide, aspect 1 (see compute_offsets)
    shifts = (33.6, 14.4, 0.0)  # near, mid, far -> focus 0.035/0.015/0.0
    out = np.empty((COLS * ROWS, H, W, 4), np.uint8)
    out[..., 3] = 255
    for c in range(COLS):
        for r in range(ROWS):
            px_, py_ = c - (COLS - 1) / 2, r - (ROWS - 1) / 2
            img = out[c * ROWS + r]
            y0 = 0
            for s, h_band in zip(shifts, (band, band, H - 2 * band)):
                dx = int(round(px_ * s)) + m
                dy = int(round(py_ * s)) + m
                img[y0 : y0 + h_band, :, :3] = tex[
                    :, dy + y0 : dy + y0 + h_band, dx : dx + W
                ].transpose(1, 2, 0)
                y0 += h_band
    return out


class PhaseTimer:
    """Wrap pipeline functions with block_until_ready timers."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def wrap(self, mod, names):
        import jax

        self._saved = []
        for name in names:
            fn = getattr(mod, name)

            def make(fn=fn, name=name):
                def timed(*a, **k):
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    out = jax.block_until_ready(out)
                    dt = time.perf_counter() - t0
                    self.times[name] = self.times.get(name, 0.0) + dt
                    self.calls[name] = self.calls.get(name, 0) + 1
                    return out

                return timed

            self._saved.append((mod, name, fn))
            setattr(mod, name, make())

    def unwrap(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="both", choices=["TEN", "STD", "both"])
    ap.add_argument("--no-verify", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lfinterpolator_tpu.api import Interpolator
    from lfinterpolator_tpu.core.config import RenderConfig
    from lfinterpolator_tpu.io.loader import LightField
    from lfinterpolator_tpu.models import pipeline
    from lfinterpolator_tpu.utils import compile_cache

    compile_cache.enable()
    print("devices:", jax.devices(), flush=True)
    cpu = jax.devices("cpu")[0]

    t0 = time.perf_counter()
    images = build_scene()
    print(f"scene built: {images.nbytes/2**30:.2f} GiB host, "
          f"{time.perf_counter()-t0:.1f}s", flush=True)

    lf = LightField(images=images, cols=COLS, rows=ROWS)
    cfg = RenderConfig(method="TEN")
    t0 = time.perf_counter()
    interp = Interpolator(lf, config=cfg, progress=False)
    jax.block_until_ready(interp.images)
    up = time.perf_counter() - t0
    gb = interp.images.nbytes / 2**30
    print(f"upload: {gb:.2f} GiB planar in {up:.1f}s "
          f"({gb*1024/up:.0f} MB/s)", flush=True)

    methods = ["TEN", "STD"] if args.method == "both" else [args.method]
    results = {}
    for mk in methods:
        print(f"\n=== {mk} 8K all-focus ===", flush=True)
        pt = PhaseTimer()
        pt.wrap(pipeline, [
            "compute_focus_maps", "estimate_focus_rows",
            "assemble_focus_maps", "gather_views", "select_allfocus",
            "blend_selected",
        ])
        t0 = time.perf_counter()
        res = interp.interpolate(
            TRAJ, focus=FOCUS, focus_range=FRANGE, method=mk,
            progress=True,
        )
        wall1 = time.perf_counter() - t0
        pt.unwrap()
        phases = {k: round(v, 2) for k, v in pt.times.items()}
        print(f"run 1 (instrumented, incl. compiles): {wall1:.1f}s; "
              f"phases: {phases} calls: {pt.calls}", flush=True)

        # clean steady-state run (no sync wrappers, programs compiled)
        t0 = time.perf_counter()
        res = interp.interpolate(
            TRAJ, focus=FOCUS, focus_range=FRANGE, method=mk,
            progress=False,
        )
        wall2 = time.perf_counter() - t0
        device_s = sum(pt.times.values())
        print(f"run 2 (clean): {wall2:.1f}s total "
              f"(instrumented device phases summed {device_s:.1f}s; "
              f"remainder ~= device->host fetch + host)", flush=True)
        results[mk] = {
            "wall_first_s": round(wall1, 1),
            "wall_steady_s": round(wall2, 1),
            "phases_s": phases,
        }

        if not args.no_verify:
            views, maps = res.views, res.maps
            verify(jax, jnp, cpu, interp, images, views, maps, mk, results[mk])
        del res

    print("\nRESULT " + json.dumps({
        "config": f"{COLS}x{ROWS} grid, {W}x{H}, 64 views, K=32, steps=32, "
                  f"focus {FOCUS} range {FRANGE}",
        "upload_gib": round(gb, 2), "upload_s": round(up, 1),
        "methods": results,
    }), flush=True)


def verify(jax, jnp, cpu, interp, images, views, maps, mk, rec):
    """Row-band checks against the CPU oracle (same-rows re-derivation)."""
    import numpy as np

    from lfinterpolator_tpu.core import geometry
    from lfinterpolator_tpu.core.config import RenderConfig
    from lfinterpolator_tpu.models import pipeline
    from lfinterpolator_tpu.ops import focus as focus_ops

    cfg = RenderConfig(method=mk)
    lf = interp.lf
    se = geometry.parse_trajectory(TRAJ, lf.cols_rows)
    center = geometry.trajectory_center(se)
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, lf.cols, lf.rows, cfg.effect,
                               cfg.view_count)
    ).astype(np.float32)
    offsets = geometry.compute_offsets(
        lf.cols, lf.rows, lf.width, lf.height, cfg.aspect, center
    )
    radius = geometry.block_radius(lf.width, lf.height,
                                   cfg.pixel_size_factor)
    ids = geometry.select_focus_views(se, lf.cols, lf.rows,
                                      cfg.focus_map_views)
    pad = focus_ops.shift_pad_bound(offsets, FOCUS, FRANGE, radius,
                                    lf.height, lf.width)
    f_i, fr = jnp.float32(FOCUS), jnp.float32(FRANGE)

    t0 = time.perf_counter()
    print("fetching full maps for the oracle...", flush=True)
    maps_np = np.asarray(maps)
    print(f"maps fetched ({maps_np.nbytes/2**20:.0f} MiB, "
          f"{time.perf_counter()-t0:.0f}s)", flush=True)

    r0, rc = min(2160, lf.height // 2), 16  # mid-frame interior band
    views_band = np.asarray(views[:, r0 : r0 + rc])
    with jax.default_device(cpu):
        planar = jnp.asarray(
            np.ascontiguousarray(images[..., :3].transpose(0, 3, 1, 2))
        )
        sel = pipeline.gather_views(planar, jnp.asarray(ids))
        sel_off = jnp.asarray(offsets)[jnp.asarray(ids)]
        t0 = time.perf_counter()
        map_rows = np.asarray(pipeline.estimate_focus_rows(
            sel, sel_off, f_i, fr, r0, radius=radius,
            steps=cfg.focus_steps, pad=pad, exact_taps=True, rc=rc,
            top=0, bot=0,
        ))
        d_map = int(np.abs(map_rows.astype(int)
                           - maps_np[0, r0:r0 + rc].astype(int)).max())
        print(f"map0 rows {r0}..{r0+rc} vs CPU oracle: max|diff|={d_map} "
              f"({time.perf_counter()-t0:.0f}s)", flush=True)

        # CPU filter pass of the device's raw map -> its filtered map
        ry, rx = int(radius[1]) // 10, int(radius[0]) // 10
        from lfinterpolator_tpu.ops.focus import filter_focus_map

        m1 = np.asarray(filter_focus_map(
            jnp.asarray(maps_np[0]), (rx, ry))[r0:r0 + rc])
        d_m1 = int(np.abs(m1.astype(int)
                          - maps_np[1, r0:r0 + rc].astype(int)).max())
        print(f"map1 rows vs CPU filter of device map0: max|diff|={d_m1}",
              flush=True)

        t0 = time.perf_counter()
        sel_rows = pipeline.select_allfocus(
            planar, jnp.asarray(offsets), jnp.asarray(maps_np), f_i, fr,
            r0, method=mk, row_count=rc,
        )
        view_rows = np.asarray(pipeline.blend_selected(
            sel_rows, jnp.asarray(wm), method=mk,
        )).transpose(0, 2, 3, 1)
        d_views = int(np.abs(
            view_rows.astype(int) - views_band.astype(int)
        ).max())
        print(f"all 64 view rows {r0}..{r0+rc} vs CPU oracle: "
              f"max|diff|={d_views} ({time.perf_counter()-t0:.0f}s)",
              flush=True)
    rec["verify"] = {"map0_maxdiff": d_map, "map1_maxdiff": d_m1,
                     "views_maxdiff": d_views, "rows": [r0, r0 + rc]}


if __name__ == "__main__":
    main()
