#!/usr/bin/env python
"""Validate every capacity-planned batched render arm against the unbatched
render, byte for byte, on the current backend (the GPU, or the CPU).

The capacity planner (core/capacity.py) can split a render into view
batches and row-block the all-focus select / estimate; each arm must not
change a single output byte. The CPU test suite forces every arm on tiny
fixtures (tests/test_capacity.py); this script re-runs the same checks at
production-like sizes on the device, where the compiled kernels execute.

Arms: fixed view batches, per method; all-focus view batches, row-blocked
select, row-blocked estimate, and both, per method. Budgets are forced via
LFI_HBM_BYTES (only LOWERING the planner's ceiling, never raising it).

Usage: validate_batching.py [--size HxW] [--grid CxR] [--skip-fixed]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from lfinterpolator_tpu.api import Interpolator
from lfinterpolator_tpu.core import capacity, geometry
from lfinterpolator_tpu.core.config import RenderConfig
from lfinterpolator_tpu.io.loader import LightField
from lfinterpolator_tpu.ops import focus as focus_ops
from lfinterpolator_tpu.utils import compile_cache

FOCUS, FRANGE = 0.1, 0.2
TRAJ = "0,0,1,1"  # normalized: parse_trajectory scales by (cols-1, rows-1)


def _pad(lf, cfg):
    se = geometry.parse_trajectory(TRAJ, lf.cols_rows)
    offsets = geometry.compute_offsets(
        lf.cols, lf.rows, lf.width, lf.height, cfg.aspect,
        geometry.trajectory_center(se),
    )
    radius = geometry.block_radius(
        lf.width, lf.height, cfg.pixel_size_factor
    )
    return focus_ops.shift_pad_bound(
        offsets, FOCUS, FRANGE, radius, lf.height, lf.width
    )


def _find_budget(plan_fn, pred, divisor=4000):
    """The largest budget whose plan satisfies `pred`, scanning down."""
    full = plan_fn(1 << 40).bytes_unbatched
    for b in range(2 * full, 0, -max(1, full // divisor)):
        try:
            p = plan_fn(b)
        except ValueError:
            return None, None
        if pred(p):
            return b, p
    return None, None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--grid", default="4x4")
    ap.add_argument("--skip-fixed", action="store_true")
    args = ap.parse_args()
    h, w = (int(x) for x in args.size.split("x"))
    cols, rows = (int(x) for x in args.grid.split("x"))
    g, v, k = cols * rows, 64, 8
    compile_cache.enable()

    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8)
    lf = LightField(images=imgs, cols=cols, rows=rows)
    failures = 0

    def render(cfg, budget, **ikw):
        if budget is not None:
            os.environ["LFI_HBM_BYTES"] = str(budget)
        else:
            os.environ.pop("LFI_HBM_BYTES", None)
        t0 = time.perf_counter()
        out = Interpolator(lf, config=cfg, progress=False).interpolate(
            TRAJ, progress=False, **ikw
        )
        return out, time.perf_counter() - t0

    if not args.skip_fixed:
        for method in ("TEN", "STD"):
            cfg = RenderConfig(method=method, view_count=v)
            ref, t = render(cfg, None, focus=FOCUS)
            print(f"[fixed {method}] unbatched {t:.2f}s", flush=True)
            budget, plan = _find_budget(
                lambda b: capacity.plan_fixed_render(g, 3, h, w, v, budget=b),
                lambda p: p.batched,
            )
            out, t = render(cfg, budget, focus=FOCUS)
            ok = np.array_equal(out.views, ref.views)
            print(f"[fixed {method}] batched: vb={plan.view_batch} {t:.2f}s "
                  f"views_eq={ok}", flush=True)
            failures += 0 if ok else 1

    for method in ("TEN", "STD"):
        cfg = RenderConfig(method=method, view_count=v, focus_map_views=k)
        px, py = _pad(lf, cfg)
        ref, t = render(cfg, None, focus=FOCUS, focus_range=FRANGE)
        print(f"[af {method}] unbatched {t:.2f}s", flush=True)
        arms = [
            ("batched", lambda p: p.batched and p.row_block is None
             and p.estimate_row_block is None),
            ("est", lambda p: p.row_block is None
             and p.estimate_row_block is not None),
            ("rowblk", lambda p: p.row_block is not None
             and p.estimate_row_block is None),
            ("rowblk+est", lambda p: p.row_block is not None
             and p.estimate_row_block is not None),
        ]
        for name, pred in arms:
            b, p = _find_budget(
                lambda b: capacity.plan_allfocus_render(
                    g, k, 3, h, w, v, px=px, py=py, budget=b
                ),
                pred,
            )
            if b is None:
                print(f"[af {method}] {name}: regime not reachable", flush=True)
                continue
            out, t = render(cfg, b, focus=FOCUS, focus_range=FRANGE)
            ok_v = np.array_equal(out.views, ref.views)
            ok_m = np.array_equal(out.maps, ref.maps)
            print(
                f"[af {method}] {name}: vb={p.view_batch} rb={p.row_block} "
                f"est_rb={p.estimate_row_block} {t:.2f}s "
                f"views_eq={ok_v} maps_eq={ok_m}", flush=True,
            )
            failures += 0 if (ok_v and ok_m) else 1

    os.environ.pop("LFI_HBM_BYTES", None)
    print(json.dumps({"batched_arm_failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
