#!/usr/bin/env python
"""Time each GPU kernel against the plain-XLA route it replaces, end to end
through Interpolator.interpolate, in one process on one device.

  estimate: ops/estimate_triton vs the XLA focal-stack sweep, all-in-focus
            renders (focus 0.1, range 0.3), both tap rules, TEN and STD;
  blend:    ops/blend_triton vs the f32 XLA contraction, fixed-focus STD
            renders (focus 0.2).

Each pair runs in the order kernel, xla, xla, kernel (compile caches cleared
before each arm), so drift over the call shows as a gap between the two
runs of one arm. The XLA arm is forced by making the kernel's `available`
say no. Both arms must agree: maps bit-exact, views within 1 LSB.
Prints one JSON line per arm and the device's
`nvidia-smi` name and power limit; exits 1 if any pair disagrees.

Usage: compare_engines.py [--grid 8x8] [--size 1080x1920] [--runs 10]
                          [--only estimate|blend]
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from lfinterpolator_tpu.api import Interpolator
from lfinterpolator_tpu.core.config import RenderConfig
from lfinterpolator_tpu.io.loader import LightField
from lfinterpolator_tpu.ops import blend_triton, estimate_triton
from lfinterpolator_tpu.utils import compile_cache
from lfinterpolator_tpu.utils.scenes import make_occlusion_scene

TRAJ = "0,0,1,1"
ORDER = ("kernel", "xla", "xla", "kernel")


def _render(lf, module, engine, *, exact, runs, **kw):
    """One arm: a fresh render with `module`'s kernel on or off."""
    jax.clear_caches()
    available = module.available
    if engine == "xla":
        module.available = lambda *a: False
    try:
        it = Interpolator(
            lf, config=RenderConfig(exact_focus_taps=exact), progress=False
        )
        return it.interpolate(TRAJ, benchmark_runs=runs, progress=False, **kw)
    finally:
        module.available = available


def _diff(a, b) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", default="8x8")
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--only", choices=("estimate", "blend"))
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        print("compare_engines: the kernels compile only for a GPU; JAX's "
              f"backend is {jax.default_backend()!r}", file=sys.stderr)
        return 2
    compile_cache.enable()
    cols, rows = (int(x) for x in args.grid.split("x"))
    h, w = (int(x) for x in args.size.split("x"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lf = LightField(make_occlusion_scene(cols, rows, h, w), cols, rows)

    pairs = []
    if args.only != "blend":
        for exact in (True, False):
            for method in ("TEN", "STD"):
                pairs.append((
                    f"estimate {'exact' if exact else 'fast'} {method}",
                    estimate_triton, exact,
                    dict(focus=0.1, focus_range=0.3, method=method),
                ))
    if args.only != "estimate":
        pairs.append(("blend STD fixed", blend_triton, True,
                      dict(focus=0.2, method="STD")))
    failures = 0
    for name, module, exact, kw in pairs:
        outs = {}
        for rep, engine in enumerate(ORDER):
            res = _render(lf, module, engine, exact=exact, runs=args.runs, **kw)
            ms = [1000.0 * t for t in res.run_times_s]
            print(json.dumps({
                "pair": name, "engine": engine, "rep": rep,
                "grid": args.grid, "size": args.size,
                "median_ms": float(np.median(ms)), "runs_ms": ms,
                "card": card,
            }), flush=True)
            outs.setdefault(engine, res)
        a, b = outs["kernel"], outs["xla"]
        dv = _diff(a.views, b.views)
        dm = 0 if a.maps is None else _diff(a.maps, b.maps)
        ok = dv <= 1 and dm == 0
        print(json.dumps({"pair": name, "views_max_diff": dv,
                          "maps_max_diff": dm, "agree": ok}), flush=True)
        failures += 0 if ok else 1
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
