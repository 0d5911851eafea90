"""Smoke test of the render path on the GPU, through the user entry points.

    python chip_smoke.py           # phases 1-6 on one GPU
    python chip_smoke.py --mesh    # Interpolator(mesh=make_mesh()) on 4 GPUs

The scene is the headline one: an 8x8 camera grid at 1920x1080 rendered to
64 views, a seeded parallax-occlusion light field (utils/scenes.py). Every
phase drives `Interpolator`, `StreamingRenderer` or the CLI and checks the
result against the repo's plain references: the numpy oracle
(ops/reference.py) and the plain-XLA focal-stack sweep (ops/focus.py). A
failed check raises, so the script exits non-zero; the JSON summary on the
last line of stdout is printed only when every phase passed. Without a GPU
the script stops before any work.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

COLS, ROWS, H, W, V = 8, 8, 1080, 1920, 64
TRAJ = "0,0,1,1"
FOCUS = 0.2  # fixed-focus renders
AF_FOCUS, AF_RANGE = 0.1, 0.3  # all-in-focus renders (the scene's planes)
ORACLE_H = 36  # oracle map rows at full width (seconds, not hours)
VIEW_SUBSET = [0, 21, 42, 63]  # full-resolution oracle views
BATCH_BUDGET = 4 * 2**30  # device bytes that force both renders into batches


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(Exception):
    """A phase's check failed."""


def require(ok: bool, what) -> None:
    """Fail the phase unless `ok` (an explicit raise: asserts vanish
    under `python -O`)."""
    if not ok:
        raise SmokeFailure(what)


def max_diff(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    require(a.shape == b.shape, (a.shape, b.shape))
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def check(name: str, got, want, lsb: int) -> None:
    d = max_diff(got, want)
    log(f"  {name}: max diff {d} (limit {lsb})")
    require(d <= lsb, f"{name}: max diff {d} > {lsb}")


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, 1000.0 * (time.perf_counter() - t0)


def render_line(what: str, result, first_ms: float, card: str) -> None:
    log(
        f"  {what}: first call {first_ms:.1f} ms, steady "
        f"{result.avg_ms:.3f} ms/render ({len(result.run_times_s)} runs) "
        f"[{card}]"
    )


def make_scene(cols=COLS, rows=ROWS, h=H, w=W, seed=7):
    from lfinterpolator_tpu.utils.scenes import make_occlusion_scene

    return make_occlusion_scene(cols, rows, h, w, seed=seed)


def geometry_of(h, w, focus):
    """(fp16 weights [V, G], float offsets [G, 2], focused int offsets)."""
    from lfinterpolator_tpu.core import geometry

    se = geometry.parse_trajectory(TRAJ, (COLS, ROWS))
    wm16 = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, COLS, ROWS, 3.0, V)
    )
    offsets = geometry.compute_offsets(
        COLS, ROWS, w, h, 1.0, geometry.trajectory_center(se)
    )
    return wm16, offsets, geometry.focused_offsets(offsets, focus)


def estimate_inputs(interp):
    """(focus views, their offsets, radius, pad) of the render's estimate,
    derived the way Interpolator derives them."""
    import jax.numpy as jnp

    from lfinterpolator_tpu.core import geometry
    from lfinterpolator_tpu.ops import focus as focus_ops

    lf, cfg = interp.lf, interp.config
    se = geometry.parse_trajectory(TRAJ, lf.cols_rows)
    offsets = geometry.compute_offsets(
        lf.cols, lf.rows, lf.width, lf.height, cfg.aspect,
        geometry.trajectory_center(se),
    )
    radius = geometry.block_radius(lf.width, lf.height)
    ids = geometry.select_focus_views(se, lf.cols, lf.rows, 32)
    pad = focus_ops.shift_pad_bound(
        offsets, AF_FOCUS, AF_RANGE, radius, lf.height, lf.width
    )
    ids = jnp.asarray(ids)
    return interp.images[ids], jnp.asarray(offsets)[ids], radius, pad


def sweep_maps(interp, exact: bool):
    """The plain-XLA sweep's (raw, filtered) maps for the scene."""
    import jax.numpy as jnp

    from lfinterpolator_tpu.ops import focus as focus_ops

    sel, soff, radius, pad = estimate_inputs(interp)
    map0 = focus_ops.estimate_focus_map(
        sel, soff, jnp.float32(AF_FOCUS), jnp.float32(AF_RANGE), radius,
        steps=32, pad=pad, exact_taps=exact, engine="xla",
    )
    map1 = focus_ops.filter_focus_map(map0, (radius[0] // 10, radius[1] // 10))
    return np.asarray(map0), np.asarray(map1)


def check_rounding():
    """The compiled division and mul-add guards round like IEEE numpy on
    this device (XLA:GPU's own `/` and FMA contraction do not)."""
    import jax
    import jax.numpy as jnp

    from lfinterpolator_tpu.ops import blend_xla

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1000, 1 << 20).astype(np.float32)
    b = rng.uniform(1, 300, 1 << 20).astype(np.float32)
    got = np.asarray(jax.jit(blend_xla.div_exact)(a, b))
    n_div = int(np.sum(got != a / b))
    m = np.arange(256, dtype=np.uint8)
    fv = np.asarray(jax.jit(blend_xla.focus_values_from_map)(
        m, jnp.float32(AF_FOCUS), jnp.float32(AF_RANGE)
    ))
    want = np.float32(AF_FOCUS) + (
        m.astype(np.float32) / np.float32(255)
    ) * np.float32(AF_RANGE)
    n_fv = int(np.sum(fv != want))
    log(f"  div_exact vs IEEE on 2^20 quotients: {n_div} differ; "
        f"map-byte focus values vs oracle: {n_fv} differ")
    require(n_div == 0 and n_fv == 0, "rounding differs from IEEE")


def phase_fixed(interp, scene, card):
    """Phase 2: fixed focus, STD and TEN, vs the oracle."""
    import jax
    import jax.numpy as jnp

    from lfinterpolator_tpu.ops import blend_triton, blend_xla, reference

    log("phase 2: fixed focus (STD, TEN) vs ops/reference.blend_fixed")
    wm16, _, fo = geometry_of(H, W, FOCUS)
    want = reference.blend_fixed(scene, wm16[VIEW_SUBSET], fo)
    out = {}
    for m in ("STD", "TEN"):
        res, first = timed(lambda: interp.interpolate(
            TRAJ, focus=FOCUS, method=m, benchmark_runs=5, progress=False
        ))
        render_line(f"{m} fixed 8x8/1080p/64 views", res, first, card)
        require(res.views.shape == (V, H, W, 3), res.views.shape)
        check(f"{m} views {VIEW_SUBSET} vs oracle", res.views[VIEW_SUBSET],
              want, 1)
        out[m] = res
    # The STD kernel alone: the one-pass blend against the same blend in
    # view batches of 2, the check the gpu-marked test runs.
    flat = jax.jit(blend_xla.shift_stack)(interp.images, jnp.asarray(fo)).reshape(
        COLS * ROWS, -1
    )
    n = blend_triton.batch_mismatches(flat, jnp.asarray(wm16, jnp.float32))
    log(f"  STD blend kernel, one pass vs view batches of 2: {n} values differ")
    require(n == 0, f"STD view batches differ at {n} values")
    return out


def phase_allfocus(interp, scene, card):
    """Phase 3: all-in-focus, both methods and the fast tap rule."""
    import dataclasses

    from lfinterpolator_tpu.api import Interpolator
    from lfinterpolator_tpu.io.loader import LightField
    from lfinterpolator_tpu.ops import estimate_triton, reference

    log("phase 3: all-in-focus (STD, TEN, --fast-focus)")
    wm16, offsets, _ = geometry_of(H, W, FOCUS)
    out = {}
    for exact in (True, False):
        want0, want1 = sweep_maps(interp, exact)
        methods = ("STD", "TEN") if exact else ("TEN",)
        for m in methods:
            tag = f"{m} all-focus{'' if exact else ' fast-focus'}"
            it = interp if exact else Interpolator(
                interp.lf, progress=False,
                config=dataclasses.replace(interp.config, exact_focus_taps=False),
            )
            res, first = timed(lambda: it.interpolate(
                TRAJ, focus=AF_FOCUS, focus_range=AF_RANGE, method=m,
                benchmark_runs=3, progress=False,
            ))
            render_line(tag, res, first, card)
            require(res.views.shape == (V, H, W, 3), res.views.shape)
            check(f"{tag} raw map vs XLA sweep (1080p)", res.maps[0], want0, 0)
            check(f"{tag} filtered map vs XLA sweep", res.maps[1], want1, 0)
            fmap = res.maps[1] if m == "STD" else res.maps[0]
            ref = reference.blend_allfocus(
                scene, wm16[VIEW_SUBSET], offsets, fmap, AF_FOCUS, AF_RANGE
            )
            check(f"{tag} views {VIEW_SUBSET} vs oracle", res.views[VIEW_SUBSET],
                  ref, 1)
            out[(m, exact)] = res
        # The kernel alone against the sweep on an unaligned row block, the
        # check the gpu-marked test runs.
        sel, soff, radius, pad = estimate_inputs(interp)
        r0, rc = H // 10 + 1, H // 5 + 3
        n = estimate_triton.mismatches(
            sel, soff, AF_FOCUS, AF_RANGE, radius, steps=32, pad=pad,
            exact=exact, row_start=r0, row_count=rc,
        )
        log(f"  estimate kernel vs sweep, {rc} rows from {r0} "
            f"(exact={exact}): {n} pixels differ")
        require(n == 0, f"kernel and sweep differ at {n} pixels")

    # The oracle's per-pixel search at full width and a reduced height.
    small = LightField(np.ascontiguousarray(scene[:, :ORACLE_H]), COLS, ROWS)
    sm = Interpolator(small, progress=False)
    wm16s, offs_s, _ = geometry_of(ORACLE_H, W, FOCUS)
    from lfinterpolator_tpu.core import geometry

    se = geometry.parse_trajectory(TRAJ, (COLS, ROWS))
    ids = geometry.select_focus_views(se, COLS, ROWS, 32)
    radius = geometry.block_radius(W, ORACLE_H)
    t0 = time.perf_counter()
    ora0 = reference.focus_map_estimate(
        small.images, offs_s, ids, AF_FOCUS, AF_RANGE, radius, 32
    )
    ora1 = reference.focus_map_filter(ora0, (radius[0] // 10, radius[1] // 10))
    log(f"  oracle map {ORACLE_H}x{W}: {time.perf_counter() - t0:.1f} s (host)")
    for m in ("STD", "TEN"):
        res = sm.interpolate(
            TRAJ, focus=AF_FOCUS, focus_range=AF_RANGE, method=m,
            progress=False,
        )
        check(f"{m} raw map vs oracle ({ORACLE_H}x{W})", res.maps[0], ora0, 0)
        check(f"{m} filtered map vs oracle", res.maps[1], ora1, 0)
        fmap = ora1 if m == "STD" else ora0
        ref = reference.blend_allfocus(
            small.images, wm16s, offs_s, fmap, AF_FOCUS, AF_RANGE
        )
        check(f"{m} all-focus views vs oracle ({ORACLE_H}x{W})", res.views,
              ref, 1)
    return out


def phase_quilt_batch_stream(interp, fixed, allfocus, scene, card):
    """Phase 4: quilt, batch and stream vs the matching one-shot renders."""
    from lfinterpolator_tpu.api import Interpolator
    from lfinterpolator_tpu.core.config import RenderConfig
    from lfinterpolator_tpu.io.loader import LightField
    from lfinterpolator_tpu.streaming import StreamingRenderer

    log("phase 4: quilt, batch, stream")
    q, first = timed(lambda: interp.render_quilt(
        TRAJ, focus=FOCUS, method="TEN", progress=False
    ))
    views = fixed["TEN"].views
    want = np.concatenate([
        np.concatenate(list(views[r * 5 : r * 5 + 5]), axis=1)
        for r in range(9)
    ], axis=0)
    log(f"  render_quilt 5x9: {first:.1f} ms first call [{card}]")
    check("quilt vs one-shot views", q.quilt, want, 0)

    trajs = [
        "0,0,1,1", "1,1,0,0", "0,1,1,0", "0.2,0.2,0.8,0.8",
        "0,0.5,1,0.5", "0.5,0,0.5,1", "0.1,0.3,0.9,0.6", "0.25,0,0.75,1",
    ]
    batch, first = timed(lambda: interp.interpolate_batch(
        trajs, focus=FOCUS, method="TEN", progress=False
    ))
    log(f"  interpolate_batch x8 (TEN, fixed): {first:.1f} ms [{card}]")
    for t, b in zip(trajs, batch):
        solo = interp.interpolate(t, focus=FOCUS, method="TEN", progress=False)
        check(f"batch {t} vs solo", b.views, solo.views, 1)

    frames = [scene, scene[:, :, ::-1].copy(), 255 - scene]
    cfg = RenderConfig(
        method="STD", focus=AF_FOCUS, focus_range=AF_RANGE
    )
    sr = StreamingRenderer(COLS, ROWS, W, H, TRAJ, config=cfg)
    t0 = time.perf_counter()
    outs = list(sr.render_stream(iter(frames)))
    log(f"  StreamingRenderer 3 all-focus STD frames: "
        f"{1000 * (time.perf_counter() - t0):.1f} ms [{card}]")
    require(len(outs) == 3, f"{len(outs)} stream frames")
    for i, (frame, (sv, smaps)) in enumerate(zip(frames, outs)):
        if i == 0:
            one = allfocus[("STD", True)]
        else:
            frame_lf = LightField(np.ascontiguousarray(frame), COLS, ROWS)
            one = Interpolator(frame_lf, config=cfg, progress=False).interpolate(
                TRAJ, focus=AF_FOCUS, focus_range=AF_RANGE, progress=False
            )
        check(f"stream frame {i} maps vs one-shot", smaps, one.maps, 0)
        check(f"stream frame {i} views vs one-shot", sv, one.views, 1)


def phase_view_batched(lf, fixed, allfocus, card):
    """Phase 5: a render forced into view batches by LFI_HBM_BYTES."""
    from lfinterpolator_tpu.api import Interpolator
    from lfinterpolator_tpu.core import capacity

    log("phase 5: view-batched renders (LFI_HBM_BYTES)")
    plan = capacity.plan_fixed_render(
        COLS * ROWS, 3, H, W, V, budget=BATCH_BUDGET
    )
    require(plan.batched, plan)
    os.environ["LFI_HBM_BYTES"] = str(BATCH_BUDGET)
    try:
        interp = Interpolator(lf, progress=False)
        for m in ("STD", "TEN"):
            res, first = timed(lambda: interp.interpolate(
                TRAJ, focus=FOCUS, method=m, progress=False
            ))
            log(f"  {m} fixed in batches of {plan.view_batch}: "
                f"{first:.1f} ms [{card}]")
            check(f"{m} batched vs unbatched", res.views, fixed[m].views, 0)
        _, _, _, pad = estimate_inputs(interp)
        af_plan = capacity.plan_allfocus_render(
            COLS * ROWS, 32, 3, H, W, V, px=pad[0], py=pad[1],
            budget=BATCH_BUDGET,
        )
        require(af_plan.batched, af_plan)
        res, first = timed(lambda: interp.interpolate(
            TRAJ, focus=AF_FOCUS, focus_range=AF_RANGE, method="STD",
            progress=False,
        ))
        log(f"  STD all-focus in batches of {af_plan.view_batch}: "
            f"{first:.1f} ms [{card}]")
        want = allfocus[("STD", True)]
        check("all-focus batched maps vs unbatched", res.maps, want.maps, 0)
        check("all-focus batched views vs unbatched", res.views, want.views, 0)
    finally:
        del os.environ["LFI_HBM_BYTES"]


def phase_cli(scene, card):
    """Phase 6: the CLI, in this process, on the full-size scene as PNGs."""
    from concurrent.futures import ThreadPoolExecutor

    from lfinterpolator_tpu import cli
    from lfinterpolator_tpu.api import Interpolator
    from lfinterpolator_tpu.core.config import RenderConfig
    from lfinterpolator_tpu.io import codec

    log(f"phase 6: CLI (in-process) on a {W}x{H} PNG scene")
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "scene"), os.path.join(tmp, "out")
        os.makedirs(src)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(
                lambda i: codec.encode_png(
                    f"{src}/{i // ROWS:02d}_{i % ROWS:02d}.png", scene[i]
                ),
                range(COLS * ROWS),
            ))
        log(f"  wrote {COLS * ROWS} PNGs: "
            f"{time.perf_counter() - t0:.1f} s (host)")
        t0 = time.perf_counter()
        rc = cli.main([
            "-i", src, "-o", dst, "-t", TRAJ, "-m", "TEN_WM", "-f", "0.1",
            "-r", "0.3", "--quilt", "--no-progress",
        ])
        log(f"  cli.main: rc {rc}, {time.perf_counter() - t0:.1f} s "
            f"(PNG decode, render, PNG encode) [{card}]")
        require(rc == 0, f"cli.main returned {rc}")
        names = sorted(os.listdir(dst))
        require(len(names) == V + 3, names)  # views, map0, map1, quilt
        want = Interpolator(
            src, config=RenderConfig(method="TEN"), progress=False
        ).interpolate(TRAJ, focus=0.1, focus_range=0.3, progress=False)
        got = np.stack([
            codec.decode(f"{dst}/{i:02d}.png")[..., :3] for i in range(V)
        ])
        require(got.shape == (V, H, W, 3), got.shape)
        check("CLI PNG views vs API render", got, want.views, 0)
        check("CLI map0.png vs API map",
              codec.decode(f"{dst}/map0.png")[..., 0], want.maps[0], 0)


def phase_mesh(scene, card):
    """--mesh: Interpolator(mesh=make_mesh()) vs the same render on one
    device, fixed and all-in-focus."""
    import jax

    from lfinterpolator_tpu.api import Interpolator
    from lfinterpolator_tpu.io.loader import LightField
    from lfinterpolator_tpu.parallel.mesh import make_mesh

    n = len(jax.devices())
    require(n == 4, f"--mesh needs 4 GPUs, JAX sees {n}")
    mesh = make_mesh()
    log(f"mesh {dict(mesh.shape)} over {[d.id for d in mesh.devices.flat]}")
    lf = LightField(scene, COLS, ROWS)
    one = Interpolator(lf, progress=False)
    sharded = Interpolator(lf, progress=False, mesh=mesh)
    shard_ids = {
        s.device.id for s in sharded.images.addressable_shards
    }
    require(shard_ids == {d.id for d in jax.devices()}, shard_ids)
    for m in ("STD", "TEN"):
        for fr in (0.0, AF_RANGE):
            f = AF_FOCUS if fr else FOCUS
            tag = f"{m} {'all-focus' if fr else 'fixed'}"
            a = one.interpolate(TRAJ, focus=f, focus_range=fr, method=m,
                                progress=False)
            b, first = timed(lambda: sharded.interpolate(
                TRAJ, focus=f, focus_range=fr, method=m, benchmark_runs=3,
                progress=False,
            ))
            render_line(f"mesh {tag}", b, first, card)
            if fr:
                check(f"mesh {tag} maps vs one device", b.maps, a.maps, 0)
            check(f"mesh {tag} views vs one device", b.views, a.views, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", action="store_true",
                    help="run only the 4-GPU mesh path and its comparison")
    args = ap.parse_args()

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's backend is {backend!r}",
              file=sys.stderr)
        return 2
    from lfinterpolator_tpu.utils import compile_cache

    compile_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    dev = jax.devices()[0]
    log(f"phase 1: {len(jax.devices())} x {dev.platform} {dev.device_kind}, "
        f"jax {jax.__version__}")
    check_rounding()

    t0 = time.perf_counter()
    scene = make_scene()
    log(f"scene {COLS}x{ROWS} grid at {W}x{H}: "
        f"{time.perf_counter() - t0:.1f} s (host)")

    if args.mesh:
        phase_mesh(scene, card)
    else:
        from lfinterpolator_tpu.api import Interpolator
        from lfinterpolator_tpu.io.loader import LightField

        lf = LightField(scene, COLS, ROWS)
        interp = Interpolator(lf, progress=False)
        fixed = phase_fixed(interp, scene, card)
        allfocus = phase_allfocus(interp, scene, card)
        phase_quilt_batch_stream(interp, fixed, allfocus, scene, card)
        del interp
        phase_view_batched(lf, fixed, allfocus, card)
        phase_cli(scene, card)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
