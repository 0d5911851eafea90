"""High-level API: the Interpolator (reference: src/interpolator.h:5-37).

Owns the device-resident light field and runs the render pipeline:

    interp = Interpolator("/data/scene")            # load + upload once
    result = interp.interpolate(trajectory="0,0,1,1", method="TEN", focus=0.2)
    result.save("out/")                             # 00.png..63.png (+maps)

Unlike the reference (which re-uploads constants per run and always times 100
kernel repetitions, src/interpolator.cu:248-297), uploads happen once at
construction, renders are jit-cached across calls with different
trajectories/focus values, and benchmarking is opt-in.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from .core import capacity, geometry
from .core.config import RenderConfig
from .io import writer
from .io.loader import LightField, load_light_field
from .models import pipeline
from .ops import blend_xla, focus as focus_ops, quilt as quilt_ops


def _fetch(x) -> np.ndarray:
    """Device->host fetch that also works for mesh-sharded arrays spanning
    multiple processes (gathered to every host)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        x = multihost_utils.process_allgather(x, tiled=True)
    return np.asarray(x)


# The view-batched fixed render, split at the blend seam
# (blend_xla.render_fixed = blend(shift_stack(...))) so the shift runs once
# per step and only the contraction repeats per weight-row batch.
_shift_stack_jit = jax.jit(blend_xla.shift_stack)
_blend_rows_jit = jax.jit(blend_xla.blend, static_argnames=("method",))


def _batch_weights(
    weights_np: np.ndarray, vb: int, progress: bool
) -> tuple[int, list[jnp.ndarray]]:
    """Split a [V, G] weight matrix into ceil(V/vb) device batches of vb
    rows. One compiled shape serves every batch: the trailing batch's rows
    are zero-padded (a zero row blends to zeros; trimmed host-side by
    _drain_view_batches)."""
    v, g = weights_np.shape
    nb = -(-v // vb)
    wm_pad = np.zeros((nb * vb, g), np.float32)
    wm_pad[:v] = weights_np
    w_batches = [
        jnp.asarray(wm_pad[b * vb : (b + 1) * vb]) for b in range(nb)
    ]
    if progress:
        print(
            f"Rendering {v} views in {nb} batches of {vb} "
            f"(output exceeds device memory)"
        )
    return nb, w_batches


def _drain_view_batches(
    nb: int, vb: int, v: int, h: int, w: int, render_batch
) -> np.ndarray:
    """Render `nb` view batches, draining each to the host while the next
    renders (JAX dispatch is async), so at most two batch outputs are ever
    device-resident. `render_batch(b)` -> device [vb, C, h, w] uint8; the
    trailing batch's zero-padded rows are trimmed. Returns [v, h, w, 3]."""
    out_np = np.empty((v, h, w, 3), np.uint8)
    pending = None  # (batch index, device views [vb, C, h, w])

    def drain(item):
        b, o = item
        arr = np.asarray(o)  # device->host fetch of one batch
        lo = b * vb
        n = min(v - lo, vb)
        out_np[lo : lo + n] = arr[:n].transpose(0, 2, 3, 1)

    for b in range(nb):
        o = render_batch(b)
        if pending is not None:
            drain(pending)
        pending = (b, o)
    drain(pending)
    return out_np


@dataclasses.dataclass
class RenderResult:
    """Output of one interpolate() call."""

    views: np.ndarray  # [V, H, W, 3] uint8
    maps: np.ndarray | None  # [2, H, W] uint8 (when focus_range > 0)
    run_times_s: list[float]  # per timed repetition (empty if not benchmarked)
    config: RenderConfig

    @property
    def avg_ms(self) -> float | None:
        if not self.run_times_s:
            return None
        return 1000.0 * sum(self.run_times_s) / len(self.run_times_s)

    @property
    def megapixels_per_s(self) -> float | None:
        """Output-pixel throughput of the render step."""
        if not self.run_times_s:
            return None
        v, h, w = self.views.shape[:3]
        avg = sum(self.run_times_s) / len(self.run_times_s)
        return v * h * w / avg / 1e6

    def save(self, path: str, *, progress: bool = True) -> list[str]:
        return writer.write_views(path, self.views, self.maps, progress=progress)

    def save_quilt(self, path: str, cols: int = 5, rows: int = 9,
                   tile_size: tuple[int, int] | None = None) -> str:
        q = quilt_ops.assemble_quilt(
            jnp.asarray(np.transpose(self.views, (0, 3, 1, 2))),
            cols=cols, rows=rows, tile_size=tile_size,
        )
        return writer.write_quilt(path, np.asarray(quilt_ops.to_hwc(q)))


@dataclasses.dataclass
class QuiltResult:
    """Output of one render_quilt() call."""

    quilt: np.ndarray  # [rows*tile_h, cols*tile_w, 3] uint8
    run_times_s: list[float]  # per timed repetition (empty if not benchmarked)
    config: RenderConfig

    @property
    def avg_ms(self) -> float | None:
        if not self.run_times_s:
            return None
        return 1000.0 * sum(self.run_times_s) / len(self.run_times_s)

    @property
    def gigapixels_per_s(self) -> float | None:
        """Canvas-pixel throughput of the render step."""
        if not self.run_times_s:
            return None
        h, w = self.quilt.shape[:2]
        avg = sum(self.run_times_s) / len(self.run_times_s)
        return h * w / avg / 1e9

    def save(self, path: str) -> str:
        return writer.write_quilt(path, self.quilt)


class Interpolator:
    """Load a light field once; render novel-view sets many times."""

    def __init__(
        self,
        source: str | LightField,
        *,
        config: RenderConfig | None = None,
        progress: bool = True,
        mesh=None,  # jax.sharding.Mesh with axes (view, space), or None
    ):
        self.config = config or RenderConfig()
        self.lf = (
            source if isinstance(source, LightField) else load_light_field(
                source, progress=progress
            )
        )
        if progress:
            print(
                f"Loaded {self.lf.cols}x{self.lf.rows} grid of "
                f"{self.lf.width}x{self.lf.height} images"
            )
        self.mesh = mesh
        if mesh is not None:
            n_space = mesh.shape["space"]
            if self.lf.height % n_space != 0:
                raise ValueError(
                    f"Image height {self.lf.height} must divide by the mesh "
                    f"space axis ({n_space}) for sharded rendering"
                )
            if self.config.view_count % mesh.shape["view"] != 0:
                raise ValueError(
                    f"view_count {self.config.view_count} must divide by the "
                    f"mesh view axis ({mesh.shape['view']})"
                )
        # One host->device upload of the planar RGB stack (the analogue of
        # loadGPUData, src/interpolator.cu:95-137); replicated over the mesh
        # when sharded rendering is requested. May be dropped (set to None)
        # by a memory-pressured view-batched render and re-uploaded lazily.
        self.images = self._upload()

    # -- device data ------------------------------------------------------

    def _upload(self) -> jnp.ndarray:
        """The device-resident planar stack (replicated over the mesh)."""
        if isinstance(self.lf.images, np.ndarray):
            # Drop the alpha plane and transpose HOST-side: uploading the
            # RGBA stack and slicing on device would make the device peak
            # 1.33x the planar stack the capacity plan counted.
            planar = jnp.asarray(
                np.ascontiguousarray(
                    self.lf.images[..., :3].transpose(0, 3, 1, 2)
                )
            )
        else:
            planar = blend_xla.to_planar(jnp.asarray(self.lf.images))
        if self.mesh is not None:
            from .parallel import mesh as pmesh

            return pmesh.replicate(self.mesh, planar)
        return jax.device_put(planar)

    def _fixed_view_batched_step(
        self,
        plan: capacity.FixedRenderPlan,
        weights_np: np.ndarray,  # [V, G] float32
        fo: jnp.ndarray,  # [G, 2] int32 focused offsets (device)
        method_key: str,
        progress: bool = False,
    ):
        """Build a step() rendering the views in device-sized batches.

        For outputs larger than device memory (e.g. 64 views at 8K =
        5.9 GiB): the stack is shifted once, then each weight-row batch
        blends while the previous batch drains to the host, so at most two
        batch outputs are device-resident. Returns host [V, H, W, 3] uint8
        -- callers must not re-fetch. (New capability: the reference tool
        aborts with a CUDA allocation error on >VRAM outputs,
        src/interpolator.cu:95-137.)
        """
        h, w = self.lf.height, self.lf.width
        v = weights_np.shape[0]
        vb = plan.view_batch
        nb, w_batches = _batch_weights(weights_np, vb, progress)

        def step() -> np.ndarray:
            # The shift is weight-independent: run it once, blend per batch.
            shifted = _shift_stack_jit(self.images, fo)
            return _drain_view_batches(
                nb, vb, v, h, w,
                lambda b: _blend_rows_jit(
                    shifted, w_batches[b], method=method_key
                ),
            )

        return step

    def _allfocus_view_batched_step(
        self,
        plan: capacity.FixedRenderPlan,
        weights_np: np.ndarray,  # [V, G] float32
        offsets_j: jnp.ndarray,  # [G, 2] float32
        ids: np.ndarray,  # [K] int32 focus-view selection
        cfg: RenderConfig,
        *,
        radius: tuple[int, int],
        filter_radius: tuple[int, int],
        pad,
        method_key: str,
        progress: bool = False,
    ):
        """Build a step() -> (host views [V, H, W, 3], device maps [2, H, W])
        rendering the all-focus views in device-sized batches.

        The focus maps and the per-pixel-focus selected stack are both
        view-independent, so each runs once per step (the select per row
        block under `plan.row_block`); only the final contraction
        (reference src/kernels.cu:326/:430) splits into weight-row batches,
        each draining to the host while the next renders.
        blend_selected(select_allfocus(...)) is the same select+blend seam
        the unbatched blend_all_focus computes, so the split is byte-exact
        wherever the contraction sums each value in the same order at every
        batch height: the STD kernel on the GPU always does (a library GEMM
        picks its order by shape; ops/blend_triton.py).
        """
        lf = self.lf
        h, w = lf.height, lf.width
        v = weights_np.shape[0]
        vb = plan.view_batch
        nb, w_batches = _batch_weights(weights_np, vb, progress)
        ids_j = jnp.asarray(ids)
        f = jnp.float32(cfg.focus)
        fr = jnp.float32(cfg.focus_range)

        def block_list(rb: int, pye: int):
            out = []
            for r0 in range(0, h, rb):
                rc = min(rb, h - r0)
                out.append((
                    r0, rc, max(0, pye - r0), max(0, (r0 + rc + pye) - h)
                ))
            return out

        def make_maps():
            if plan.estimate_row_block is None:
                return pipeline.compute_focus_maps(
                    self.images, offsets_j, f, fr, ids_j,
                    radius=radius, filter_radius=filter_radius,
                    steps=cfg.focus_steps, pad=pad,
                    exact_taps=cfg.exact_focus_taps,
                )
            # The estimate's full padded selected-views copy does not fit:
            # estimate block by block (estimate_focus_rows rebuilds each
            # block's pad window; its effective floor is max(pad, radius+1))
            # and assemble + filter the tiny full map on device.
            sel = pipeline.gather_views(self.images, ids_j)
            sel_off = offsets_j[ids_j]
            blks = [
                pipeline.estimate_focus_rows(
                    sel, sel_off, f, fr, r0, radius=radius,
                    steps=cfg.focus_steps, pad=pad,
                    exact_taps=cfg.exact_focus_taps, rc=rc, top=top,
                    bot=bot,
                )
                for r0, rc, top, bot in block_list(
                    plan.estimate_row_block,
                    max(int(pad[1]), int(radius[1]) + 1),
                )
            ]
            return pipeline.assemble_focus_maps(tuple(blks), filter_radius)

        rb = plan.row_block or h
        blocks = [(r0, min(rb, h - r0)) for r0 in range(0, h, rb)]

        def step():
            maps = make_maps()
            out_np = np.empty((v, h, w, 3), np.uint8)
            pending = None  # (batch, r0, rc, device views)

            def drain(item):
                b, r0_, rc_, o = item
                arr = np.asarray(o)
                lo = b * vb
                n = min(v - lo, vb)
                out_np[lo : lo + n, r0_ : r0_ + rc_] = (
                    arr[:n].transpose(0, 2, 3, 1)
                )

            for r0, rc in blocks:
                sel = pipeline.select_allfocus(
                    self.images, offsets_j, maps, f, fr, r0,
                    method=method_key, row_count=rc,
                )
                for b in range(nb):
                    o = pipeline.blend_selected(
                        sel, w_batches[b], method=method_key
                    )
                    if pending is not None:
                        drain(pending)
                    pending = (b, r0, rc, o)
            drain(pending)
            return out_np, maps

        return step

    # -- planning ---------------------------------------------------------

    def _render_step(
        self,
        cfg: RenderConfig,
        method_key: str,
        start_end: np.ndarray,  # the trajectory that picks the focus views
        offsets: np.ndarray,  # [G, 2] float32 around the render's center
        wm: np.ndarray,  # [V', G] float32 fp16-quantized weight rows
        progress: bool,
    ):
        """Plan one render and return (step, host_views).

        `step()` renders views [V', C, H, W] -- or (views, maps [2, H, W])
        when the config uses the focus map -- through the engine the plan
        picked: the mesh, a single pass, or view batches (which return host
        [V', H, W, 3] views, flagged by `host_views`). Capacity is checked
        host-side before any device allocation.
        """
        lf = self.lf
        h, w, v = lf.height, lf.width, wm.shape[0]
        if self.mesh is not None:
            from .parallel import mesh as pmesh

            if v % self.mesh.shape["view"] != 0:
                raise ValueError(
                    f"batched view count {v} must divide by the mesh view "
                    f"axis ({self.mesh.shape['view']})"
                )
            weights = pmesh.shard_weights(self.mesh, jnp.asarray(wm))
            n_view, n_space = self.mesh.shape["view"], self.mesh.shape["space"]
        else:
            weights = jnp.asarray(wm)

        if cfg.uses_focus_map:
            radius = geometry.block_radius(w, h, cfg.pixel_size_factor)
            filter_radius = (
                radius[0] // cfg.filter_radius_divisor,
                radius[1] // cfg.filter_radius_divisor,
            )
            ids = geometry.select_focus_views(
                start_end, lf.cols, lf.rows, cfg.focus_map_views
            )
            pad = focus_ops.shift_pad_bound(
                offsets, cfg.focus, cfg.focus_range, radius, h, w
            )
            offsets_j = jnp.asarray(offsets)
            args = (
                weights, offsets_j, jnp.float32(cfg.focus),
                jnp.float32(cfg.focus_range), jnp.asarray(ids),
            )
            kw = dict(
                method=method_key, radius=radius, filter_radius=filter_radius,
                steps=cfg.focus_steps, pad=pad, exact_taps=cfg.exact_focus_taps,
            )
            if self.mesh is not None:
                # Mesh renders shard the stack by rows instead of view
                # batching, so the single-device plan does not apply -- but
                # the PER-DEVICE arithmetic must still fit.
                capacity.check_capacity(
                    pmesh.allfocus_shard_bytes(
                        n_view, n_space, lf.grid_size, len(ids), 3, h, w, v,
                        radius=radius, pad=pad,
                    )["peak"],
                    "Mesh all-focus render (per device)",
                    hint=capacity.MESH_HINT,
                )
                return (lambda: pmesh.render_all_focus_sharded(
                    self.mesh, self.images, *args, **kw
                )), False
            plan = capacity.plan_allfocus_render(
                lf.grid_size, len(ids), 3, h, w, v, px=pad[0], py=pad[1],
            )
            if plan.batched:
                return self._allfocus_view_batched_step(
                    plan, wm, offsets_j, ids, cfg, radius=radius,
                    filter_radius=filter_radius, pad=pad,
                    method_key=method_key, progress=progress,
                ), True
            return (lambda: pipeline.render_all_focus(
                self.images, *args, **kw
            )), False

        fo = jnp.asarray(geometry.focused_offsets(offsets, cfg.focus))
        if self.mesh is not None:
            capacity.check_capacity(
                pmesh.fixed_shard_bytes(
                    n_view, n_space, lf.grid_size, 3, h, w, v
                ),
                "Mesh fixed-focus render (per device)",
                hint=capacity.MESH_HINT,
            )
            return (lambda: pmesh.render_fixed_sharded(
                self.mesh, self.images, weights, fo, method_key
            )), False
        plan = capacity.plan_fixed_render(lf.grid_size, 3, h, w, v)
        if plan.batched:
            return self._fixed_view_batched_step(
                plan, wm, fo, method_key, progress
            ), True
        return (lambda: pipeline.render_fixed_focus(
            self.images, weights, fo, method=method_key
        )), False

    def _config(self, **overrides) -> tuple[RenderConfig, str]:
        """The call's config (None overrides keep the instance's values)
        and its method key ("STD" or "TEN")."""
        cfg = dataclasses.replace(
            self.config,
            **{k: val for k, val in overrides.items() if val is not None},
        )
        cfg.validate()
        return cfg, "TEN" if cfg.method in ("TEN", "TEN_WM") else "STD"

    @staticmethod
    def _weights(start_end, lf: LightField, cfg: RenderConfig) -> np.ndarray:
        # fp16 weight quantization for parity with the reference
        # (src/interpolator.cu:217-219); accumulation stays float32.
        return geometry.quantize_weights_f16(
            geometry.weight_matrix(
                start_end, lf.cols, lf.rows, cfg.effect, cfg.view_count
            )
        ).astype(np.float32)

    # -- rendering --------------------------------------------------------

    def interpolate(
        self,
        trajectory: str,
        *,
        focus: float = 0.0,
        focus_range: float = 0.0,
        method: str | None = None,
        effect: float | None = None,
        aspect: float | None = None,
        benchmark_runs: int = 0,
        progress: bool = True,
    ) -> RenderResult:
        """Synthesize the novel-view set for one trajectory.

        Mirrors Interpolator::interpolate (src/interpolator.cu:248-297);
        `benchmark_runs > 0` additionally times that many repetitions of the
        render step (the reference always times 100).
        """
        cfg, method_key = self._config(
            focus=focus, focus_range=focus_range, method=method or None,
            effect=effect, aspect=aspect,
        )
        lf = self.lf
        start_end = geometry.parse_trajectory(trajectory, lf.cols_rows)
        offsets = geometry.compute_offsets(
            lf.cols, lf.rows, lf.width, lf.height, cfg.aspect,
            geometry.trajectory_center(start_end),
        )
        if progress and cfg.uses_focus_map:
            print("Estimating focus map...")
        step, host_views = self._render_step(
            cfg, method_key, start_end, offsets,
            self._weights(start_end, lf, cfg), progress,
        )
        out = jax.block_until_ready(step())
        views, maps = out if cfg.uses_focus_map else (out, None)

        run_times: list[float] = []
        if benchmark_runs > 0:
            if progress:
                print("Rendering views...")
            for _ in range(benchmark_runs):
                t0 = time.perf_counter()
                jax.block_until_ready(step())
                run_times.append(time.perf_counter() - t0)
            if progress:
                avg = 1000 * sum(run_times) / len(run_times)
                print(
                    f"Average time of {benchmark_runs} runs: {avg:.3f} ms"
                )

        views_np = (
            views if host_views else _fetch(blend_xla.from_planar(views))
        )
        maps_np = _fetch(maps) if maps is not None else None
        return RenderResult(
            views=views_np, maps=maps_np, run_times_s=run_times, config=cfg
        )

    def render_quilt(
        self,
        trajectory: str,
        *,
        focus: float = 0.0,
        focus_range: float = 0.0,
        method: str | None = None,
        effect: float | None = None,
        aspect: float | None = None,
        cols: int = 5,
        rows: int = 9,
        tile_size: tuple[int, int] | None = None,
        benchmark_runs: int = 0,
        progress: bool = True,
    ) -> QuiltResult:
        """Quilt-ONLY render (Looking Glass 5x9 by default): the full
        render, then on-device assembly of the first cols*rows views.

        Reference flow: render all views, then scripts/viewsToQuilt.sh
        montages the PNGs out of process.
        """
        cfg, _ = self._config(
            focus=focus, focus_range=focus_range, method=method or None,
            effect=effect, aspect=aspect,
        )
        n = cols * rows
        if cfg.view_count < n:
            raise ValueError(
                f"Quilt needs {n} views ({cols}x{rows}), but view_count is "
                f"{cfg.view_count}"
            )
        result = self.interpolate(
            trajectory, focus=focus, focus_range=focus_range,
            method=cfg.method, effect=cfg.effect, aspect=cfg.aspect,
            benchmark_runs=benchmark_runs, progress=progress,
        )
        q = quilt_ops.assemble_quilt(
            jnp.asarray(np.transpose(result.views, (0, 3, 1, 2))),
            cols=cols, rows=rows, tile_size=tile_size,
        )
        return QuiltResult(
            quilt=np.asarray(quilt_ops.to_hwc(q)),
            run_times_s=result.run_times_s, config=cfg,
        )

    def interpolate_batch(
        self,
        trajectories: list[str],
        *,
        focus: float = 0.0,
        focus_range: float = 0.0,
        method: str | None = None,
        effect: float | None = None,
        aspect: float | None = None,
        center_tolerance: float = 0.0,
        progress: bool = True,
    ) -> list[RenderResult]:
        """Render several trajectories in few fused passes.

        The blend is bandwidth-bound on reading the image stack, so stacking
        the trajectories' weight matrices into one [n*V, G] matrix makes the
        extra trajectories nearly free: every source pixel is read once for
        all of them. The per-image shifts depend only on the trajectory
        CENTER, so trajectories are grouped by center and each group renders
        in one fused pass; results come back in the caller's order. When a
        group's stacked output outgrows device memory, the pass falls back
        to view batches (see _fixed_view_batched_step). (No reference
        equivalent -- the CUDA tool renders one trajectory per process.)

        With `focus_range > 0` (all-in-focus), sharing goes further: the
        focus-view selection, disparity maps, and per-pixel-focus selected
        stack all depend only on the group's center, so one estimate + one
        select serve every trajectory in the group and each pays only its
        contraction. Each result carries the group's shared maps.

        `center_tolerance` (grid-cell units, default 0 = off) additionally
        merges groups whose centers lie within that distance of an earlier
        trajectory's center: a serving workload with jittered trajectories
        then pays ONE estimate per cluster instead of one per distinct
        center. This is a documented approximation -- members of a merged
        group render with the FIRST member's center (its offsets, focus
        views, and maps), so their outputs can differ from a solo render;
        sub-0.01 tolerances are visually lossless for typical grids while
        collapsing jitter, but the default keeps exact per-center behavior.
        """
        cfg, method_key = self._config(
            focus=focus, focus_range=focus_range, method=method or None,
            effect=effect, aspect=aspect,
        )
        lf = self.lf

        parsed = [
            geometry.parse_trajectory(t, lf.cols_rows) for t in trajectories
        ]
        centers = np.stack([geometry.trajectory_center(se) for se in parsed])
        # Group indices by (quantized) center; one fused pass per group.
        groups: dict[tuple, list[int]] = {}
        if center_tolerance > 0.0:
            # Greedy clustering: join the first earlier center within the
            # tolerance (Euclidean, grid-cell units), else found a group.
            reps: list[np.ndarray] = []
            for i, c in enumerate(centers):
                for gi, rep in enumerate(reps):
                    if float(np.hypot(*(c - rep))) <= center_tolerance:
                        groups[(gi,)].append(i)
                        break
                else:
                    groups[(len(reps),)] = [i]
                    reps.append(c)
        else:
            for i, c in enumerate(centers):
                groups.setdefault(
                    tuple(np.round(c / 1e-5).astype(np.int64)), []
                ).append(i)

        results: list[RenderResult | None] = [None] * len(trajectories)
        v = cfg.view_count
        for idxs in groups.values():
            offsets = geometry.compute_offsets(
                lf.cols, lf.rows, lf.width, lf.height, cfg.aspect,
                centers[idxs[0]],
            )
            big = np.concatenate(
                [self._weights(parsed[i], lf, cfg) for i in idxs], axis=0
            )  # [len(idxs)*V, G]
            # All trajectories of a group share the center, so the
            # focus-view selection, the disparity maps, and the
            # per-pixel-focus selected stack are shared too -- one
            # estimate+select serves the whole group.
            step, host_views = self._render_step(
                cfg, method_key, parsed[idxs[0]], offsets, big, progress
            )
            out = step()
            views, maps = out if cfg.uses_focus_map else (out, None)
            views_np = (
                views if host_views else _fetch(blend_xla.from_planar(views))
            )
            maps_np = _fetch(maps) if maps is not None else None
            for j, i in enumerate(idxs):
                results[i] = RenderResult(
                    views=views_np[j * v : (j + 1) * v],
                    maps=maps_np,  # the group's shared maps (all-focus)
                    run_times_s=[],
                    config=cfg,
                )
        return results  # type: ignore[return-value]


def interpolate(
    input_path: str,
    output_path: str,
    trajectory: str,
    *,
    focus: float = 0.0,
    focus_range: float = 0.0,
    method: str = "STD",
    effect: float = 3.0,
    aspect: float = 1.0,
    benchmark_runs: int = 0,
    progress: bool = True,
) -> RenderResult:
    """One-shot convenience wrapper matching the reference CLI's behavior."""
    interp = Interpolator(
        input_path,
        config=RenderConfig(method=method, effect=effect, aspect=aspect),
        progress=progress,
    )
    result = interp.interpolate(
        trajectory,
        focus=focus,
        focus_range=focus_range,
        benchmark_runs=benchmark_runs,
        progress=progress,
    )
    result.save(output_path, progress=progress)
    return result
