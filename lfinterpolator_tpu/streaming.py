"""Streaming (video) light-field rendering pipeline.

BASELINE.json config 5: render a sequence of light-field frames (e.g. a video
light field) with the host->device transfer of frame t+1 overlapped with the
render of frame t, and PNG writes overlapped with both.

Instead of explicit CUDA streams: JAX dispatch is asynchronous, so the
pipeline is expressed as a small prefetch queue --

    decode thread:  disk -> host uint8 stacks            (CPU, k frames ahead)
    main loop:      device_put(frame t+1); render(frame t)  (overlapped on device)
    writer pool:    device->host fetch + PNG encode       (CPU threads)

Shapes are constant across frames, so every frame reuses the same compiled
render executable.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import queue
import threading
import time
from collections.abc import Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from .core import capacity, geometry
from .core.config import RenderConfig
from .io import writer
from .ops import blend_xla
from .models import pipeline


@dataclasses.dataclass
class StreamStats:
    frames: int  # total accounted for (rendered + skipped)
    total_s: float
    skipped: int = 0  # complete frames skipped by resume

    @property
    def rendered(self) -> int:
        return self.frames - self.skipped

    @property
    def fps(self) -> float:
        """Throughput of the frames actually rendered."""
        return self.rendered / self.total_s if self.total_s > 0 else 0.0


class StreamingRenderer:
    """Fixed-geometry renderer for a sequence of light-field frames.

    `frames` yields [G, H, W, C>=3] uint8 host arrays (all the same shape).
    """

    def __init__(
        self,
        cols: int,
        rows: int,
        width: int,
        height: int,
        trajectory: str,
        *,
        config: RenderConfig | None = None,
        prefetch: int = 2,
    ):
        self.cfg = config or RenderConfig()
        self.cfg.validate()
        self.cols, self.rows = cols, rows
        self.width, self.height = width, height
        self.prefetch = max(1, prefetch)

        start_end = geometry.parse_trajectory(trajectory, (cols, rows))
        wm = geometry.quantize_weights_f16(
            geometry.weight_matrix(
                start_end, cols, rows, self.cfg.effect, self.cfg.view_count
            )
        ).astype(np.float32)
        offsets = geometry.compute_offsets(
            cols, rows, width, height, self.cfg.aspect,
            geometry.trajectory_center(start_end),
        )
        self.weights = jnp.asarray(wm)
        self.focused = jnp.asarray(
            geometry.focused_offsets(offsets, self.cfg.focus)
        )
        self._method = "TEN" if self.cfg.method in ("TEN", "TEN_WM") else "STD"
        self._uses_focus_map = self.cfg.uses_focus_map
        g = cols * rows
        in_b = g * 3 * height * width
        out_b = self.cfg.view_count * 3 * height * width
        if self._uses_focus_map:
            # Per-frame all-focus stream: estimate + filter + per-pixel
            # blend every frame (reference flow per run:
            # src/interpolator.cu:261-266). All bounds are static across
            # frames, so every frame reuses one compiled program.
            from .ops import focus as focus_ops

            cfg = self.cfg
            self._radius = geometry.block_radius(
                width, height, cfg.pixel_size_factor
            )
            self._filter_radius = (
                self._radius[0] // cfg.filter_radius_divisor,
                self._radius[1] // cfg.filter_radius_divisor,
            )
            self._ids = jnp.asarray(
                geometry.select_focus_views(
                    start_end, cols, rows, cfg.focus_map_views
                )
            )
            self._focus_pad = focus_ops.shift_pad_bound(
                offsets, cfg.focus, cfg.focus_range, self._radius,
                height, width,
            )
            self._offsets_j = jnp.asarray(offsets)
            # --map-refresh state: maps re-estimated every N frames (the
            # blend runs outside render_all_focus then)
            self._frame_idx = 0
            self._maps = None
            # The estimate keeps the K selected views, their edge-padded
            # copy and one sweep temporary; the select the gathered stack.
            k = int(self._ids.shape[0])
            pxe = max(self._focus_pad[0], self._radius[0] + 1)
            pye = max(self._focus_pad[1], self._radius[1] + 1)
            sel_b = k * 3 * height * width
            est_b = 2 * sel_b + k * 3 * (height + 2 * pye) * (width + 2 * pxe)
            work_b = max(est_b, 5 * in_b)
        else:
            # shifted stack + the blend's 4-byte widened operand
            work_b = 5 * in_b
        # Host-side lower-bound capacity guard: streaming keeps `prefetch`
        # uploaded frames plus the render's working set and a full view set
        # (with its float32 accumulator) resident, and has no view-batched
        # fallback (use Interpolator for one-shot outputs larger than the
        # device, or a mesh) -- so reject arithmetically certain
        # oversubscription before any device work. There is deliberately no
        # row-blocked streaming arm: it would force prefetch=0, destroying
        # the upload/render overlap that defines this pipeline.
        resident = (self.prefetch + 1) * in_b + work_b + 5 * out_b
        capacity.check_capacity(
            resident,
            f"Streaming {self.cfg.view_count} views per {width}x{height} "
            f"frame from {g} images (prefetch={self.prefetch})",
        )

    def _render(self, images_planar: jnp.ndarray):
        """One frame -> views [V, C, H, W] u8, or (views, maps [2, H, W])
        when the config enables the per-pixel focus map."""
        if not self._uses_focus_map:
            return pipeline.render_fixed_focus(
                images_planar, self.weights, self.focused, method=self._method
            )
        cfg = self.cfg
        if cfg.focus_map_refresh > 1:
            # Temporal map reuse (--map-refresh N): video depth changes
            # slowly, so re-estimate every N frames and blend the
            # in-between frames with the most recent maps. Split at the same
            # maps/blend seam as the view-batched api path; refresh frames
            # are bit-identical to the unsplit render_all_focus by
            # construction.
            if self._frame_idx % cfg.focus_map_refresh == 0:
                self._maps = pipeline.compute_focus_maps(
                    images_planar, self._offsets_j,
                    jnp.float32(cfg.focus),
                    jnp.float32(cfg.focus_range), self._ids,
                    radius=self._radius,
                    filter_radius=self._filter_radius,
                    steps=cfg.focus_steps, pad=self._focus_pad,
                    exact_taps=cfg.exact_focus_taps,
                )
            self._frame_idx += 1
            views = pipeline.blend_all_focus(
                images_planar, self.weights, self._offsets_j,
                self._maps, jnp.float32(cfg.focus),
                jnp.float32(cfg.focus_range), method=self._method,
            )
            return views, self._maps
        return pipeline.render_all_focus(
            images_planar, self.weights, self._offsets_j,
            jnp.float32(cfg.focus), jnp.float32(cfg.focus_range),
            self._ids, method=self._method, radius=self._radius,
            filter_radius=self._filter_radius, steps=cfg.focus_steps,
            pad=self._focus_pad, exact_taps=cfg.exact_focus_taps,
        )

    def _fetch_out(self, out):
        if self._uses_focus_map:
            views, maps = out
            return np.asarray(blend_xla.from_planar(views)), np.asarray(maps)
        return np.asarray(blend_xla.from_planar(out))

    def render_stream(
        self, frames: Iterable[np.ndarray]
    ) -> Iterator[np.ndarray]:
        """Yield [V, H, W, 3] uint8 view stacks, one per input frame --
        or ([V, H, W, 3] views, [2, H, W] maps) tuples when the config
        enables the per-pixel focus map (focus_range > 0).

        Upload of frame t+1 overlaps the device render of frame t (JAX
        dispatch is async); host-side decode runs in a prefetch thread.
        """
        host_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()

        def _feeder():
            try:
                for f in frames:
                    host_q.put(jax.device_put(blend_xla.to_planar(jnp.asarray(f))))
                host_q.put(_SENTINEL)
            except BaseException as e:  # forward to the consumer, don't truncate
                host_q.put(e)

        threading.Thread(target=_feeder, daemon=True).start()

        pending: list = []  # dispatched, not yet fetched
        while True:
            item = host_q.get()
            if isinstance(item, BaseException):
                raise item
            if item is _SENTINEL:
                break
            pending.append(self._render(item))
            # Keep at most `prefetch` renders in flight; fetch the oldest.
            if len(pending) > self.prefetch:
                yield self._fetch_out(pending.pop(0))
        for out in pending:
            yield self._fetch_out(out)

    def render_to_dir(
        self,
        frames: Iterable,
        output_dir: str,
        *,
        writers: int = 4,
        progress: bool = False,
        resume: bool = False,
    ) -> StreamStats:
        """Render a stream and write each frame's views under
        output_dir/frame_%05d/ with a background writer pool.

        `frames` yields uint8 arrays OR zero-arg callables returning them
        (thunks). With `resume=True`, frames whose output directory already
        holds the full view count are skipped (PNG writes are atomic, so a
        complete directory means a complete frame) -- and thunks for skipped
        frames are never invoked, so resumed jobs skip the decode cost too.
        """
        import os

        t0 = time.perf_counter()
        n = 0
        skipped = 0

        v_count = self.cfg.view_count
        digits = max(2, len(str(v_count - 1)))
        expected = [f"{i:0{digits}d}.png" for i in range(v_count)]
        if self._uses_focus_map:
            expected += ["map0.png", "map1.png"]

        def _complete(i: int) -> bool:
            # Check for the exact filenames write_views produces: counting
            # arbitrary *.png would let stray files (a quilt.png, leftovers
            # from a run with a larger view count) mask a partial frame.
            d = f"{output_dir}/frame_{i:05d}"
            return os.path.isdir(d) and all(
                os.path.exists(os.path.join(d, name)) for name in expected
            )

        def _filtered():
            nonlocal skipped
            for i, f in enumerate(frames):
                if resume and _complete(i):
                    skipped += 1
                    yield i, None
                else:
                    yield i, (f() if callable(f) else f)

        with concurrent.futures.ThreadPoolExecutor(max_workers=writers) as pool:
            futures = []
            # Index handoff: render_stream preserves order, and the feeder
            # thread appends an index (GIL-atomic) strictly before the frame
            # can produce an output, so pop(0) pairs outputs with indices.
            pending_idx = []

            def frame_gen():
                for i, f in _filtered():
                    if f is not None:
                        pending_idx.append(i)
                        yield f

            for out in self.render_stream(frame_gen()):
                views, maps = out if self._uses_focus_map else (out, None)
                i = pending_idx.pop(0)
                futures.append(
                    pool.submit(
                        writer.write_views,
                        f"{output_dir}/frame_{i:05d}",
                        views,
                        maps,
                        progress=False,
                    )
                )
                n += 1
            for f in futures:
                f.result()
        return StreamStats(
            frames=n + skipped,
            total_s=time.perf_counter() - t0,
            skipped=skipped,
        )
