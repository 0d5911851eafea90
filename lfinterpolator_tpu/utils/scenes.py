"""Synthetic evaluation scenes, host-side and seeded.

The reference's regression harness runs on five real captured scenes
(reference: scripts/focusMapCompare.sh:1-5, inputs from lfStreaming) that are
not available here. The bench/gate scenes were plain multi-plane depth BANDS
(bench.py `_structured_scene`, scripts/bench_8k.build_scene) -- real signal
for the disparity sweep, but no occlusion: every pixel is visible at its own
depth in every camera. Real light fields are not like that, and the
map-dependent stages are content-sensitive.

`make_occlusion_scene` builds the missing case: foreground occluders at
distinct disparities composited over a background plane, back to front, each
layer (texture AND its occluder mask) shifting per camera with its own
disparity. Pixels near occluder borders are therefore seen by some cameras
and hidden in others -- true parallax occlusion, the content the dispersion
cost and the per-pixel-focus blend face on captured data. In occluded
bands the disparity sweep has NO candidate that aligns all views, so the
estimate there is decided by the cost tie-breaking -- exactly the regime the
synthetic band scenes never exercised.
"""

from __future__ import annotations

import numpy as np


def occlusion_foci(focus: float = 0.1, focus_range: float = 0.3,
                   steps: int = 32) -> tuple[float, float, float]:
    """(background, mid, near) focus values ON the candidate grid of the
    given sweep (k = 0, 13, 26), so the estimate can lock the planes
    exactly -- off-grid planes leave a shallow minimum that truncation
    noise wins (bench.py `_structured_scene`'s measured lesson)."""
    step = focus_range / (steps - 1)
    return (focus + 0 * step, focus + 13 * step, focus + 26 * step)


def make_occlusion_scene(
    cols: int,
    rows: int,
    h: int,
    w: int,
    *,
    plane_foci: tuple[float, ...] | None = None,
    n_occluders: tuple[int, ...] = (4, 3),
    seed: int = 7,
    occluder_shift: tuple[float, float] = (0.0, 0.0),
) -> np.ndarray:
    """Parallax-occlusion light field -> [cols*rows, h, w, 4] uint8.

    `plane_foci[0]` is the full-frame background; each later focus value is
    a nearer layer of `n_occluders[i]` opaque rectangles/ellipses (~1/5 to
    1/3 of the frame height each) composited on top. Layer disparity
    follows the compute_offsets scale (a plane at focus f shifts
    f * w/cols px per grid cell in x, f * w/rows in y, aspect 1), the same
    mapping `_structured_scene` uses, so the layers land inside the swept
    focus window. Pure seeded numpy: the CPU oracle rebuilds it exactly.

    `occluder_shift` = (dy, dx) px added to every occluder center: a fixed
    seed plus a per-frame shift animates the occluders drifting over the
    background -- the DEPTH STRUCTURE changes frame to frame, the case that
    stresses `--map-refresh`'s stale maps (a pure camera pan under a static
    depth map would not).
    """
    if plane_foci is None:
        plane_foci = occlusion_foci()
    if len(n_occluders) != len(plane_foci) - 1:
        raise ValueError("need one occluder count per foreground layer")
    rng = np.random.default_rng(seed)
    dpx = [f * w / cols for f in plane_foci]
    dpy = [f * w / rows for f in plane_foci]
    maxp = max((cols - 1) / 2, (rows - 1) / 2)
    m = int(np.ceil(maxp * max(dpx + dpy))) + 8
    hc, wc = h + 2 * m, w + 2 * m

    def smooth_tex() -> np.ndarray:
        t = rng.integers(0, 256, (hc, wc, 3)).astype(np.float32)
        t = (t + np.roll(t, 1, 0) + np.roll(t, 1, 1) + np.roll(t, 2, 0)) / 4
        return t.astype(np.uint8)

    textures = [smooth_tex() for _ in plane_foci]

    yy, xx = np.mgrid[0:hc, 0:wc]
    masks: list[np.ndarray | None] = [None]
    for li in range(1, len(plane_foci)):
        mask = np.zeros((hc, wc), bool)
        for j in range(n_occluders[li - 1]):
            cy = m + int(rng.integers(0, h)) + int(round(occluder_shift[0]))
            cx = m + int(rng.integers(0, w)) + int(round(occluder_shift[1]))
            ry_ = int(rng.integers(h // 10, h // 6 + 1))
            rx_ = int(rng.integers(h // 10, h // 5 + 1))
            if (li + j) % 2 == 0:  # rectangle
                mask[
                    max(0, cy - ry_) : cy + ry_, max(0, cx - rx_) : cx + rx_
                ] = True
            else:  # ellipse
                mask |= ((yy - cy) / ry_) ** 2 + ((xx - cx) / rx_) ** 2 <= 1.0
        masks.append(mask)

    out = np.zeros((cols * rows, h, w, 4), np.uint8)
    out[..., 3] = 255
    for c in range(cols):
        for r in range(rows):
            px_, py_ = c - (cols - 1) / 2, r - (rows - 1) / 2

            def window(arr: np.ndarray, li: int) -> np.ndarray:
                dx = int(round(px_ * dpx[li])) + m
                dy = int(round(py_ * dpy[li])) + m
                return arr[dy : dy + h, dx : dx + w]

            img = window(textures[0], 0).copy()
            for li in range(1, len(plane_foci)):  # back to front
                mk = window(masks[li], li)
                img[mk] = window(textures[li], li)[mk]
            out[c * rows + r, :, :, :3] = img
    return out
