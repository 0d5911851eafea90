#!/usr/bin/env python
"""Render a video light field: a directory of per-frame camera grids.

Input layout:   ROOT/<frame>/<col_row.ext>   (frames sorted by name)
Output layout:  OUT/frame_%05d/00.png..NN.png

Drives lfinterpolator_tpu.streaming.StreamingRenderer: frame decode runs in a
prefetch thread, device upload of frame t+1 overlaps the render of frame t,
and PNG writes run in a background pool. --resume skips frames whose output
directory is already complete (writes are atomic).

Usage: render_video.py -i ROOT -o OUT -t 0,0,1,1 [-m TEN_WM] [-f 0.2]
       [-s 3] [-a 1] [--resume] [--limit N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-i", dest="input", required=True)
    p.add_argument("-o", dest="output", required=True)
    p.add_argument("-t", dest="trajectory", required=True)
    p.add_argument("-m", dest="method", default="TEN_WM")
    p.add_argument("-f", dest="focus", type=float, default=0.0)
    p.add_argument("-s", dest="effect", type=float, default=3.0)
    p.add_argument("-a", dest="aspect", type=float, default=1.0)
    p.add_argument("-r", dest="focus_range", type=float, default=0.0,
                   help="focus range; >0 renders all-in-focus per frame")
    p.add_argument("--focus-views", type=int, default=32,
                   help="views used by the focus search")
    p.add_argument("--fast-focus", action="store_true",
                   help="~5x faster, approximate focus estimation")
    p.add_argument(
        "--map-refresh", type=int, default=1, metavar="N",
        help="re-estimate the focus maps every N frames and reuse them in "
             "between (video depth changes slowly; N>1 is approximate)",
    )
    p.add_argument("--resume", action="store_true")
    p.add_argument("--limit", type=int, default=0)
    args = p.parse_args()

    from lfinterpolator_tpu.core.config import RenderConfig
    from lfinterpolator_tpu.io import loader
    from lfinterpolator_tpu.streaming import StreamingRenderer
    from lfinterpolator_tpu.utils import compile_cache

    compile_cache.enable()

    frame_dirs = sorted(
        os.path.join(args.input, d)
        for d in os.listdir(args.input)
        if os.path.isdir(os.path.join(args.input, d))
    )
    if not frame_dirs:
        print(f"No frame directories under {args.input}", file=sys.stderr)
        return 1
    if args.limit:
        frame_dirs = frame_dirs[: args.limit]

    first = loader.load_light_field(frame_dirs[0], progress=False)
    print(
        f"{len(frame_dirs)} frames, {first.cols}x{first.rows} grid of "
        f"{first.width}x{first.height} images"
    )

    def _load(d):
        lf = loader.load_light_field(d, progress=False)
        if (lf.cols, lf.rows, lf.width, lf.height) != (
            first.cols, first.rows, first.width, first.height
        ):
            raise ValueError(f"Frame {d} geometry differs from frame 0")
        return lf.images

    def frames():
        # thunks: with --resume, complete frames are skipped without decoding
        yield first.images
        for d in frame_dirs[1:]:
            yield lambda d=d: _load(d)

    renderer = StreamingRenderer(
        first.cols, first.rows, first.width, first.height, args.trajectory,
        config=RenderConfig(
            method=args.method, focus=args.focus,
            focus_range=args.focus_range, effect=args.effect,
            aspect=args.aspect, focus_map_views=args.focus_views,
            exact_focus_taps=not args.fast_focus,
            focus_map_refresh=args.map_refresh,
        ),
    )
    stats = renderer.render_to_dir(frames(), args.output, resume=args.resume)
    print(
        f"{stats.frames} frames ({stats.rendered} rendered, "
        f"{stats.skipped} skipped) in {stats.total_s:.1f}s "
        f"({stats.fps:.2f} fps)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
