"""Command-line interface with the reference's exact flag surface.

Reference: src/main.cpp:4-57. Flags:
  -i  input folder of grid images named column_row.extension   (required)
  -t  trajectory "startCol,startRow,endCol,endRow" normalized  (required)
  -o  output path                                              (required)
  -m  interpolation method: STD | TEN_WM (alias TEN)           (required)
  -f  focusing value (default 0)
  -r  focusing range (>0 produces the all-in-focus result)
  -s  amount of the spatial 3D effect (default 3.0)
  -a  aspect ratio of camera grid spacing (default 1)

Extensions beyond the reference:
  -b/--bench-runs N   time N repetitions of the render step and print the
                      average (the reference always times 100)
  --quilt             also write a 5x9 quilt.png (viewsToQuilt.sh equivalent)
  --quilt-only        write ONLY quilt.png (no per-view PNGs)
  --json              print a machine-readable summary line
  --reference-order   reproduce the reference binary's transposed grid
                      placement (src/lfLoader.cpp:64) for output comparisons
"""

from __future__ import annotations

import argparse
import json
import sys

HELP_TEXT = """Usage:
Example: lfi-interpolate -i /MyAmazingMachine/thoseImages -t 0.0,0.0,1.0,1.0 -o ./outputs -m STD
-o - output path
-i - folder with lf grid images - named as column_row.extension, e.g. 01_12.jpg
-t - trajectory of the camera in normalized coordinates of the grid format: startCol,startRow,endCol,endRow
-s - the amount of the spatial 3D effect - affects how much are views close to the virtual one prioritized (default=3.0)
-a - aspect ratio of the spacing of the capturing cameras in the grid (horizontal/vertical space) (default=1)
-m - interpolation method:
     STD - float32 blend
     TEN_WM - fp16 tensor-core blend with float32 accumulation
The following arguments are normalized offsets of the images in shift & sum
-f - focusing value (default=0)
-r - focusing range (will be added to the focusing value) - will produce all-focused result if used
-b - number of timed benchmark repetitions of the render step (default=0)
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lfi-interpolate", add_help=False, usage=argparse.SUPPRESS
    )
    p.add_argument("-h", "--help", action="store_true", dest="help")
    p.add_argument("-i", dest="input")
    p.add_argument("-t", dest="trajectory")
    p.add_argument("-o", dest="output")
    p.add_argument("-m", dest="method")
    p.add_argument("-f", dest="focus", type=float, default=0.0)
    p.add_argument("-r", dest="range", type=float, default=0.0)
    p.add_argument("-s", dest="effect", type=float, default=3.0)
    p.add_argument("-a", dest="aspect", type=float, default=1.0)
    p.add_argument("-b", "--bench-runs", dest="bench_runs", type=int, default=0)
    p.add_argument(
        "--focus-views", dest="focus_views", type=int, default=32,
        help="views used by the focus search (reference hard-codes 32)",
    )
    p.add_argument(
        "--fast-focus", action="store_true",
        help="approximate focus tap rule: truncates each stencil tap at its "
             "own position, which may flip the chosen focus level in a "
             "narrow band at per-view coordinate sign changes (44.3 dB vs "
             "the exact oracle on the structured bench scene)",
    )
    p.add_argument(
        "--reference-order", action="store_true",
        help="reproduce the reference binary's transposed grid placement "
             "(src/lfLoader.cpp:64) for side-by-side output comparisons",
    )
    p.add_argument("--quilt", action="store_true")
    p.add_argument(
        "--quilt-only", action="store_true",
        help="write ONLY quilt.png (no per-view PNGs)",
    )
    p.add_argument(
        "--quilt-tile", dest="quilt_tile", metavar="HxW", default=None,
        help="resize quilt tiles to HxW (e.g. 1080x1920); default keeps the "
             "native view resolution",
    )
    p.add_argument(
        "--quilt-reference", action="store_true",
        help="write the quilt at the reference script's exact geometry: 5x9 "
             "tiles resized to 1080x1920 (scripts/viewsToQuilt.sh:2); "
             "implies --quilt",
    )
    p.add_argument("--json", action="store_true", dest="json_out")
    p.add_argument("--no-progress", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.help:
        print(HELP_TEXT)
        return 0
    if not (args.input and args.trajectory and args.output and args.method):
        print("Missing required parameters. Use -h for help.", file=sys.stderr)
        return 1

    # Imports deferred so `-h` stays instant (no jax init).
    from .api import Interpolator
    from .core import geometry
    from .core.config import RenderConfig
    from .io.loader import load_light_field
    from .utils import compile_cache

    compile_cache.enable()

    progress = not args.no_progress and not args.json_out
    # Validate quilt geometry BEFORE the render: a bad --quilt-tile must
    # fail in milliseconds, not after minutes of rendering.
    quilt_tile = (1080, 1920) if args.quilt_reference else None
    if args.quilt_tile:
        try:
            th, tw = (int(x) for x in args.quilt_tile.split("x"))
            if th <= 0 or tw <= 0:
                raise ValueError(args.quilt_tile)
        except ValueError:
            print(f"Bad --quilt-tile {args.quilt_tile!r}; expected "
                  "HxW with positive sizes, e.g. 1080x1920", file=sys.stderr)
            return 1
        quilt_tile = (th, tw)
    try:
        # Validate the method and trajectory format BEFORE the (slow) grid
        # load + device upload: a typo'd -m or -t must fail in milliseconds.
        config = RenderConfig(
            method=args.method, effect=args.effect, aspect=args.aspect,
            focus_map_views=args.focus_views,
            exact_focus_taps=not args.fast_focus,
        )
        config.validate()
        geometry.parse_trajectory(args.trajectory, (2, 2))  # format check
        source = (
            load_light_field(
                args.input, progress=progress, reference_order=True
            )
            if args.reference_order
            else args.input
        )
        interp = Interpolator(source, config=config, progress=progress)
        if args.quilt_only:
            qres = interp.render_quilt(
                args.trajectory,
                focus=args.focus,
                focus_range=args.range,
                tile_size=quilt_tile,
                benchmark_runs=args.bench_runs,
                progress=progress,
            )
            written = [qres.save(f"{args.output}/quilt.png")]
            if args.json_out:
                print(
                    json.dumps(
                        {
                            "quilt": [
                                int(qres.quilt.shape[1]),
                                int(qres.quilt.shape[0]),
                            ],
                            "method": qres.config.method,
                            "avg_ms": qres.avg_ms,
                            "files_written": len(written),
                        }
                    )
                )
            return 0
        result = interp.interpolate(
            args.trajectory,
            focus=args.focus,
            focus_range=args.range,
            benchmark_runs=args.bench_runs,
            progress=progress,
        )
        written = result.save(args.output, progress=progress)
        if args.quilt or args.quilt_reference or args.quilt_tile:
            if result.views.shape[0] >= 45:
                written.append(result.save_quilt(
                    f"{args.output}/quilt.png", tile_size=quilt_tile
                ))
            else:
                print("Quilt skipped: needs >= 45 views", file=sys.stderr)
        if args.json_out:
            print(
                json.dumps(
                    {
                        "views": int(result.views.shape[0]),
                        "resolution": [
                            int(result.views.shape[2]),
                            int(result.views.shape[1]),
                        ],
                        "method": result.config.method,
                        "avg_ms": result.avg_ms,
                        "megapixels_per_s": result.megapixels_per_s,
                        "files_written": len(written),
                    }
                )
            )
    except (ValueError, FileNotFoundError, NotADirectoryError, RuntimeError) as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `lfi-interpolate -h | head`
        sys.exit(0)
