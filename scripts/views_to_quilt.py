#!/usr/bin/env python
"""Assemble a directory of views into a Looking Glass quilt
(reference: scripts/viewsToQuilt.sh -- 5x9 montage of 1920x1080 tiles).

Usage: views_to_quilt.py VIEW_DIR [OUT.png] [--cols 5] [--rows 9] [--tile WxH]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("view_dir")
    p.add_argument("out", nargs="?", default=None)
    p.add_argument("--cols", type=int, default=5)
    p.add_argument("--rows", type=int, default=9)
    p.add_argument("--tile", default=None, help="WxH per-tile resize (e.g. 1920x1080)")
    args = p.parse_args()

    import jax.numpy as jnp
    from lfinterpolator_tpu.io import codec, writer
    from lfinterpolator_tpu.ops import quilt
    from lfinterpolator_tpu.utils import compile_cache

    compile_cache.enable()

    names = sorted(
        n for n in os.listdir(args.view_dir)
        if n.lower().endswith(".png") and not n.startswith(("map", "quilt"))
    )
    need = args.cols * args.rows
    if len(names) < need:
        print(f"Need {need} views, found {len(names)}", file=sys.stderr)
        return 1
    views = np.stack(
        [codec.decode(os.path.join(args.view_dir, n))[:, :, :3] for n in names[:need]]
    )
    tile_size = None
    if args.tile:
        w, h = (int(x) for x in args.tile.lower().split("x"))
        tile_size = (h, w)
    q = quilt.assemble_quilt(
        jnp.asarray(np.transpose(views, (0, 3, 1, 2))),
        cols=args.cols, rows=args.rows, tile_size=tile_size,
    )
    out = args.out or os.path.join(args.view_dir, "quilt.png")
    writer.write_quilt(out, np.asarray(quilt.to_hwc(q)))
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
