#!/usr/bin/env python
"""Scene-level regression harness (reference: scripts/focusMapCompare.sh).

For each configured scene, renders the full trajectory with the all-in-focus
path and extracts single-position renders for comparison, writing a
`comparison/` tree (SCENE/ and SCENEC/ per scene) like the reference script.

The canonical five scenes and their parameters come from the reference
(scripts/focusMapCompare.sh:1-5); point --input-root at a directory holding
them (SCENE subdirectories of column_row.ext images).

Usage: focus_map_compare.py --input-root DIR [--out comparison] [--view 0]
       [--scenes name1,name2,...]
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POSITIONS = [0.071, 0.193714, 0.316429, 0.439143, 0.561857, 0.684571, 0.807286, 0.93]
SCENES = {
    # name: (focus_start, focus_end, aspect)   (focusMapCompare.sh:2-5)
    "lowFrequency": (0.0, 0.46, 2.0223),
    "lowDepth": (0.54, 0.09, 2.122),
    "bonfire": (0.06, 0.24, 2.276),
    "cornell": (0.22, 0.17, 1.783),
    "simpleSetting": (0.43, 0.18, 1.8266),
}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--input-root", required=True)
    p.add_argument("--out", default="comparison")
    p.add_argument("--view", type=int, default=0)
    p.add_argument("--scenes", default=",".join(SCENES))
    p.add_argument("--method", default="STD")
    args = p.parse_args()

    from lfinterpolator_tpu.api import interpolate
    from lfinterpolator_tpu.utils import compile_cache

    compile_cache.enable()

    view = args.view
    if not 0 <= view < len(POSITIONS):
        print(f"--view must be 0..{len(POSITIONS) - 1}", file=sys.stderr)
        return 1
    # POSITIONS are 8 uniform samples of the [0.071, 0.93] sweep; the 64-view
    # trajectory hits POSITIONS[i] at sweep view i*9 (63/7 = 9). The reference
    # script hard-pins VIEW=0 with a note that other ids need correction
    # (scripts/focusMapCompare.sh:8-9); this port applies the correction.
    lead = f"{view * 9:02d}"
    pos = POSITIONS[view]
    for scene in args.scenes.split(","):
        if scene not in SCENES:
            print(f"Unknown scene {scene}; known: {list(SCENES)}", file=sys.stderr)
            return 1
        f_start, f_end, aspect = SCENES[scene]
        src = os.path.join(args.input_root, scene)
        if not os.path.isdir(src):
            print(f"Missing scene inputs: {src}", file=sys.stderr)
            return 1
        out_common = os.path.join(args.out, scene + "C")
        out_single = os.path.join(args.out, scene)
        os.makedirs(out_common, exist_ok=True)
        os.makedirs(out_single, exist_ok=True)
        with tempfile.TemporaryDirectory() as tmp:
            # Full trajectory render (-t 0.071,...,0.93 -s 7), extract view.
            interpolate(
                src, tmp, "0.071,0.071,0.93,0.93",
                focus=f_start, focus_range=f_end, method=args.method,
                effect=7.0, aspect=aspect, progress=False,
            )
            shutil.move(
                os.path.join(tmp, f"{lead}.png"),
                os.path.join(out_common, f"{view}.png"),
            )
        with tempfile.TemporaryDirectory() as tmp:
            # Single-position render at the matching trajectory point.
            interpolate(
                src, tmp, f"{pos},{pos},{pos},{pos}",
                focus=f_start, focus_range=f_end, method=args.method,
                effect=7.0, aspect=aspect, progress=False,
            )
            shutil.move(
                os.path.join(tmp, "00.png"),
                os.path.join(out_single, f"{view}.png"),
            )
        print(f"{scene}: wrote {out_common}/{view}.png and {out_single}/{view}.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
