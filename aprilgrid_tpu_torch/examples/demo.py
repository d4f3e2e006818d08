"""Demo: detect AprilGrid tags over a directory of frames and write a
timeline of overlay images (the reference's examples/demo.rs, with PNG
overlays + a JSONL manifest in place of rerun.io streams).

Per frame, like the reference demo: the detection overlay with per-tag
deterministic colors, the public decode_positions sample points
(examples/demo.rs:83-89), and a timeline timestamp — a nanosecond stamp
parsed from the filename when numeric, else a synthetic 60 fps clock
(examples/demo.rs:53-78). ``detect_ms`` is the wall time of ``detect``;
on the card the first frame's includes the kernels' first-use build and
warm-up.

Usage: python3 -m aprilgrid_tpu_torch.examples.demo [--dir tests/data]
       [--out DIR] [--family t36h11] [--mode hybrid|xla] [--turbo]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time
from pathlib import Path


def _timeline_ns(path: Path, index: int) -> int:
    """Filename-ns timeline, synthetic 60 fps fallback
    (reference examples/demo.rs:53-78)."""
    stem = path.stem
    if stem.isdigit():
        return int(stem)
    return int(index * 1e9 / 60)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", default="tests/data")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "aprilgrid_demo"))
    p.add_argument("--family", default="t36h11")
    p.add_argument("--mode", default="hybrid", choices=["hybrid", "xla"])
    p.add_argument(
        "--turbo", action="store_true",
        help="approximate decimated mode (auto policy: >= 2 MP frames "
             "detect at half resolution with full-res corner re-refine)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from PIL import Image

    from aprilgrid_tpu_torch import TagDetector, get_family
    from aprilgrid_tpu_torch.ops.decode import decode_positions_px
    from aprilgrid_tpu_torch.utils.images import load_image
    from aprilgrid_tpu_torch.viz import dump_overlay, write_timeline_html

    det = TagDetector(
        args.family, mode=args.mode, device=args.device,
        decimate="auto" if args.turbo else False,
    )
    spec = get_family(args.family)
    frames = sorted(glob.glob(os.path.join(args.dir, "*.png")))
    os.makedirs(args.out, exist_ok=True)
    manifest = Path(args.out) / "manifest.jsonl"
    entries = []
    with open(manifest, "w") as mf:
        for i, f in enumerate(frames):
            img = load_image(f)
            h, w = img.shape[:2]
            t0 = time.time()
            tags = det.detect(img)
            dt = time.time() - t0
            saddles = det.refined_saddle_points(img)
            # per-tag decode sample points, as the reference demo overlays
            decode_points = {}
            for tid, corners in tags.items():
                pts = decode_positions_px(corners, spec, 0.5, w, h)
                if pts is not None:
                    decode_points[tid] = [tuple(q) for q in pts]
            ns = _timeline_ns(Path(f), i)
            out = Path(args.out) / (Path(f).stem + "_overlay.png")
            dump_overlay(out, img, tags=tags, decode_points=decode_points)
            # raw frame copy for the interactive viewer's base layer
            raw_name = Path(f).stem + "_raw.png"
            base = img if img.ndim == 3 else (
                (img // 257).astype("uint8") if img.dtype.name == "uint16"
                else img
            )
            Image.fromarray(base).save(Path(args.out) / raw_name)
            entries.append(
                {
                    "image": raw_name,
                    "timeline_ns": ns,
                    "detect_ms": round(dt * 1e3, 2),
                    "tags": {
                        int(t): [[float(x), float(y)] for (x, y) in c]
                        for t, c in tags.items()
                    },
                    "decode_points": {
                        int(t): [[float(x), float(y)] for (x, y) in p]
                        for t, p in decode_points.items()
                    },
                    "saddles": [
                        [float(s.p[0]), float(s.p[1]), float(s.theta)]
                        for s in saddles
                    ],
                }
            )
            mf.write(
                json.dumps(
                    {
                        "frame": Path(f).name,
                        "timeline_ns": ns,
                        "n_tags": len(tags),
                        "detect_ms": round(dt * 1e3, 2),
                        "overlay": str(out),
                    }
                )
                + "\n"
            )
            print(
                f"[{ns} ns] {Path(f).name}: {len(tags)} tags in "
                f"{dt*1000:.1f} ms -> {out}"
            )
    html = write_timeline_html(args.out, entries)
    print(f"timeline manifest: {manifest}")
    print(f"interactive timeline: {html} (open in a browser; scrub/play, "
          "toggle tag/decode/saddle layers)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
