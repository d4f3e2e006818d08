"""Develop: debug harness visualizing pipeline intermediates for one
image (the reference's examples/develop.rs) — refined saddles with
orientation ticks, board quads, and decoded tags.

Usage: python3 -m aprilgrid_tpu_torch.examples.develop tests/data/EuRoC.png
       [--out PATH] [--family t36h11] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("image")
    p.add_argument("--out",
                   default=os.path.join(tempfile.gettempdir(), "aprilgrid_develop.png"))
    p.add_argument("--family", default="t36h11")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from aprilgrid_tpu_torch import TagDetector, native
    from aprilgrid_tpu_torch.utils.images import load_image
    from aprilgrid_tpu_torch.viz import dump_overlay

    det = TagDetector(args.family, device=args.device)
    img = load_image(args.image)
    saddles = det.refined_saddle_points(img)
    print(f"refined saddles: {len(saddles)}")

    px = np.array([s.p[0] for s in saddles], np.float32)
    py = np.array([s.p[1] for s in saddles], np.float32)
    th = np.array([s.theta for s in saddles], np.float32)
    quads = native.find_board(px, py, th, np.ones(len(saddles), np.uint8))
    print(f"board quads: {len(quads)}")

    tags = det.detect(img)
    print(f"decoded tags: {len(tags)}")

    out = dump_overlay(args.out, img, tags=tags, saddles=saddles)
    print(f"overlay -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
