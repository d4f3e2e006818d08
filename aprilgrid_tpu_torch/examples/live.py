"""Live detection viewer — the reference's rerun streaming demo, served
over plain HTTP/MJPEG (reference: examples/demo.rs streams image +
saddles + tag corners + decode points to rerun.io;
``aprilgrid_tpu_torch.live`` provides the dependency-free equivalent).

Loops over the images in --dir (simulating a camera), detects on each,
and publishes every frame with all overlay layers. Open the printed URL
in a browser to watch; /latest.jpg and /state.json serve headless
consumers. ``--port 0`` serves on a free port, which the URL names.

Usage: python3 -m aprilgrid_tpu_torch.examples.live [--dir tests/data]
       [--port 8000] [--loops N]  (N=0: stream forever) [--fps 2]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
from PIL import Image


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="tests/data")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--loops", type=int, default=0)
    ap.add_argument("--fps", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from aprilgrid_tpu_torch import TagDetector
    from aprilgrid_tpu_torch.live import LiveStream

    det = TagDetector("t36h11", device=args.device)
    stream = LiveStream(port=args.port).start()
    print(f"live viewer: http://127.0.0.1:{stream.port}/", flush=True)

    paths = sorted(Path(args.dir).glob("*.png"))
    loops = 0
    try:
        while args.loops == 0 or loops < args.loops:
            for p in paths:
                img = np.asarray(Image.open(p))
                t0 = time.time()
                tags = det.detect(img)
                saddles = det.refined_saddle_points(img)
                stream.publish(img, tags=tags, saddles=saddles)
                dt = time.time() - t0
                print(
                    f"{p.name}: {len(tags)} tags, {len(saddles)} saddles, "
                    f"{dt * 1e3:.0f} ms",
                    flush=True,
                )
                time.sleep(max(0.0, 1.0 / args.fps - dt))
            loops += 1
    finally:
        stream.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
