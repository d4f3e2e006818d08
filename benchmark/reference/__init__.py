"""The benchmark's plain reference: a frozen copy of the JAX package's NumPy
oracle (``numpy_ref.py``, numpy and scipy only) with its default
parameters and t36h11 table (``config.py``), and the control (``control.py``):
the same reference with its front-end planes in bfloat16. Nothing here
imports the detector under test or the JAX package.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path


def detect(frame, family: str, max_num_of_boards: int, control: bool = False) -> dict:
    """The reference's detections of one frame as ``{tag id: [(x, y) x 4]}``
    in Python floats; ``control`` runs the bfloat16 control instead."""
    from .config import DetectorParams
    from .numpy_ref import TagDetector

    params = DetectorParams(max_num_of_boards=int(max_num_of_boards))
    if control:
        from .control import ControlDetector as TagDetector  # noqa: F811
    tags = TagDetector(family, params).detect(frame)
    return {int(t): [(float(x), float(y)) for x, y in c] for t, c in tags.items()}


def detect_pool(frames, family: str, max_num_of_boards: int, control: bool = False,
                workers: int | None = None) -> list[dict]:
    """``detect`` over ``frames`` in worker processes (one a host core, at
    most one a frame; frame ``i`` to worker ``i % n``), each a
    ``python -m benchmark.reference.worker`` fed and read through its pipes,
    all waited for before it returns. Pipes only: no shared memory, no
    semaphore, no helper process."""
    from concurrent.futures import ThreadPoolExecutor

    n = max(1, min(len(frames), workers or os.cpu_count() or 1))
    if n == 1:
        return [detect(f, family, max_num_of_boards, control) for f in frames]
    root = Path(__file__).resolve().parents[2]
    shares = [list(range(i, len(frames), n)) for i in range(n)]
    procs = [subprocess.Popen([sys.executable, "-m", "benchmark.reference.worker"],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=root)
             for _ in shares]
    try:
        with ThreadPoolExecutor(max_workers=n) as ex:
            outs = list(ex.map(
                lambda ps: ps[0].communicate(pickle.dumps(
                    ([frames[i] for i in ps[1]], family, max_num_of_boards, control)))[0],
                zip(procs, shares)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    found: list = [None] * len(frames)
    for p, share, out in zip(procs, shares, outs):
        if p.returncode != 0:
            raise RuntimeError(f"a reference worker exited with {p.returncode}")
        for i, r in zip(share, pickle.loads(out)):
            found[i] = r
    return found
