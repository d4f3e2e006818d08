"""The readings that the comparison's limits are set from, in one process a
configuration (its set-up paid once):

    python3 benchmark/calibrate.py --config <name> --seeds <n,n,...> --seconds <s> [--control]

For each seed: the pool, then for every cell of the configuration
(``workloads/*.json`` that name it) a short window at the cell's own load
and the comparison of what it returned with the reference (the sound
runs' readings); with ``--control``, the control (the reference with its
front-end planes in bfloat16, ``reference/control.py``) in the detector's
place on the same pool frames. One JSON line a reading. Needs the card,
as a run does; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness, traffic

    if not torch.cuda.is_available():
        harness.log("no card")
        return 2
    harness.check_program()
    cfg = traffic.load_json("configs", args.config)
    cells = sorted(p.stem for p in (traffic.BENCH / "workloads").glob("*.json")
                   if traffic.load_json("workloads", p.stem)["config"] == args.config)
    det = harness.build_detector(cfg, "cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        pool, _ = traffic.make_pool(cfg, seed, "cuda")
        for cell in cells:
            _, _, tr = harness.load_cell(cell)
            t = harness.Traffic(tr, pool, seed)
            harness.warm_up(det, t, True)
            e2e, win, _ = harness.measure(det, t, args.seconds, False, True)
            cmp = harness.judge(win.kept + win.sampled, win.unanswered, pool, cfg)
            print(json.dumps({"kind": "sound", "workload": cell, "seed": seed,
                              "correct": cmp["correct"], "frames": cmp["frames_compared"],
                              "readings": {k: c["value"] for k, c in cmp["checks"].items()},
                              "e2e": {k: m["value"] for k, m in e2e.items()}}), flush=True)
        if args.control:
            every = [(list(range(len(pool))), [None] * len(pool))]
            t0 = time.perf_counter()
            cmp = harness.judge(every, 0, pool, cfg, control=True)
            print(json.dumps({"kind": "control", "config": args.config, "seed": seed,
                              "correct": cmp["correct"], "frames": cmp["frames_compared"],
                              "readings": {k: c["value"] for k, c in cmp["checks"].items()},
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
