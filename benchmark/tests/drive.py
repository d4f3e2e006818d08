"""Drive a cell through ``harness.run_cell`` on the CPU, the detector sound
or broken underneath, and print one JSON line a run (the tests' helper;
the look for a card is skipped).

    python3 <root>/benchmark/tests/drive.py <workload> <seed> <seconds> <trace> [fault ...]

``<root>`` is the checkout whose benchmark and program run. Each fault
breaks the timed path in one way the comparison has to catch (``sound``
breaks nothing):

* ``stale``: every call returns the previous call's results (a step that
  returns its state unchanged);
* ``half_missing``: a call detects the first half of its frames and returns
  only their results;
* ``half_empty``: the same, with empty results for the second half;
* ``id_altered``: the decode's first row of every frame gets another tag
  ID where the decode produces it;
* ``corner_altered``: that row's first corner moves by 0.25 px on x where
  the decode produces it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


class Faulty:
    """A ``TagDetector`` with one fault."""

    def __init__(self, det, fault: str):
        self.det, self.fault, self.prev = det, fault, None
        if fault in ("id_altered", "corner_altered"):
            decode = det._decode

            def altered(*args, **kwargs):
                out = decode(*args, **kwargs).clone()
                if fault == "id_altered":
                    out[:, 0, 0] += 1.0
                else:
                    out[:, 0, 2] += 0.25
                return out

            det._decode = altered

    @property
    def last_timeline(self):
        return self.det.last_timeline

    def detect_batch(self, frames):
        if self.fault in ("half_missing", "half_empty"):
            half = max(1, len(frames) // 2)
            res = self.det.detect_batch(frames[:half])
            return res if self.fault == "half_missing" else res + [{} for _ in frames[half:]]
        res = self.det.detect_batch(frames)
        if self.fault == "stale":
            res, self.prev = (self.prev if self.prev is not None else res), res
        return res


def main(argv) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(2)
    from aprilgrid_tpu_torch import TagDetector
    from benchmark import harness

    workload, seed, seconds, trace = argv[0], int(argv[1]), float(argv[2]), bool(int(argv[3]))
    for fault in argv[4:] or ["sound"]:
        def factory(fam, params, device, fault=fault):
            det = TagDetector(fam, params=params, device=device)
            return det if fault == "sound" else Faulty(det, fault)

        out = harness.run_cell(workload, seed, seconds, trace, device="cpu",
                               detector_factory=factory, reference_workers=2)
        out["fault"] = fault
        out["forbidden"] = harness.forbidden_modules()
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
