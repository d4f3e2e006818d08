"""The comparison that decides ``correct``: the detector's returned frames
against the frozen reference's detections of the same pool frames.

Each kept frame is ``(pool index, {tag id: 4 corners})``. Frames that
returned the same result for one pool frame are compared once (an equal
result gives equal readings), so every kept frame is judged at the cost of
its distinct results. Three numbers, each beside its limit:

* ``frames_unanswered``: frames sent whose result never came (a call that
  returned fewer results than frames); limit 0;
* ``frames_ids_differ``: frames whose set of tag IDs is not the
  reference's; limit 0;
* ``corner_max_px``: the largest distance, on either axis, between a
  corner and the reference's same corner of the same tag, over every kept
  frame; its limit, ``CORNER_LIMIT_PX``, is set from the readings in ``PERF.md``.
"""

from __future__ import annotations

import numpy as np

# corner_max_px's limit, px: sound runs of the detector on the card read
# at most 6.17e-5 (a dozen seeds a configuration and every full set), the
# control (the reference with its front-end planes in bfloat16) at least
# 0.0758 on a dozen seeds a configuration; the limit lies 81x above the
# one and 15x below the other (PERF.md)
CORNER_LIMIT_PX = 0.005


def distinct_results(kept) -> list[list]:
    """Per pool index, ``[result, frames]`` for each distinct result kept."""
    reps: dict[int, list] = {}
    for idxs, results in kept:
        for p, r in zip(idxs, results):
            for rep in reps.setdefault(int(p), []):
                if rep[0] == r:
                    rep[1] += 1
                    break
            else:
                reps[int(p)].append([r, 1])
    return reps


def corner_gap(result: dict, ref: dict) -> float:
    """The largest corner distance on either axis over the tags both hold."""
    common = sorted(set(result) & set(ref))
    if not common:
        return 0.0
    a = np.asarray([result[t] for t in common], np.float64)
    b = np.asarray([ref[t] for t in common], np.float64)
    return float(np.abs(a - b).max())


def compare(kept, refs: dict, unanswered: int, corner_limit: float = CORNER_LIMIT_PX) -> dict:
    """The readings of the kept frames against ``refs`` (pool index ->
    the reference's result), each as ``{"value", "limit"}``, and
    ``frames_compared``."""
    ids_differ, gap, n = 0, 0.0, 0
    for p, reps in distinct_results(kept).items():
        ref = refs[p]
        for result, frames in reps:
            n += frames
            if set(result) != set(ref):
                ids_differ += frames
            gap = max(gap, corner_gap(result, ref))
    return {
        "frames_compared": n,
        "checks": {
            "frames_unanswered": {"value": int(unanswered), "limit": 0},
            "frames_ids_differ": {"value": ids_differ, "limit": 0},
            "corner_max_px": {"value": gap, "limit": corner_limit},
        },
    }


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
