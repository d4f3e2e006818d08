"""The traffic generator (``traffic.py``) on the CPU: pools from seeds,
their composition, shapes and dtypes, the closed loop's batches, and the
frames the window keeps for the comparison."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

from benchmark import harness, traffic

SEED = 2**32 + 11   # past 32 signed bits: seeds may be that large


@pytest.fixture(scope="module")
def euroc():
    return traffic.load_json("configs", "euroc-stereo")


@pytest.fixture(scope="module")
def phone():
    return traffic.load_json("configs", "phone1080-rgb")


def test_same_seed_same_pool_other_seed_other_pool(euroc):
    a, pa = traffic.make_pool(euroc, SEED)
    b, pb = traffic.make_pool(euroc, SEED)
    c, pc = traffic.make_pool(euroc, SEED + 1)
    assert np.array_equal(a, b) and pa == pb
    assert not np.array_equal(a, c) and pa != pc
    # 16 distinct frames
    assert len({f.tobytes() for f in a}) == 16


def test_pool_shapes_dtypes_and_jitter(euroc, phone):
    pool, params = traffic.make_pool(euroc, SEED)
    assert pool.shape == (16, 480, 752) and pool.dtype == np.uint8
    assert all(p["capture"] == 0 for p in params)
    pool, params = traffic.make_pool(phone, SEED)
    assert pool.shape == (16, 1080, 1920, 3) and pool.dtype == np.uint8
    assert [p["capture"] for p in params] == [0] * 8 + [1] * 8
    for p in params:
        assert -32 <= p["dy"] <= 32 and -32 <= p["dx"] <= 32 and 0.85 <= p["gain"] <= 1.0


def test_pool_frame_is_the_jittered_capture(euroc):
    pool, params = traffic.make_pool(euroc, SEED)
    cap = traffic.load_capture(euroc["captures"][0]).astype(np.float64)
    p = params[0]
    h, w = cap.shape
    dy, dx = p["dy"], p["dx"]
    inner = pool[0][max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)].astype(np.float64)
    src = cap[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)] * p["gain"]
    resid = (inner - src)[(src > 8) & (src < 240)]   # away from the clipped ends
    assert abs(resid.mean()) < 0.1 and 1.9 < resid.std() < 2.2   # sigma 2 DN, rounded
    med = np.median(cap)
    if dy > 0:
        border = pool[0][:dy].astype(np.float64)
        assert abs(border.mean() - med * p["gain"]) < 0.5


def test_closed_batches_hold_every_pool_frame_equally(euroc):
    pool = np.arange(16)[:, None, None] * np.ones((1, 2, 3), np.uint8)
    batches, orders = traffic.closed_batches(pool, {"batch": 128, "distinct_batches": 2}, SEED)
    assert len(batches) == 2
    for b, o in zip(batches, orders):
        assert b.shape == (128, 2, 3) and np.array_equal(np.bincount(o), [8] * 16)
        assert np.array_equal(b[:, 0, 0], o)
    assert not np.array_equal(orders[0], orders[1])
    again, orders2 = traffic.closed_batches(pool, {"batch": 128, "distinct_batches": 2}, SEED)
    assert all(np.array_equal(x, y) for x, y in zip(orders, orders2))
    with pytest.raises(ValueError):
        traffic.closed_batches(pool, {"batch": 100, "distinct_batches": 1}, SEED)


class Recorder:
    """A detector whose result for each frame is ``{pool index: (call,
    position in the batch)}``."""

    def __init__(self):
        self.calls = 0

    def detect_batch(self, frames):
        self.calls += 1
        return [{int(f[0, 0]): (self.calls, i)} for i, f in enumerate(frames)]


def test_window_keeps_each_batchs_first_call_whole_and_samples_later_calls():
    pool = np.arange(16)[:, None, None] * np.ones((1, 2, 3), np.uint8)
    t = harness.Traffic({"loop": "closed", "batch": 128, "distinct_batches": 2}, pool, SEED)
    for o, slots in zip(t.orders, t.slots):
        assert slots.shape == (16, 8) and all((o[slots[p]] == p).all() for p in range(16))
    win, det = harness.Window(timeline=False), Recorder()
    harness.run_closed(det, t, 0.5, win, contextlib.nullcontext)
    assert det.calls > 2 * (2 + harness.KEPT_CALLS)
    # the first call of each distinct batch: every position
    assert [[r[int(p)] for p, r in zip(idx, res)] for idx, res in win.kept] == \
        [[(c, i) for i in range(128)] for c in (1, 2)]
    # the reservoir: later calls drawn over the whole window, one position
    # of each pool frame each, drawn anew for each call
    assert len(win.sampled) == harness.KEPT_CALLS
    calls, positions = set(), {p: set() for p in range(16)}
    for idx, res in win.sampled:
        assert sorted(int(p) for p in idx) == list(range(16))
        for p, r in zip(idx, res):
            c, i = r[int(p)]
            calls.add(c)
            positions[int(p)].add((c % 2, i))
    assert len(calls) == harness.KEPT_CALLS and min(calls) > 2
    assert max(calls) > harness.KEPT_CALLS + 2
    assert all(len(v) > 4 for v in positions.values())
