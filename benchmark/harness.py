"""One run of one cell: set-up, the measured window, the reference and the
comparison, the metrics. ``run.py`` is the command; this module is what it
runs, and what the CPU tests drive with ``device="cpu"``.

A cell is ``workloads/<name>.json`` (its configuration, its traffic mix and
the chips it takes); its configuration is ``configs/<config>.json`` and its
traffic ``traffic/<traffic>.json`` (``traffic.py`` reads both); each
per-layer metric is a reader ``metrics/<metric>.py`` with ``UNIT`` and
``read(ctx)`` (``devtrace.TraceContext``), which returns None where the
cell gives it nothing to read. All are found by name: a new cell,
configuration or metric is a new file.

The window drives ``aprilgrid_tpu_torch.TagDetector(family,
DetectorParams(max_num_of_boards=...), device).detect_batch`` on numpy
batches: the hybrid, exact mode, as users call it. It sends its batches
back to back (a closed loop, one client) until ``seconds`` have passed and
reports ``frames_per_s``, every returned frame over the time from the
window's start to the last return.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from benchmark import compare, reference, traffic, work
from benchmark.devtrace import CALL_LABEL, TraceContext, profile_events

METRICS_DIR = traffic.BENCH / "metrics"
FORBIDDEN = ("jax", "jaxlib", "flax", "aprilgrid_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_readers() -> dict:
    """Every per-layer metric's reader, by its name (the file's name less
    ``.py``)."""
    readers = {}
    for i, path in enumerate(sorted(METRICS_DIR.glob("*.py"))):
        spec = importlib.util.spec_from_file_location(f"_bench_metric_{i}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        readers[path.name[:-3]] = mod
    return readers


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not hold, each
    compared whole (``aprilgrid_tpu_torch`` is not ``aprilgrid_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card(device: str) -> dict:
    """The card's name and its power limit (nvidia-smi)."""
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        limit = out[0] if out else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "power_limit": limit}


def check_program() -> None:
    """The program under test is the checkout's own, not one found
    elsewhere."""
    import aprilgrid_tpu_torch

    where = Path(aprilgrid_tpu_torch.__file__).resolve()
    if traffic.ROOT not in where.parents:
        raise RuntimeError(f"aprilgrid_tpu_torch comes from {where}, outside {traffic.ROOT}")


class Traffic:
    """A cell's traffic on one pool (``traffic.py``): the closed loop's
    distinct batches, the pool index of each batch's frames, and each pool
    frame's positions in each batch ((pool frames, copies) arrays)."""

    def __init__(self, tr: dict, pool: np.ndarray, seed: int):
        if tr["loop"] != "closed":
            raise ValueError(f"unknown loop {tr['loop']!r}")
        self.seed = int(seed) % (1 << 64)
        self.batches, self.orders = traffic.closed_batches(pool, tr, seed)
        self.slots = [np.stack([np.flatnonzero(o == p) for p in range(len(pool))])
                      for o in self.orders]


class Window:
    """The measured window's record: each call's (start, end, frames); the
    kept results as (pool indices, results), every frame of the first call
    of each distinct batch (``kept``) and the sampled frames of a reservoir
    of later calls (``sampled``); frames unanswered; the full garbage
    collections that ran inside it and, when traced, the program's timeline
    spans."""

    def __init__(self, timeline: bool):
        self.calls: list = []
        self.kept: list = []
        self.sampled: list = []
        self.unanswered = 0
        self.timeline: list | None = [] if timeline else None
        self.t0 = 0.0
        self.gc_spans: list[tuple[float, float]] = []
        self._gc_t = 0.0

    def gc_callback(self, phase, info):
        if info["generation"] == 2:
            if phase == "start":
                self._gc_t = time.perf_counter()
            else:
                self.gc_spans.append((self._gc_t, time.perf_counter()))

    def call(self, det, frames, rf):
        a = time.perf_counter()
        with rf():
            res = det.detect_batch(frames)
        z = time.perf_counter()
        self.calls.append((a, z, len(frames)))
        self.unanswered += max(0, len(frames) - len(res))
        if self.timeline is not None:
            self.timeline.extend(getattr(det, "last_timeline", None) or ())
        return res

    def answered(self) -> int:
        return sum(n for _, _, n in self.calls) - self.unanswered


# the window keeps every frame of the first call of each distinct batch
# and, of a reservoir of this many later calls drawn from the seed, one
# position of each pool frame drawn from the seed for each call: what the
# harness holds stops growing once the reservoir is full
KEPT_CALLS = 32


def run_closed(det, t: Traffic, seconds: float, win: Window, rf) -> dict:
    rng = np.random.default_rng([t.seed, 4])
    win.t0 = time.perf_counter()
    end = win.t0 + seconds
    k = 0
    while time.perf_counter() < end:
        b = k % len(t.batches)
        res = win.call(det, t.batches[b], rf)
        order, n = t.orders[b], k - len(t.batches)
        if n < 0:
            win.kept.append((order[:len(res)], res))
        else:
            j = n if n < KEPT_CALLS else int(rng.integers(0, n + 1))
            if j < KEPT_CALLS:
                slots = t.slots[b]
                pos = slots[np.arange(len(slots)), rng.integers(0, slots.shape[1], len(slots))]
                pos = pos[pos < len(res)]
                kept = (order[pos], [res[i] for i in pos])
                if j < len(win.sampled):
                    win.sampled[j] = kept
                else:
                    win.sampled.append(kept)
        k += 1
    span = win.calls[-1][1] - win.t0
    return {"frames_per_s": {"value": win.answered() / span, "unit": "frames/s"}}


def warm_up(det, t: Traffic, cuda: bool) -> None:
    """One call on the window's first batch: the cell's one shape."""
    import torch

    a = time.perf_counter()
    det.detect_batch(t.batches[0])
    if cuda:
        torch.cuda.synchronize()
    log(f"warm-up call {(time.perf_counter() - a) * 1e3:.3f} ms")


def host_cpu() -> tuple[float, int, int]:
    """This process's CPU seconds, and the host's steal and total ticks
    (``/proc/stat``): the window's share of time that the host's other
    guests took from this one."""
    t = os.times()
    try:
        with open("/proc/stat") as f:
            ticks = [int(v) for v in f.readline().split()[1:]]
    except OSError:
        ticks = [0] * 8
    return t.user + t.system, ticks[7] if len(ticks) > 7 else 0, sum(ticks[:8])


def measure(det, t: Traffic, seconds: float, trace: bool, cuda: bool):
    """The window: (end-to-end metrics, ``Window``, the finished profiler
    or None). Traced, the profiler and ``AG_TIMELINE`` are on."""
    import torch

    win = Window(timeline=trace)
    prof = None
    rf = contextlib.nullcontext
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        os.environ["AG_TIMELINE"] = "1"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()

        def rf():
            return record_function(CALL_LABEL)

    gc.callbacks.append(win.gc_callback)
    cpu0 = host_cpu()
    try:
        e2e = run_closed(det, t, seconds, win, rf)
        if cuda:
            torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(win.gc_callback)
        if prof is not None:
            prof.__exit__(None, None, None)
            os.environ.pop("AG_TIMELINE", None)
    cpu1 = host_cpu()
    ms = [(z - a) * 1e3 for a, z, _ in win.calls]
    log(f"window: {len(ms)} calls, first {ms[0]:.3f} ms, median {np.median(ms):.3f} ms, "
        f"max {max(ms):.3f} ms; full garbage collections {len(win.gc_spans)}, "
        f"{sum(b - a for a, b in win.gc_spans) * 1e3:.3f} ms; process cpu "
        f"{cpu1[0] - cpu0[0]:.3f} s; host steal "
        f"{100.0 * (cpu1[1] - cpu0[1]) / max(1, cpu1[2] - cpu0[2]):.3f} %")
    return e2e, win, prof


def judge(kept, unanswered: int, pool: np.ndarray, cfg: dict, workers=None,
          control: bool = False) -> dict:
    """The comparison (``compare.py``) of the kept frames with the
    reference's detections of their pool frames; ``control`` judges the
    control's detections of the same frames instead of ``kept``'s."""
    t = time.perf_counter()
    needed = sorted({int(p) for idx, _ in kept for p in idx})
    found = reference.detect_pool([pool[p] for p in needed], cfg["family"],
                                  cfg["max_num_of_boards"], workers=workers)
    refs = dict(zip(needed, found))
    if control:
        ctl = reference.detect_pool([pool[p] for p in needed], cfg["family"],
                                    cfg["max_num_of_boards"], control=True, workers=workers)
        kept = [(needed, ctl)]
    cmp = compare.compare(kept, refs, unanswered)
    log(f"reference{' and control' if control else ''}: {len(needed)} pool frames in "
        f"{time.perf_counter() - t:.3f} s; {cmp['frames_compared']} frames compared; tags a "
        f"pool frame {sorted({len(r) for r in found})}")
    cmp["correct"] = compare.passed(cmp["checks"]) and cmp["frames_compared"] > 0
    return cmp


def build_detector(cfg: dict, device: str, factory=None):
    from aprilgrid_tpu_torch import DetectorParams, TagDetector

    params = DetectorParams(max_num_of_boards=int(cfg["max_num_of_boards"]))
    make = factory or (lambda fam, p, dev: TagDetector(fam, params=p, device=dev))
    return make(cfg["family"], params, device)


def load_cell(workload: str) -> tuple[dict, dict, dict]:
    """(workload, configuration, traffic) of a cell, each by its name."""
    wl = traffic.load_json("workloads", workload)
    return wl, traffic.load_json("configs", wl["config"]), traffic.load_json("traffic", wl["traffic"])


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             started: float | None = None, detector_factory=None,
             reference_workers: int | None = None) -> dict:
    """One run of ``workload``; returns the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
    traced, ``setup_s``, ``checks``). ``started``: the process's start on
    ``time.time``'s clock, from which ``setup_s`` runs.
    ``detector_factory(family, params, device)``, where given, builds the
    detector in place of ``TagDetector`` (the tests' faults)."""
    import torch

    started = time.time() if started is None else started
    marks = [("start to harness", time.time())]
    check_program()
    _, cfg, tr = load_cell(workload)
    cuda = device != "cpu"

    pool, _ = traffic.make_pool(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("pool", time.time()))
    det = build_detector(cfg, device, detector_factory)
    t = Traffic(tr, pool, seed)
    marks.append(("detector and batches", time.time()))
    warm_up(det, t, cuda)
    marks.append(("warm-up", time.time()))
    # what set-up left for the collector is collected here, not by the
    # window's first call
    gc.collect()
    marks.append(("collect", time.time()))
    setup_s = marks[-1][1] - started
    prev = started
    steps = []
    for name, at in marks:
        steps.append(f"{name} {at - prev:.3f}")
        prev = at
    log(f"set-up s: {', '.join(steps)}; total {setup_s:.3f}")
    e2e, win, prof = measure(det, t, seconds, trace, cuda)
    dev = card(device)
    dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if cuda else 0

    out: dict = {}
    if trace:
        h, w = int(pool.shape[1]), int(pool.shape[2])
        ch = 1 if pool.ndim == 3 else int(pool.shape[3])
        bound, _ = work.frame_bound_s(h, w, ch, pool.dtype.itemsize)
        events = profile_events(prof, [a for a, _, _ in win.calls]) if cuda else []
        ctx = TraceContext(win.calls, win.timeline or [], events, bound, win.gc_spans)
        metrics = {}
        for name, reader in load_readers().items():
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": reader.UNIT}
        dev["busy_s"] = ctx.busy_s()
        dev["window_s"] = ctx.window_s()
        out["breakdown"] = {"device_ops": ctx.top_device_ops(), "idle_gaps": ctx.idle_gaps()}
        del prof, events, ctx
    else:
        metrics = dict(e2e)
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    # the program's state goes before the reference runs
    kept = win.kept + win.sampled
    unanswered, attempted = win.unanswered, sum(n for _, _, n in win.calls)
    del det, win, t
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cmp = judge(kept, unanswered, pool, cfg, reference_workers)
    out.update(correct=cmp["correct"], attempted=attempted, failed=unanswered,
               metrics=metrics, device=dev, setup_s=setup_s, checks=cmp["checks"])
    return out
