"""Port bench: ``TagDetector.detect_batch`` throughput of the PyTorch/CUDA
port, one JSON line per cell, then a geomean line.

The port's counterpart of the JAX package's ``bench.py``,
``tools/bench_detection.py`` and ``tools/probe_timeline.py``. A cell is
one golden image batched ``BENCH_BATCH`` times (default 128: four chunks
at 1080p, so the runtime's pipeline can show) under one mode: the exact
mode on the seven images the reference benches (EuRoC, TUM_VI, right,
r45, top, iphone, two_boards), the turbo mode with the NMS and with the
drain extraction on the two 1080p ones. Frames lie on the device, as in
the JAX bench (``--host-frames`` passes a numpy batch, to show the
upload of the raw frames). ``--modes xla`` adds the xla mode (the whole
detect on the device, ``TagDetector(mode="xla")``) at batch 16 unless
``BENCH_BATCH`` is set, as the JAX bench's ``BENCH_MODE=xla``; it is a
record beside the hybrid cells, with the host's reads of the search's
loop conditions per call (``search_syncs``), and has no timeline.

Per cell: the golden tag count asserted on every frame; ID parity and
``corner_max_px`` of every frame against the port's own CPU run of one
frame; frames/s over ``BENCH_REPS`` (default 5) timed calls after one
warm-up, as median, min and max; the saddles one frame hands the board
search (``saddles_per_frame``); the host's core count;
the card's name and power limit as ``nvidia-smi`` gives them. ``--timeline`` adds one
call under ``AG_TIMELINE=1``: the per-label ms sums, the host's wait in
the first ``pack_read`` and the time after the last ``fe_dispatch``.
``--trace`` adds the device-busy share of one call (torch.profiler).

``--4k`` is the 4K camera-rig bench instead (the port of the JAX
package's ``tools/bench_4k.py``): ``BENCH_CAMS`` (default 4) cameras x
``BENCH_STEPS`` (default 8) steps of one 2160 x 3840 RGB frame, grey (128)
with two_boards at its centre (``frame_4k``), in one ``detect_batch``
call a rep, exact and turbo (``decimate="auto"``: the NMS extraction on
hosts with more than one core; ``BENCH_DECIMATE=1`` runs turbo only). Each
mode's line is a cell's record with ``cams`` and ``steps``: 72 tags on
every frame, ID parity and ``corner_max_px`` against the port's CPU run
of one frame, frames/s as median, min and max of ``BENCH_REPS``.

``--stream`` is the streamed-ingest bench instead (the port of the JAX
package's ``tools/bench_stream.py``): ``BENCH_NBATCH`` (default 6) numpy
batches of ``BENCH_BATCH`` (default 32) copies of one image (``--images``,
default two_boards), exact mode, timed three ways, each as the median of
``BENCH_REPS`` rounds taken in turns: ``serial`` (upload a batch with a
pageable ``.to``, detect it, then the next), ``numpy`` (``detect_batch`` on
the numpy batch, which uploads chunk by chunk), ``streamed``
(``parallel.streaming.detect_stream``, prefetch 2) and ``device`` (the
batch uploaded once before the rounds: the rate with no ingest). One JSON
line per way:
frames/s, ingest MB/s, the golden count held on every frame of every
round, each round's ms to each batch's result; then the overlap ratio
serial / streamed. ``--stream serial,numpy``
runs only those ways (a parent commit without ``detect_stream``).
The MB/s of every way count the host bytes of all batches, the ``device``
way's too (which moves none of them in its rounds).

Run from the repo root: ``python3 -m aprilgrid_tpu_torch.bench`` (on the
card) or ``... --device cpu`` (plain PyTorch versions, for tests). Env:
``BENCH_BATCH``, ``BENCH_REPS``, and the runtime's own ``AG_CHUNK``,
``AG_SEARCH_THREADS``, ``AG_SEARCH_ASYNC``, ``AG_FILL_RAMP``,
``AG_NMS_MERGE`` (the NMS variant's peak merge). Exits 3 on any parity
miss.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .detector import TagDetector, _default_chunk
from .utils.images import DATA, GOLDEN, read_png
from .utils.profiling import device_busy

TURBO_IMAGES = ("iphone", "two_boards")   # the turbo mode's frames: >= 2 MP
# mode -> (decimate, AG_TURBO_NMS); the default --modes
MODES = {"exact": (False, None), "turbo-nms": (True, "1"), "turbo-drain": (True, "0"),
         "turbo": ("auto", None)}   # the 4K rig's turbo: the facade's own choices
DEFAULT_MODES = ("exact", "turbo-nms", "turbo-drain")
XLA_BATCH = 16   # the xla mode's default batch (the JAX bench's BENCH_MODE=xla)
FOUR_K_TAGS = 72   # two_boards on the 4K canvas


def frame_4k() -> np.ndarray:
    """The 4K rig's frame (the JAX package's tools/bench_4k.py:29-41): a
    2160 x 3840 RGB canvas filled with 128, two_boards (1080 x 1920) at
    its centre."""
    frame = np.full((2160, 3840, 3), 128, np.uint8)
    frame[540:1620, 960:2880] = read_png(DATA / "two_boards.png")
    return frame


def card_name() -> str | None:
    """``name, power limit`` of the first card as nvidia-smi gives them,
    or None without a card."""
    if not torch.cuda.is_available():
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timeline_summary(tl: list, t0: float, t1: float) -> dict:
    """Per-label ms sums of a runtime timeline (labels without their chunk
    and pass: ``fe_dispatch``, with ``fe_stage`` and ``fe_launch`` inside
    it, ``pack_read``, ``search_submit``, ``search_wait``,
    ``dec_dispatch``, ``dec_read``, ``assemble``), the host's wait in
    the first ``pack_read`` (the pipeline's fill), the time from the end
    of the last ``fe_dispatch`` to the end of the call (its drain), and
    the call's wall ms (``t0``, ``t1`` on the same clock)."""
    sums: dict = {}
    for label, a, b in tl:
        key = label.split(" ")[0]
        sums[key] = sums.get(key, 0.0) + (b - a) * 1e3
    reads = [b - a for label, a, b in tl if label.startswith("pack_read")]
    last_fe = max(b for label, _, b in tl if label.startswith("fe_dispatch"))
    return {
        "label_ms": sums,
        "first_pack_read_ms": reads[0] * 1e3,
        "after_last_fe_dispatch_ms": (t1 - last_fe) * 1e3,
        "wall_ms": (t1 - t0) * 1e3,
        "events": len(tl),
    }


def _parity(res: list, ref: dict) -> tuple[bool, float]:
    """(every frame's ID set equals ``ref``'s, max corner distance in px)."""
    same, err = True, 0.0
    for tags in res:
        if set(tags) != set(ref):
            same = False
            continue
        for tid, c in tags.items():
            err = max(err, float(np.abs(np.asarray(c, np.float64)
                                        - np.asarray(ref[tid], np.float64)).max()))
    return same, err


def saddles_per_frame(det: TagDetector, img: np.ndarray) -> int:
    """The saddles the front-end hands the board search for one frame,
    from the front-end ``det`` calls on it (exact or turbo as its
    ``decimate`` policy resolves, the turbo extraction variant as its own
    choice and the environment select it, the peak merge as the
    environment selects it)."""
    from .pipeline import saddle_frontend_batch

    h, w = img.shape[:2]
    decimate = det._use_decimate(h, w)
    nms = det._turbo_nms(h, w) if decimate else None
    frames = torch.from_numpy(img)[None].to(det.device)
    return int(saddle_frontend_batch(frames, det.params, det.consts, det.caps, decimate,
                                     nms)[0].valid.sum())


def bench_cell(name: str, mode: str, device: str, batch: int, reps: int,
               host_frames: bool, timeline: bool, trace: bool, refs: dict,
               img: np.ndarray | None = None, golden: int | None = None) -> dict:
    """One cell: warm-up + checks, ``reps`` timed calls, optional timeline
    and device-busy runs; returns its JSON record. The frame is the golden
    image ``name`` unless ``img`` (with its tag count ``golden``) is
    given."""
    from .ops.board import SYNCS

    decimate, nms_env = MODES.get(mode, (False, None))
    det_mode = "xla" if mode == "xla" else "hybrid"
    if img is None:
        img, golden = read_png(DATA / f"{name}.png"), GOLDEN[name]
    if nms_env is not None:
        os.environ["AG_TURBO_NMS"] = nms_env
    try:
        if (name, mode) not in refs:
            refs[name, mode] = TagDetector("t36h11", device="cpu", mode=det_mode,
                                           decimate=decimate).detect(img)
        det = TagDetector("t36h11", device=device, mode=det_mode, decimate=decimate)
        host = np.ascontiguousarray(np.broadcast_to(img, (batch,) + img.shape))
        frames = host if host_frames else torch.from_numpy(host).to(device)

        def call():
            out = det.detect_batch(frames)
            if device != "cpu":
                torch.cuda.synchronize()
            return out

        res = call()  # warm-up: kernel builds, allocator, tables
        counts = [len(t) for t in res]
        if any(n != golden for n in counts):
            raise AssertionError(f"{name} {mode}: tag counts {sorted(set(counts))}, "
                                 f"golden {golden}")
        ids_equal, err = _parity(res, refs[name, mode])
        ms = []
        SYNCS.update(dict.fromkeys(SYNCS, 0))
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            ms.append((time.perf_counter() - t0) * 1e3)
        syncs = sum(SYNCS.values()) / reps
        fps = sorted(batch / m * 1e3 for m in ms)
        chunk = os.environ.get("AG_CHUNK")
        rec = {
            "cell": f"{name} {mode}", "image": name, "shape": list(img.shape),
            "mode": mode, "batch": batch,
            "chunk": None if det_mode == "xla" else (
                int(chunk) if chunk else _default_chunk(*img.shape[:2])),
            "frames_on": "host" if host_frames else "device", "reps": reps,
            "frames_per_s": {"median": statistics.median(fps), "min": fps[0],
                             "max": fps[-1]},
            "call_ms": ms, "tags": counts[0], "golden": golden,
            "ids_equal": ids_equal, "corner_max_px": err,
            "host_cores": os.cpu_count(),
            "search_threads": int(os.environ.get("AG_SEARCH_THREADS", "0")),
            "search_async": os.environ.get("AG_SEARCH_ASYNC", "default"),
            "fill_ramp": os.environ.get("AG_FILL_RAMP", "0"),
            "device": device, "card": card_name() if device != "cpu" else None,
            "nms_merge": os.environ.get("AG_NMS_MERGE", "0"),
            "saddles_per_frame": saddles_per_frame(det, img),
            "search_syncs": syncs,
        }
        if timeline and det_mode == "hybrid":
            os.environ["AG_TIMELINE"] = "1"
            try:
                t0 = time.perf_counter()
                call()
                t1 = time.perf_counter()
            finally:
                del os.environ["AG_TIMELINE"]
            rec["timeline"] = timeline_summary(det.last_timeline, t0, t1)
        if trace:
            rec["device_busy"] = device_busy(call) if device != "cpu" else None
        return rec
    finally:
        if nms_env is not None:
            del os.environ["AG_TURBO_NMS"]


def bench_4k(device: str, cams: int, steps: int, reps: int,
             modes=("exact", "turbo"), host_frames: bool = False,
             timeline: bool = False, trace: bool = False):
    """The 4K rig's records (module docstring), one per mode as each
    finishes: ``cams * steps`` copies of ``frame_4k`` in one batch."""
    frame, refs = frame_4k(), {}
    for mode in modes:
        rec = bench_cell("4k", mode, device, cams * steps, reps, host_frames, timeline,
                         trace, refs, img=frame, golden=FOUR_K_TAGS)
        rec.update(cams=cams, steps=steps)
        yield rec


STREAM_WAYS = ("serial", "numpy", "streamed", "device")


def bench_stream(name: str, device: str, batch: int, n_batches: int, reps: int,
                 ways: list[str]) -> list[dict]:
    """The streamed-ingest records of one image (module docstring): one
    per way, then the overlap ratio where serial and streamed both ran."""
    img = read_png(DATA / f"{name}.png")
    det = TagDetector("t36h11", device=device)
    host = np.ascontiguousarray(np.broadcast_to(img, (batch,) + img.shape))
    resident = torch.from_numpy(host).to(device)   # the "device" way's frames

    def run(way):
        """The way's results and the host-clock ms from the round's start to
        each batch's result."""
        t0, out, at = time.perf_counter(), [], []
        if way == "streamed":
            from .parallel.streaming import detect_stream

            results = detect_stream(det, (host for _ in range(n_batches)), prefetch=2)
        else:
            frames = {"serial": lambda: torch.from_numpy(host).to(device),
                      "numpy": lambda: host, "device": lambda: resident}[way]
            results = (det.detect_batch(frames()) for _ in range(n_batches))
        for res in results:
            out.append(res)
            at.append((time.perf_counter() - t0) * 1e3)
        return out, at

    def held(way, out):
        counts = {len(t) for res in out for t in res}
        if len(out) != n_batches or counts != {GOLDEN[name]}:
            raise AssertionError(f"stream {name} {way}: tag counts {sorted(counts)} "
                                 f"over {len(out)} batches, golden {GOLDEN[name]}")

    for way in ways:   # warm-up: builds, allocator, pinned buffers
        held(way, run(way)[0])
    secs: dict = {way: [] for way in ways}
    marks: dict = {way: [] for way in ways}
    for _ in range(reps):
        for way in ways:
            out, at = run(way)
            secs[way].append(at[-1] / 1e3)
            marks[way].append(at)
            held(way, out)
    frames, mbytes = batch * n_batches, host.nbytes * n_batches / 1e6
    card = card_name() if device != "cpu" else None
    recs = []
    for way in ways:
        t = statistics.median(secs[way])
        recs.append({
            "stream": way, "image": name, "shape": list(img.shape), "batch": batch,
            "batches": n_batches, "reps": reps, "frames_per_s": frames / t,
            "ingest_mb_per_s": mbytes / t, "seconds": secs[way],
            "batch_done_ms": marks[way],
            "tags": GOLDEN[name], "device": device, "card": card,
        })
    if "serial" in secs and "streamed" in secs:
        recs.append({
            "stream_overlap": statistics.median(secs["serial"])
            / statistics.median(secs["streamed"]),
            "image": name, "batch": batch, "device": device, "card": card,
        })
    return recs


def golden_cells(args, reps: int):
    """The golden images' records under ``--modes`` and ``--images``, one
    per cell as each finishes."""
    env_batch = os.environ.get("BENCH_BATCH")
    refs: dict = {}
    for mode in args.modes.split(","):
        if mode not in MODES and mode != "xla":
            raise SystemExit(f"bench: unknown mode {mode!r}")
        batch = int(env_batch) if env_batch else (XLA_BATCH if mode == "xla" else 128)
        for name in (args.images or ",".join(GOLDEN)).split(","):
            if MODES.get(mode, (False,))[0] and name not in TURBO_IMAGES:
                continue
            yield bench_cell(name, mode, args.device, batch, reps, args.host_frames,
                             args.timeline, args.trace, refs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--images", default=None,
                    help="comma-separated golden images (default: all seven; "
                         "two_boards with --stream)")
    ap.add_argument("--modes", default=",".join(DEFAULT_MODES),
                    help="comma-separated modes (exact, turbo-nms, turbo-drain, turbo, "
                         "xla); the turbo ones run on the 1080p images only")
    ap.add_argument("--host-frames", action="store_true",
                    help="pass the batch as a numpy array (the facade uploads it "
                         "chunk by chunk)")
    ap.add_argument("--timeline", action="store_true",
                    help="add one AG_TIMELINE=1 call per cell and its label sums")
    ap.add_argument("--trace", action="store_true",
                    help="add the device-busy share of one call (torch.profiler)")
    ap.add_argument("--stream", nargs="?", const=",".join(STREAM_WAYS), default=None,
                    help="the streamed-ingest bench; optionally the ways to run, "
                         "comma-separated (default: serial,numpy,streamed,device)")
    ap.add_argument("--4k", dest="four_k", action="store_true",
                    help="the 4K camera-rig bench (env BENCH_CAMS, BENCH_STEPS, "
                         "BENCH_DECIMATE)")
    args = ap.parse_args(argv)
    reps = int(os.environ.get("BENCH_REPS", "5"))
    if args.device != "cpu" and not torch.cuda.is_available():
        print("bench: no CUDA device (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    if args.stream is not None:
        batch = int(os.environ.get("BENCH_BATCH", "32"))
        n_batches = int(os.environ.get("BENCH_NBATCH", "6"))
        for name in (args.images or "two_boards").split(","):
            for rec in bench_stream(name, args.device, batch, n_batches, reps,
                                    args.stream.split(",")):
                print(json.dumps(rec), flush=True)
        return 0
    if args.four_k:
        modes = ("turbo",) if os.environ.get("BENCH_DECIMATE", "") == "1" else (
            "exact", "turbo")
        recs = bench_4k(args.device, int(os.environ.get("BENCH_CAMS", "4")),
                        int(os.environ.get("BENCH_STEPS", "8")), reps, modes,
                        args.host_frames, args.timeline, args.trace)
    else:
        recs = golden_cells(args, reps)
    fps: dict = {}
    parity_ok = True
    batches = set()
    for rec in recs:
        parity_ok &= rec["ids_equal"] and rec["corner_max_px"] <= 1e-3
        fps.setdefault(rec["mode"], []).append(rec["frames_per_s"]["median"])
        batches.add(rec["batch"])
        print(json.dumps(rec), flush=True)
    print(json.dumps({
        "geomean_frames_per_s": {
            m: math.exp(sum(math.log(f) for f in v) / len(v)) for m, v in fps.items()},
        "cells": sum(len(v) for v in fps.values()), "batch": sorted(batches),
        "parity_ok": parity_ok, "host_cores": os.cpu_count(),
        "device": args.device, "card": card_name() if args.device != "cpu" else None,
    }), flush=True)
    return 0 if parity_ok else 3


if __name__ == "__main__":
    sys.exit(main())
