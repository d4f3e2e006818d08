"""Profiling and tracing utilities (the JAX package's utils/profiling.py).

* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (CPU activity on the CPU; CPU and CUDA activity where a
  card is present);
* :func:`device_busy` — the share of one call's wall time in which the
  card ran a kernel or a copy;
* :class:`StageTimer` — wall-clock stage timing that waits for the card
  (kernel launches are asynchronous; naive timing lies);
* :func:`detect_stage_report` — per-stage breakdown of the hybrid detect
  pipeline on a given batch.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block with ``torch.profiler`` and write its Chrome
    trace to ``log_dir/trace.json`` (default: a directory under the
    system's temporary directory); yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "aprilgrid_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _merged_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) spans."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def device_busy(fn, label: str = "ag_call") -> dict:
    """Run ``fn`` once under ``torch.profiler`` with CUDA activity and
    return the wall ms of the call (its ``record_function`` range on the
    host track), the ms in which the card ran a kernel, copy or memset
    inside that range (overlaps merged), their share, and the device
    operations counted. Needs a card."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
        torch.cuda.synchronize()
    evs = prof.events()
    win = next(ev.time_range for ev in evs if ev.name == label
               and "CPU" in str(getattr(ev, "device_type", "")))
    dev = [ev for ev in evs if "CUDA" in str(getattr(ev, "device_type", ""))
           and ev.name != label and not getattr(ev, "is_user_annotation", False)]
    spans = [(max(ev.time_range.start, win.start), min(ev.time_range.end, win.end))
             for ev in dev]
    busy = _merged_us([(a, b) for a, b in spans if b > a])
    wall = win.elapsed_us()
    return {
        "wall_ms": wall / 1e3, "busy_ms": busy / 1e3, "share": busy / wall,
        "kernels": sum(not ev.name.startswith(("Memcpy", "Memset")) for ev in dev),
        "memcpys": sum(ev.name.startswith("Memcpy") for ev in dev),
    }


def _sync(result) -> None:
    """Wait for the card if ``result`` holds a CUDA tensor."""
    tensors = result if isinstance(result, (tuple, list)) else (result,)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


@dataclass
class StageTimer:
    """Accumulates named stage wall times, waiting for the card."""

    stages: dict = field(default_factory=dict)
    _t0: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, name: str, result=None):
        if result is not None:
            _sync(result)
        dt = time.perf_counter() - self._t0
        self.stages[name] = self.stages.get(name, 0.0) + dt
        self._t0 = time.perf_counter()
        return result

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{'stage':<32}{'ms':>10}{'%':>7}"]
        for k, v in self.stages.items():
            lines.append(f"{k:<32}{v * 1e3:>10.2f}{100 * v / total:>6.1f}%")
        lines.append(f"{'total':<32}{total * 1e3:>10.2f}")
        return "\n".join(lines)


def detect_stage_report(detector, imgs, reps: int = 3) -> str:
    """Time each hybrid-pipeline stage over a batch (after a warm-up),
    as one chunk walked pass by pass: front-end, one packed saddle
    download, then per board pass the native search, the decode (one
    upload, one launch) and its download, and the host's collect."""
    from .. import native
    from ..detector import _as_tensor
    from ..pipeline import frontend_packed

    imgs_d = _as_tensor(imgs).to(detector.device)
    detector.detect_batch(imgs_d)  # warm-up: builds, allocator, tables
    h, w = int(imgs_d.shape[1]), int(imgs_d.shape[2])
    dec = detector._use_decimate(h, w)
    nms = detector._turbo_nms(h, w) if dec else None
    cap = (2 * detector.caps.grid_radius + 1) ** 2
    dcap = min(cap, 2 * detector.caps.max_tags)

    t = StageTimer()
    for _ in range(reps):
        t.start()
        packed, luma8 = frontend_packed(imgs_d, detector.params, detector.consts,
                                        detector.caps, dec, nms)
        t.stop("frontend (device)", packed)
        pk = packed.cpu().numpy()[:, :-1]
        px = np.ascontiguousarray(pk[..., 0])
        py = np.ascontiguousarray(pk[..., 1])
        th = np.ascontiguousarray(pk[..., 2])
        alive = (pk[..., 3] > 0.5).astype(np.uint8)
        t.stop("saddle download")
        for p in range(detector.params.max_num_of_boards):
            quads, counts = native.find_board_batch(
                px, py, th, alive,
                spacing_ratio=detector.params.tag_spacing_ratio,
                max_seeds=detector.consts.max_seeds,
                early_exit_score=detector.consts.early_exit_score,
                cap=cap,
            )
            t.stop(f"board search pass {p + 1} (host)")
            quads = np.ascontiguousarray(quads[:, :dcap])
            out = detector._decode(packed, luma8, quads, counts, (h, w))
            t.stop(f"decode pass {p + 1} (upload+device)", out)
            arr = out.cpu().numpy()
            t.stop(f"result download pass {p + 1}")
            fi, fj = np.nonzero(arr[..., 1] > 0.5)
            alive[np.repeat(fi, 4), quads[fi, fj].reshape(-1)] = 0
            t.stop(f"collect pass {p + 1} (host)")
    return t.report()
