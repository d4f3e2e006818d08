"""What a traced run reads: the calls' host spans, the program's
``AG_TIMELINE`` spans and the card's operations from ``torch.profiler``,
on one clock, and the interval arithmetic the per-layer metrics share.

Each timed call runs inside a ``record_function`` range of its own
(``CALL_LABEL``); the profiler's ranges and the harness's host clock
readings of the same calls give the offset between the two clocks, and the
device operations are moved onto the host clock by it. The device
arithmetic (operations clipped to the calls, overlaps merged) is that of
``aprilgrid_tpu_torch/utils/profiling.py::device_busy``, over many calls.
"""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass, field

CALL_LABEL = "bench_call"
COPY_PREFIXES = ("Memcpy", "Memset")


def merge(spans) -> list[tuple[float, float]]:
    """The union of (start, end) spans as sorted disjoint spans."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(xs, ys) -> list[tuple[float, float]]:
    """The intersection of two merged span lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys) -> list[tuple[float, float]]:
    """``xs`` minus ``ys``, both merged span lists."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k, cur = j, a
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > cur:
                out.append((cur, ys[k][0]))
            cur = max(cur, ys[k][1])
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def total(spans) -> float:
    return sum(b - a for a, b in spans)


@dataclass
class TraceContext:
    """One traced window, on the host clock (seconds of ``perf_counter``).

    ``calls``: (start, end, frames) of each timed call; ``timeline``:
    (label, start, end) of the program's ``AG_TIMELINE`` spans;
    ``device``: (name, start, end) of each device operation (kernels,
    copies, memsets) the profiler saw; ``frame_bound_s``: the work model's
    least device time for one frame (``work.py``); ``gc_spans``: (start,
    end) of the interpreter's full garbage collections (``gc.callbacks``)."""

    calls: list
    timeline: list
    device: list
    frame_bound_s: float
    gc_spans: list = field(default_factory=list)
    _cache: dict = field(default_factory=dict, repr=False)

    @property
    def frames(self) -> int:
        return sum(n for _, _, n in self.calls)

    def windows(self):
        if "windows" not in self._cache:
            self._cache["windows"] = merge((a, b) for a, b, _ in self.calls)
        return self._cache["windows"]

    def window_s(self) -> float:
        return total(self.windows())

    def device_in_calls(self, kernels_only: bool = False):
        """The device operations inside the calls, merged."""
        key = ("dev", kernels_only)
        if key not in self._cache:
            spans = [(a, b) for name, a, b in self.device
                     if not (kernels_only and name.startswith(COPY_PREFIXES))]
            self._cache[key] = intersect(merge(spans), self.windows())
        return self._cache[key]

    def busy_s(self) -> float:
        return total(self.device_in_calls())

    def kernel_s(self) -> float:
        return total(self.device_in_calls(kernels_only=True))

    def label_s(self, *prefixes: str) -> float:
        """Seconds of the timeline spans whose label starts with one of
        ``prefixes``, inside the calls."""
        spans = [(a, b) for label, a, b in self.timeline if label.startswith(prefixes)]
        return total(intersect(merge(spans), self.windows()))

    def unlabelled_s(self) -> float:
        """Call time that no timeline span covers."""
        labelled = intersect(merge((a, b) for _, a, b in self.timeline), self.windows())
        return self.window_s() - total(labelled)

    def gc_s(self) -> float:
        """Seconds of full garbage collections inside the calls."""
        return total(intersect(merge(self.gc_spans), self.windows()))

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches of call time with no device operation, each
        named by the timeline label the host was inside for most of it
        (without its chunk and pass), or ``unlabelled``; ``gc_full`` where a
        full garbage collection covers most of it."""
        gaps = sorted(subtract(self.windows(), self.device_in_calls()),
                      key=lambda g: g[1] - g[0], reverse=True)[:top]
        tl = sorted((a, b, label) for label, a, b in self.timeline)
        starts = [a for a, _, _ in tl]
        longest = max((b - a for a, b, _ in tl), default=0.0)
        out = []
        for g0, g1 in gaps:
            best, name = 0.0, "unlabelled"
            i = bisect.bisect_left(starts, g1) - 1
            while i >= 0 and tl[i][0] > g0 - longest:
                a, b, label = tl[i]
                ov = min(b, g1) - max(a, g0)
                if ov > best:
                    best, name = ov, label.split(" ")[0]
                i -= 1
            in_gc = sum(max(0.0, min(b, g1) - max(a, g0)) for a, b in self.gc_spans)
            out.append(["gc_full" if in_gc > (g1 - g0) / 2 else name, g1 - g0])
        return out

    def top_device_ops(self, top: int = 10) -> list:
        """Device seconds by operation name, inside the calls, largest
        first."""
        wins = self.windows()
        starts = [a for a, _ in wins]
        by: dict[str, float] = {}
        for name, a, b in self.device:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a < wins[i][1]:
                by[name] = by.get(name, 0.0) + (min(b, wins[i][1]) - a)
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: kv[1], reverse=True)[:top]


def profile_events(prof, host_starts: list[float]) -> list:
    """The device operations of a finished ``torch.profiler.profile`` as
    (name, start, end) on the host clock. ``host_starts`` are the host
    clock's readings at the start of each call, in order; the offset
    between the clocks is the median over the calls of that reading less
    the start of the call's ``record_function`` range."""
    evs = prof.events()
    ranges = sorted(ev.time_range.start for ev in evs
                    if ev.name == CALL_LABEL and "CPU" in str(ev.device_type))
    if not ranges:
        raise RuntimeError("the profiler recorded none of the calls' ranges")
    pairs = zip(host_starts, ranges) if len(ranges) == len(host_starts) else \
        [(host_starts[0], ranges[0])]
    offset = statistics.median(h - r / 1e6 for h, r in pairs)
    return [(ev.name, ev.time_range.start / 1e6 + offset, ev.time_range.end / 1e6 + offset)
            for ev in evs
            if "CUDA" in str(ev.device_type) and ev.name != CALL_LABEL
            and not getattr(ev, "is_user_annotation", False)]
