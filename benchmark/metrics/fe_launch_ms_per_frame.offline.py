"""Ingest and front-end enqueue (``pipeline.py::frontend_packed``, called
from ``detector.py::_detect_hybrid``'s ``front``): the ms of the
``AG_TIMELINE`` spans ``fe_launch`` (the front-end's enqueue), which lie
inside ``fe_dispatch``, over the traced calls, per frame. Moves
``frames_per_s``."""

UNIT = "ms"


def read(ctx):
    # None, not 0, where the program records no such span
    if not ctx.frames or not any(label.startswith("fe_launch") for label, _, _ in ctx.timeline):
        return None
    return ctx.label_s("fe_launch") * 1e3 / ctx.frames
