"""Ingest and front-end enqueue (``detector.py::ensure_fe``,
``_HostUpload``, ``pipeline.py``): the ms of the ``AG_TIMELINE`` spans
``fe_dispatch`` (the numpy batch's staging copy and the front-end's
launches) over the traced calls, per frame. Moves
``frames_per_s``."""

UNIT = "ms"


def read(ctx):
    if not ctx.timeline or not ctx.frames:
        return None
    return ctx.label_s("fe_dispatch") * 1e3 / ctx.frames
