"""Ingest and front-end enqueue (``detector.py::_detect_hybrid``'s
``front``: ``_HostUpload``, ``put`` or ``.to``): the ms of the
``AG_TIMELINE`` spans ``fe_stage`` (a chunk's frames onto the device: the
pinned buffer, the staging copy, the device allocation and the
host-to-device enqueue), which lie inside ``fe_dispatch``, over the traced
calls, per frame. Moves ``frames_per_s``."""

UNIT = "ms"


def read(ctx):
    # None, not 0, where the program records no such span
    if not ctx.frames or not any(label.startswith("fe_stage") for label, _, _ in ctx.timeline):
        return None
    return ctx.label_s("fe_stage") * 1e3 / ctx.frames
