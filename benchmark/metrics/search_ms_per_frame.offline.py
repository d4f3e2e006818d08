"""Host board search (``native/search.cpp``, driven by
``detector.py::_detect_hybrid``): the ms of the ``AG_TIMELINE`` spans
``search_submit`` and ``search_wait`` over the traced calls, per frame, in
the closed loop. Moves ``frames_per_s``."""

UNIT = "ms"


def read(ctx):
    if not ctx.timeline or not ctx.frames:
        return None
    return ctx.label_s("search_submit", "search_wait") * 1e3 / ctx.frames
