"""Facade (``detector.py::_detect_hybrid``: chunking, result assembly): the
calls' wall time that no ``AG_TIMELINE`` span covers, per frame, in the
closed loop. Moves ``frames_per_s``."""

UNIT = "ms"


def read(ctx):
    if not ctx.timeline or not ctx.frames:
        return None
    return ctx.unlabelled_s() * 1e3 / ctx.frames
