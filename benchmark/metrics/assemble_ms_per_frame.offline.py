"""Facade (``detector.py::_detect_hybrid``'s ``apply_dec``): the ms of the
``AG_TIMELINE`` spans ``assemble`` (result assembly: the decoded rows'
lists, each frame's dict update and the release of the decoded quads'
saddles; full collections that fire inside it included) over the traced
calls, per frame. Moves ``frames_per_s``."""

UNIT = "ms"


def read(ctx):
    # None, not 0, where the program records no such span
    if not ctx.frames or not any(label.startswith("assemble") for label, _, _ in ctx.timeline):
        return None
    return ctx.label_s("assemble") * 1e3 / ctx.frames
