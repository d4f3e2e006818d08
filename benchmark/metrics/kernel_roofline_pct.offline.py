"""Kernels (``csrc/*.cu`` via ``kernels/*.py``): the work model's least
device time for the traced frames (``work.py``: each raw frame read once
against 3.35 TB/s, or the front-end's float32 operations against 67
TFLOP/s, whichever is larger) as a share of the time in which a kernel ran
inside the traced calls (overlaps merged). Moves
``frames_per_s``."""

UNIT = "%"


def read(ctx):
    kernel_s = ctx.kernel_s()
    if kernel_s <= 0.0:
        return None
    return 100.0 * ctx.frames * ctx.frame_bound_s / kernel_s
