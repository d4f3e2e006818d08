"""Device (H100): the share of the traced calls' wall time in which no
kernel, copy or memset ran on the card (torch.profiler; the arithmetic of
``utils/profiling.py::device_busy``). Moves
``frames_per_s``."""

UNIT = "%"


def read(ctx):
    busy = ctx.busy_s()
    if busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / ctx.window_s())
