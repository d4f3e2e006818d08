"""Python runtime (the interpreter's cyclic garbage collector, run by the
facade's allocations: each call's result dicts, lists and tuples): the ms
of full (generation 2) collections inside the traced calls, per frame, in
the closed loop, from ``gc.callbacks`` on the host clock. Moves
``frames_per_s``."""

UNIT = "ms"


def read(ctx):
    if not ctx.frames:
        return None
    return ctx.gc_s() * 1e3 / ctx.frames
