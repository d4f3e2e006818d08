"""The work model behind the kernels' roofline share, from shapes alone, and
the card's published peaks.

The least time the card could take for a frame: its raw bytes read once,
held against the HBM peak, or the front-end's float32 operations on each of
its pixels, held against the float32 peak, whichever is larger. The
operations are the stencil's 42 a pixel (two 7-tap blur passes, the
Hessian, the threshold compare: ``chip_smoke.py``'s ``STENCIL_OPS``) and
the luma conversion's (one scale a gray pixel; three products, two sums
and a scale an RGB pixel). The model counts the algorithm's work on the
frame's own pixels, not any kernel's padding or intermediate planes, so
the share reads the same work whatever implements it; the board search,
the decode and the result assembly are left out, so it is a lower bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense): HBM3 bytes/s and float32 operations/s
# outside the tensor cores, at the full 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
STENCIL_OPS = 42.0


def luma_ops(channels: int) -> float:
    return 1.0 if channels == 1 else 6.0


def frame_bound_s(height: int, width: int, channels: int, itemsize: int) -> tuple[float, str]:
    """(least seconds for one frame's front-end work, what binds it)."""
    px = height * width
    t_bytes = px * channels * itemsize / PEAK_BYTES
    t_ops = px * (STENCIL_OPS + luma_ops(channels)) / PEAK_F32
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
