"""ctypes mirror of the ROCHADE fit's tap tables (``FitTaps`` in
csrc/rochade.cuh), filled from ``ops/rochade.py::fit_taps`` — the one list
of taps both the kernels and their plain versions evaluate."""

from __future__ import annotations

import ctypes
import functools

from ..ops.rochade import fit_taps


class FitTaps(ctypes.Structure):
    """Mirror of ``ag::FitTaps`` in csrc/rochade.cuh."""

    _fields_ = [
        ("n_cone", ctypes.c_int),
        ("cone_dr", ctypes.c_int * 25),
        ("cone_dc", ctypes.c_int * 25),
        ("cone_w", ctypes.c_float * 25),
        ("vid", ctypes.c_int * 5),
        ("nv", ctypes.c_int * 5),
        ("vd", (ctypes.c_int * 5) * 5),
        ("vw", (ctypes.c_float * 5) * 5),
        ("nh", ctypes.c_int * 5),
        ("hd", (ctypes.c_int * 5) * 5),
        ("hw", (ctypes.c_float * 5) * 5),
    ]


@functools.lru_cache(maxsize=None)
def fit_struct(half_patch: int) -> FitTaps:
    """The table for ``half_patch``, built once; callers only read it."""
    cone, fits = fit_taps(half_patch)
    s = FitTaps()
    s.n_cone = len(cone)
    for t, (dr, dc, wgt) in enumerate(cone):
        s.cone_dr[t], s.cone_dc[t], s.cone_w[t] = dr, dc, wgt
    for j, (vid, vt, ht) in enumerate(fits):
        s.vid[j], s.nv[j], s.nh[j] = vid, len(vt), len(ht)
        for t, (d, wgt) in enumerate(vt):
            s.vd[j][t], s.vw[j][t] = d, wgt
        for t, (d, wgt) in enumerate(ht):
            s.hd[j][t], s.hw[j][t] = d, wgt
    return s
