"""Cluster kernel: clustering + ROCHADE straight from the raw frames.

``cluster_rochade_raw`` replaces the JAX package's
``pallas/cluster.py::cluster_rochade_raw``. On a CUDA tensor it launches
``csrc/cluster.cu`` (four launches behind one wrapper: blur + mask,
union-find, member sums, per-root record + append; the source's head notes
what bounds it and how the design answers); on a CPU tensor it runs
``cluster_rochade_raw_plain``, built from ops/frontend.py, ops/cluster.py
and ops/rochade.py.

Differences from the TPU kernel, by design:

* the labeling is global, so there is no blob-size cap: the second
  counter (clusters dropped at the TPU kernel's member-scan window) is
  always 0;
* the centroid is the plain mean (integer sums over the f32 count), not
  the TPU kernel's ``sum(col - cstart)/cnt + cstart``; both round to the
  same pixel unless the mean lies within f32 rounding of a .5 tie, which
  integer means of blobs under ~1000 pixels cannot;
* accepted rows are appended in no particular order;
  ``saddles_from_candidates`` restores scan order by a stable label sort.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.cluster import cluster_centroids
from ..ops.frontend import gaussian_blur, hessian_response
from ..ops.geometry import rust_round
from ..ops.rochade import Saddles, fit_record, fit_taps, gather_patches, saddle_angles
from . import LAUNCHES
from ._lib import check, lib, require_cuda, stream_of
from .frontend import _taps, check_raw, raw_luma

_CAPF = 1024  # accepted-candidate capacity PER FRAME (append-compacted)


class _FitTaps(ctypes.Structure):
    """Mirror of ``FitTaps`` in csrc/cluster.cu."""

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


def _fit_struct(half_patch: int) -> _FitTaps:
    cone, fits = fit_taps(half_patch)
    s = _FitTaps()
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


def cluster_from_blur_plain(blur: torch.Tensor, thr: torch.Tensor,
                            hp2: int = 4, move_thr: float = 1.0):
    """Plain cluster + ROCHADE on (B, h, w) blur planes: mask
    ``resp < thr`` inside the image's zero border, label the 4-connected
    components, round each centroid, gate the 9x9 support on the image
    and fit. Returns what ``cluster_rochade_raw`` returns, rows in scan
    order."""
    b, h, w = blur.shape
    dev = blur.device
    resp = hessian_response(blur)
    r = torch.arange(h, device=dev)[:, None]
    c = torch.arange(w, device=dev)[None, :]
    inner = (r > 0) & (r < h - 1) & (c > 0) & (c < w - 1)
    mask = inner & (resp < thr[:, None, None])
    fields = torch.zeros((b, _CAPF, 8), dtype=torch.float32, device=dev)
    counts = torch.zeros((b, 2), dtype=torch.float32, device=dev)
    for i in range(b):
        root, centers = cluster_centroids(mask[i])
        rx = rust_round(centers[:, 0]).to(torch.int64)
        ry = rust_round(centers[:, 1]).to(torch.int64)
        in_b = (ry - hp2 >= 0) & (ry + hp2 < h) & (rx - hp2 >= 0) & (rx + hp2 < w)
        x0, y0, c3, c4, c5, ok = fit_record(
            gather_patches(blur[i], rx, ry, hp2 // 2), hp2 // 2, move_thr
        )
        acc = in_b & ok
        rows = torch.stack(
            [
                rx.to(torch.float32) + x0, ry.to(torch.float32) + y0,
                torch.zeros_like(x0), c3, c4, c5, torch.ones_like(x0),
                (root + 1).to(torch.float32),
            ],
            -1,
        )[acc][:_CAPF]
        fields[i, : rows.shape[0]] = rows
        counts[i, 0] = rows.shape[0]
    return fields, counts


def cluster_rochade_raw_plain(raw_p, thr, h, w, channels=1, u16=False,
                              sigma=1.5, hp2=4, move_thr=1.0):
    """Plain PyTorch version of ``cluster_rochade_raw``."""
    lf, _ = raw_luma(raw_p[:, 8 : 8 + h, : w * channels], channels, u16)
    return cluster_from_blur_plain(gaussian_blur(lf, sigma), thr, hp2, move_thr)


def cluster_rochade_raw(
    raw_p: torch.Tensor,  # pad_raw() output: (B, Hp+16, Wp*C) u8/u16
    thr: torch.Tensor,    # (B,) f32
    h: int,
    w: int,
    channels: int = 1,
    u16: bool = False,
    sigma: float = 1.5,
    hp2: int = 4,
    move_thr: float = 1.0,
):
    """Accepted candidate saddles, append-compacted per frame.

    Returns (fields (B, _CAPF, 8) f32: [x, y, k, c3, c4, c5, ok, label+1]
    with k left 0 (saddles_from_candidates derives it), counters (B, 2)
    f32: [#appended (== _CAPF signals possible overflow), #clusters
    dropped — always 0, the labeling has no blob-size cap])."""
    check_raw(raw_p, channels, u16, "cluster_rochade_raw")
    if hp2 != 4:
        raise ValueError("cluster_rochade_raw: the fit takes half_patch 2 (hp2=4)")
    if h * w >= 2**24:
        raise ValueError(
            f"{h}x{w}: scan-order labels exceed f32's exact-integer range"
        )
    if thr.shape != (raw_p.shape[0],) or thr.dtype != torch.float32:
        raise ValueError("cluster_rochade_raw: thr must be (B,) f32")
    if raw_p.device.type == "cpu":
        return cluster_rochade_raw_plain(
            raw_p, thr, h, w, channels, u16, sigma, hp2, move_thr
        )
    require_cuda(raw_p, "cluster_rochade_raw")
    if thr.device != raw_p.device:
        raise ValueError("cluster_rochade_raw: thr must be on raw_p's device")
    b, rows, _ = raw_p.shape
    h_pad, w_pad = rows - 16, raw_p.shape[2] // channels
    dev = raw_p.device
    thr = thr.contiguous()
    blur = torch.empty((b, h_pad, w_pad), dtype=torch.float32, device=dev)
    labels = torch.empty((b, h_pad, w_pad), dtype=torch.int32, device=dev)
    cnt = torch.empty((b, h_pad, w_pad), dtype=torch.int32, device=dev)
    sums = torch.empty((b, h_pad, w_pad, 2), dtype=torch.int64, device=dev)
    napp = torch.zeros((b,), dtype=torch.int32, device=dev)
    fields = torch.zeros((b, _CAPF, 8), dtype=torch.float32, device=dev)
    taps = _taps(sigma)
    fit = _fit_struct(hp2 // 2)
    err = lib().ag_cluster_rochade_raw(
        raw_p.data_ptr(), b, h_pad, w_pad, channels, int(u16), h, w,
        thr.data_ptr(), ctypes.addressof(taps), ctypes.addressof(fit),
        float(move_thr), hp2, blur.data_ptr(), labels.data_ptr(),
        cnt.data_ptr(), sums.data_ptr(), napp.data_ptr(), fields.data_ptr(),
        _CAPF, stream_of(raw_p),
    )
    check(err, "cluster_rochade_raw")
    LAUNCHES["cluster_rochade_raw"] += 1
    counts = torch.stack(
        [torch.clamp(napp, max=_CAPF).to(torch.float32),
         torch.zeros((b,), dtype=torch.float32, device=dev)], 1,
    )
    return fields, counts


def sort_candidates(fields: torch.Tensor):
    """(B, _CAPF, 8) candidate arrays in label order, and their valid mask.

    One stable sort per frame by the stored label (invalid rows keyed to
    +inf) restores the reference's scan-order cluster enumeration
    (src/detector.rs:171-187): labels are ascending linear pixel indices."""
    valid = (fields[..., 7] > 0.5) & (fields[..., 6] > 0.5)
    key = torch.where(valid, fields[..., 7], torch.full_like(fields[..., 7], float("inf")))
    order = torch.argsort(key, dim=-1, stable=True)
    fields = torch.gather(fields, 1, order[..., None].expand(fields.shape))
    return fields, torch.gather(valid, 1, order)


def saddles_from_candidates(fields: torch.Tensor) -> Saddles:
    """(B, _CAPF, 8) candidate arrays -> Saddles SoA (pre k/phi gates),
    rows in label order (``sort_candidates``). The angles
    (src/detector.rs:344-353) are derived here, once per row."""
    fields, valid = sort_candidates(fields)
    c3, c4, c5 = fields[..., 3], fields[..., 4], fields[..., 5]
    k, theta, phi = saddle_angles(c3, c4, c5)
    return Saddles(p=fields[..., 0:2], k=k, theta=theta, phi=phi, valid=valid)
