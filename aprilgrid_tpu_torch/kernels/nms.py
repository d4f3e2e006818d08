"""NMS extraction kernel: the turbo path's clustering-free candidate
extraction at half resolution.

``nms_extract_raw`` replaces the JAX package's
``pallas/nms.py::nms_extract_raw``. On a CUDA tensor it launches
``csrc/nms.cu``, three launches over 64 x 64 tiles behind one wrapper: the
blur and the masked response on the front and cluster kernels' tile passes
(``csrc/tile.cuh``) with a flag per tile, bound as those kernels are; the
record gate on the flagged tiles, where the ROCHADE fit's cone smoothing is
one stencil of the whole tile that its masked pixels share
(``ops/rochade.py::record_planes`` states the premise in PyTorch), bound by
instruction throughput; the peaks, a warp's fit each, into the cell grid.
With the peak merge (``merge`` > 0) the first launch also writes the relay
mask as bits, and the third launch is the merge in its place: on each
flagged tile with an 8-pixel halo it finds the peaks, runs the sweeps with
the keys in registers (stopping at a sweep that moves none) and emits the
surviving peaks. The source's head has the details. On a CPU tensor it
runs ``nms_extract_raw_plain``.

The function, on the half-resolution luma plane of ``front_kernel_decimate``:

1. blur (7 taps) and Hessian response; ``mask`` = response < thr strictly
   inside the image;
2. the ROCHADE record (``ops/rochade.py::fit_record``) at the masked
   pixels; candidate = mask & record accepted & at least 4 pixels from
   every image edge;
3. peak = a candidate whose response equals the minimum over the
   candidates of its 7x7 window ("plateau" pixel), and that no plateau
   pixel of that window precedes in scan order;
4. with ``merge`` = m in 1..8, the geodesic peak merge: every peak starts a
   key, its position ``row << 16 | col``; m sweeps of four chained
   single-step passes (from +x, -x, +y, -y) each let a pixel of ``mask``
   take its neighbour's key where that key is smaller; a peak survives
   where its own key is still there. Peaks of one response blob at most m
   steps apart along the mask collapse onto the first in scan order;
   separate blobs never merge (``merge_peaks_plain``);
5. each peak's record ``[col + x0, row + y0, c3, c4, c5, row*w + col + 1]``
   lands in its aligned 4x4 cell of a zero-filled (6, Hp/4, Wp/4) grid —
   peaks are more than 3 pixels apart, so a cell holds at most one.

``cells_to_fields`` compacts the grid to the cluster kernel's candidate
layout. The cell grid, rather than an atomic append, keeps the overflow
case (more peaks than the capacity) independent of thread timing.

Row sharding (``row_off``/``global_h``, the contract of
``cluster_rochade_raw``): the plane is a window whose row r is row
``r + row_off`` of a ``global_h``-row frame. The image-edge gates of steps
1 and 2 then hold in the window's rows and in the frame's, and y and the
scan-order label are emitted in the frame's rows; the cell grid stays the
window's.

Differences from the TPU kernel, by design: only tiles that hold a masked
pixel evaluate the smoothed plane, and only masked pixels the record (the
TPU kernel evaluates it at every pixel); the TPU kernel merges in 160-row
windows and restricts the keys to peaks whose verdict has full context,
which equals the merge of the whole plane done here.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.frontend import gaussian_blur, hessian_response
from ..ops.rochade import fit_record, gather_patches
from . import LAUNCHES
from ._fit import fit_struct
from ._lib import check, launch, require_cuda
from .frontend import _taps, check_raw, check_rows

_R = 3          # Chebyshev radius of the peak window
_CELL = 4       # cell edge: peaks are > _R apart, so <= 1 per aligned cell
_BIGF = 3.0e38  # masked-out response (csrc/nms.cu: BIGF)
MERGE_MAX = 8   # sweeps of the peak merge (csrc/nms.cu: MERGE_MAX)


def _minfilt(x: torch.Tensor, fill) -> torch.Tensor:
    """Minimum over the (2*_R+1)^2 window around every element of the
    last two axes; elements outside the plane count as ``fill``."""
    h, w = x.shape[-2:]
    pad = torch.nn.functional.pad(x, (_R, _R), value=fill)
    out = pad[..., 0:w]
    for d in range(1, 2 * _R + 1):
        out = torch.minimum(out, pad[..., d : d + w])
    pad = torch.nn.functional.pad(out, (0, 0, _R, _R), value=fill)
    out = pad[..., 0:h, :]
    for d in range(1, 2 * _R + 1):
        out = torch.minimum(out, pad[..., d : d + h, :])
    return out


def nms_peaks_plain(cand_resp: torch.Tensor) -> torch.Tensor:
    """(..., h, w) candidate responses (``_BIGF`` where not a candidate)
    -> bool peaks: plateau pixels (response equal to their window's
    minimum) that no plateau pixel of their window precedes in scan
    order."""
    h, w = cand_resp.shape[-2:]
    cand = cand_resp < _BIGF
    plateau = cand & (cand_resp == _minfilt(cand_resp, _BIGF))
    pos = torch.arange(h * w, device=cand_resp.device).reshape(h, w)
    big = h * w
    posm = torch.where(plateau, pos, torch.full_like(pos, big))
    return plateau & (pos == _minfilt(posm, big))


def merge_peaks_plain(peaks: torch.Tensor, relay: torch.Tensor,
                      sweeps: int) -> torch.Tensor:
    """Geodesic peak merge on (..., h, w) bool planes: every peak's key is
    its position ``row << 16 | col``; each of ``sweeps`` sweeps runs four
    chained single-step passes, taking the key of the neighbour at +x, -x,
    +y, -y in that order where ``relay`` holds and that key is smaller. A
    peak survives where its own key is still there at the end."""
    h, w = peaks.shape[-2:]
    dev = peaks.device
    big = 2**62
    pos = (torch.arange(h, device=dev)[:, None] << 16) | torch.arange(w, device=dev)[None, :]
    key = torch.where(peaks, pos, torch.full_like(pos, big))
    for _ in range(sweeps):
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            nk = torch.full_like(key, big)
            nk[..., max(-dy, 0) : h - max(dy, 0), max(-dx, 0) : w - max(dx, 0)] = (
                key[..., max(dy, 0) : h - max(-dy, 0), max(dx, 0) : w - max(-dx, 0)]
            )
            key = torch.where(relay & (nk < key), nk, key)
    return peaks & (key == pos)


def _row_offsets(b: int, row_off, dev) -> torch.Tensor:
    """(B,) int64 row offsets of the windows (zeros without row sharding)."""
    if row_off is None:
        return torch.zeros(b, dtype=torch.int64, device=dev)
    return row_off.to(device=dev, dtype=torch.int64)


def nms_planes_plain(half_p, thr, h, w, sigma=1.5, hp2=4, row_off=None, global_h=None):
    """Steps 1 and 2's planes before the fit, (B, h, w) each: the blur, its
    Hessian response, ``mask`` (response < thr strictly inside the window
    and the frame: the merge's relay mask) and the margin (at least hp2
    pixels inside both). The kernel's first launch stores the blur, the
    response where mask and margin hold (else ``_BIGF``) and, with the
    merge, the mask as bits."""
    b = half_p.shape[0]
    dev = half_p.device
    # the blur of the padded plane: its margins are the frame's replicated
    # edges, or a window's neighbouring rows
    blur = gaussian_blur(half_p[:, :, :w], sigma)[:, 8 : 8 + h]
    resp = hessian_response(blur)
    gh = h if global_h is None else global_h
    r = torch.arange(h, device=dev)[:, None]
    g = r + _row_offsets(b, row_off, dev)[:, None, None]
    c = torch.arange(w, device=dev)[None, :]
    inner = (r > 0) & (r < h - 1) & (g > 0) & (g < gh - 1) & (c > 0) & (c < w - 1)
    inb = ((r >= hp2) & (r < h - hp2) & (g >= hp2) & (g < gh - hp2)
           & (c >= hp2) & (c < w - hp2))
    return blur, resp, inner & (resp < thr[:, None, None]), inb


def nms_extract_raw_plain(half_p, thr, h, w, sigma=1.5, hp2=4, move_thr=1.0,
                          merge=0, row_off=None, global_h=None):
    """Plain PyTorch version of ``nms_extract_raw``."""
    b = half_p.shape[0]
    dev = half_p.device
    blur, resp, mask, inb = nms_planes_plain(half_p, thr, h, w, sigma, hp2, row_off,
                                             global_h)
    ro = _row_offsets(b, row_off, dev)   # frame row of window row r: r + ro
    cand_resp = torch.full_like(resp, _BIGF)
    rec = torch.zeros((b, 5, h, w), dtype=torch.float32, device=dev)
    for i in range(b):
        ys, xs = torch.nonzero(mask[i] & inb[i], as_tuple=True)
        x0, y0, c3, c4, c5, ok = fit_record(
            gather_patches(blur[i], xs, ys, hp2 // 2), hp2 // 2, move_thr
        )
        ys, xs = ys[ok], xs[ok]
        cand_resp[i, ys, xs] = resp[i, ys, xs]
        rec[i][:, ys, xs] = torch.stack(
            [xs.to(torch.float32) + x0[ok], (ys + ro[i]).to(torch.float32) + y0[ok],
             c3[ok], c4[ok], c5[ok]]
        )
    peaks = nms_peaks_plain(cand_resp)
    if merge:
        peaks = merge_peaks_plain(peaks, mask, merge)
    cells = torch.zeros(
        (b, 6, (half_p.shape[1] - 16) // _CELL, half_p.shape[2] // _CELL),
        dtype=torch.float32, device=dev,
    )
    bi, ys, xs = torch.nonzero(peaks, as_tuple=True)
    cells[bi, :5, ys // _CELL, xs // _CELL] = rec[bi, :, ys, xs]
    cells[bi, 5, ys // _CELL, xs // _CELL] = ((ys + ro[bi]) * w + xs + 1).to(torch.float32)
    return cells


def nms_extract_raw(
    half_p: torch.Tensor,  # pad_half layout: (B, Hp+16, Wp) f32 luma
    thr: torch.Tensor,     # (B,) f32
    h: int,
    w: int,
    sigma: float = 1.5,
    hp2: int = 4,
    move_thr: float = 1.0,
    merge: int = 0,
    row_off: torch.Tensor | None = None,  # (B,) int32 window row offsets
    global_h: int | None = None,
):
    """Dense per-cell candidate records: (B, 6, Hp/4, Wp/4) f32 with plane
    order [x, y, c3, c4, c5, label+1]; label+1 >= 1 doubles as the
    presence bit. ``h, w`` are the half plane's true size; ``merge`` (0-8)
    the sweeps of the geodesic peak merge; ``row_off``/``global_h`` the
    row-sharding contract of the module's head. Compact with
    ``cells_to_fields``."""
    check_raw(half_p, 1, False, "nms_extract_raw", luma_f32=True)
    if not 0 <= merge <= MERGE_MAX:
        raise ValueError(f"nms_extract_raw: merge must be 0-{MERGE_MAX}, got {merge}")
    if hp2 != 4:
        raise ValueError("nms_extract_raw: the fit takes half_patch 2 (hp2=4)")
    b = half_p.shape[0]
    row_off = check_rows(row_off, global_h, b, half_p.device, "nms_extract_raw")
    gh = h if row_off is None else global_h
    # the label counts the frame's rows
    if gh * w >= 2**24:
        raise ValueError(f"{gh}x{w}: scan-order labels exceed f32's exact-integer range")
    if thr.shape != (b,) or thr.dtype != torch.float32:
        raise ValueError("nms_extract_raw: thr must be (B,) f32")
    if half_p.device.type == "cpu":
        return nms_extract_raw_plain(half_p, thr, h, w, sigma, hp2, move_thr,
                                     merge, row_off, global_h)
    require_cuda(half_p, "nms_extract_raw")
    if thr.device != half_p.device:
        raise ValueError("nms_extract_raw: thr must be on half_p's device")
    cells, _ = _launch(half_p, thr, h, w, sigma, hp2, move_thr, merge, row_off, gh)
    # the row-sharding mode and the merge count apart from the plain launches
    key = "nms_extract_raw[merge]" if merge else "nms_extract_raw"
    LAUNCHES["nms_extract_raw[row_off]" if row_off is not None else key] += 1
    return cells


def _launch(half_p, thr, h, w, sigma, hp2, move_thr, merge, row_off, gh):
    """The CUDA entry on checked arguments: (cells, flags), where after a
    merge each tile's flag is the number of sweeps its block ran (0: no
    candidate in the tile), which the smoke's histogram reads."""
    b = half_p.shape[0]
    dev = half_p.device
    h_pad, w_pad = half_p.shape[1] - 16, half_p.shape[2]
    thr = thr.contiguous()
    blur = torch.empty((b, h_pad, w_pad), dtype=torch.float32, device=dev)
    cand = torch.empty((b, h_pad, w_pad), dtype=torch.float32, device=dev)
    flags = torch.empty((b, h_pad // 64, w_pad // 64), dtype=torch.int32, device=dev)
    cells = torch.zeros(
        (b, 6, h_pad // _CELL, w_pad // _CELL), dtype=torch.float32, device=dev
    )
    # the merge's relay mask, a bit a pixel: every tile writes its words
    relay = None
    if merge:
        relay = torch.empty((b, h_pad, w_pad // 32), dtype=torch.int32, device=dev)
    taps = _taps(sigma)
    fit = fit_struct(hp2 // 2)
    err = launch(
        "nms_extract_raw", half_p,
        half_p.data_ptr(), b, h_pad, w_pad, h, w, thr.data_ptr(),
        ctypes.addressof(taps), ctypes.addressof(fit), float(move_thr), hp2, None if row_off is None else row_off.data_ptr(), gh,
        merge, blur.data_ptr(), cand.data_ptr(), flags.data_ptr(),
        None if relay is None else relay.data_ptr(), cells.data_ptr(),
    )
    if err == -1:
        raise ValueError(
            "nms_extract_raw: the fit's tap tables are not in the order the "
            "tile kernel takes (csrc/rochade.cuh::fit_tile_taps)"
        )
    check(err, "nms_extract_raw")
    return cells, flags


def cells_to_fields(cells: torch.Tensor, capf: int = 1024):
    """(B, 6, R, C) cell records -> the candidate layout of the cluster
    kernel, (B, capf, 8) rows [x, y, k=0, c3, c4, c5, ok, label+1], and
    the number of peaks per frame (B,) f32 for the overflow counters. The
    first ``capf`` occupied cells are kept, in cell order;
    ``saddles_from_candidates``'s label sort then restores scan order."""
    b = cells.shape[0]
    flat = cells.reshape(b, 6, -1)
    valid = flat[:, 5] > 0.5
    n = valid.sum(-1).to(torch.float32)
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)[:, :capf]
    if order.shape[1] < capf:
        # fewer cells than slots: repeat the last, a free cell (occupied
        # cells sort first, and cell (0, 0) lies in the margin, always free)
        order = torch.cat(
            [order, order[:, -1:].expand(b, capf - order.shape[1])], dim=1
        )
    take = torch.gather(flat, 2, order[:, None, :].expand(b, 6, capf))
    okcol = (take[:, 5] > 0.5).to(torch.float32)
    fields = torch.stack(
        [take[:, 0], take[:, 1], torch.zeros_like(okcol), take[:, 2],
         take[:, 3], take[:, 4], okcol, take[:, 5]],
        dim=-1,
    )
    return fields, n
