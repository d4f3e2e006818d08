"""Cluster kernel: clustering + ROCHADE straight from the raw frames.

``cluster_rochade_raw`` replaces the JAX package's
``pallas/cluster.py::cluster_rochade_raw``. On a CUDA tensor it launches
``csrc/cluster.cu`` (five launches behind one wrapper: blur + mask over the
pixels, which also starts a compact list of the masked pixels; then
union-find, root list, member sums over that list and a warp per root for
record + append; the source's head notes what bounds it and how the design
answers); on a CPU tensor it runs
``cluster_rochade_raw_plain``, built from ops/frontend.py, ops/cluster.py
and ops/rochade.py. Its ``luma_f32`` mode (the turbo path's drain variant)
reads an f32 half-resolution luma plane instead of raw pixels.

``cluster_rochade`` replaces ``pallas/cluster.py::cluster_rochade``, the
blur-fed twin: it takes the padded f32 blur plane (``front_kernel(...,
emit_blur=True)`` or ``fused_frontend(..., crop=False)``) and skips the
gray + blur stencil (its dense launch is the mask alone); the list
launches are the same. Fed the blur of the same frame it returns what
``cluster_rochade_raw`` returns, bit for bit after ``sort_candidates``.

Differences from the TPU kernel, by design:

* the labeling is global, so there is no sweep window: the TPU kernel's
  requirement that the padded height cover one window (``hp >= _WIN``)
  has no counterpart, frames of any height are served;

* the labeling is global, so there is no blob-size cap: the second
  counter (clusters dropped at the TPU kernel's member-scan window) is
  always 0;
* the centroid is the plain mean (integer sums over the f32 count), not
  the TPU kernel's ``sum(col - cstart)/cnt + cstart``; both round to the
  same pixel unless the mean lies within f32 rounding of a .5 tie, which
  integer means of blobs under ~1000 pixels cannot;
* accepted rows are appended in no particular order;
  ``saddles_from_candidates`` restores scan order by a stable label sort;
* the turbo (``luma_f32``) mode has no blob pre-filter and no window
  height: the TPU kernel's ``prefilter=True`` drops a blob unless a member
  lies next to a pixel whose record is accepted, and its ``win=160``
  shortens the sweep window, both to cut its serial root drain; neither
  changes which blobs are accepted on the scenes the tests hold it to
  (``tests/test_torch_decimate.py``), and the JAX package's own plain
  turbo path has no such filter either;
* the row-sharding mode masks in the window's own rows (0, h-1) as well
  as the frame's and gates the rounded centroid in both, so every read
  stays in the window; the TPU kernel masks in its sweep window's rows and
  the frame's. On the rows a window claims the two agree
  (``tests/test_torch_cluster.py::test_cluster_row_off_matches_jax``).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.cluster import cluster_centroids
from ..ops.frontend import gaussian_blur, hessian_response
from ..ops.geometry import rust_round
from ..ops.rochade import Saddles, fit_record, gather_patches, saddle_angles
from . import LAUNCHES
from ._fit import fit_struct
from ._lib import check, launch, require_cuda
from .frontend import _taps, check_raw, check_rows, raw_luma

_CAPF = 1024  # accepted-candidate capacity PER FRAME (append-compacted)
_MODE_F32 = 2  # csrc/stencil.cuh: the frame is an f32 luma plane


def candidate_mask_plain(blur: torch.Tensor, thr: torch.Tensor, ro: int = 0,
                         gh: int | None = None) -> torch.Tensor:
    """The cluster mask of one (h, w) blur plane: ``resp < thr`` inside the
    image's one-pixel border and, for a window (row r is row r + ``ro`` of
    a ``gh``-row frame), inside the frame's."""
    h, w = blur.shape
    gh = h if gh is None else gh
    resp = hessian_response(blur)
    r = torch.arange(h, device=blur.device)[:, None]
    c = torch.arange(w, device=blur.device)[None, :]
    return ((r > 0) & (r < h - 1) & (r + ro > 0) & (r + ro < gh - 1)
            & (c > 0) & (c < w - 1) & (resp < thr))


def candidate_rows_plain(blur: torch.Tensor, thr: torch.Tensor,
                         hp2: int = 4, move_thr: float = 1.0, ro: int = 0,
                         gh: int | None = None) -> torch.Tensor:
    """Every accepted candidate row (K, 8) of one (h, w) blur plane, in
    scan order and before the capacity cut: mask ``resp < thr`` inside the
    image's zero border, label the 4-connected components, round each
    centroid, gate the 9x9 support on the image and fit. A window (row r is
    row r + ``ro`` of a ``gh``-row frame) gates in its own rows and the
    frame's and emits y in the frame's rows."""
    h, w = blur.shape
    gh = h if gh is None else gh
    root, centers = cluster_centroids(candidate_mask_plain(blur, thr, ro, gh))
    rx = rust_round(centers[:, 0]).to(torch.int64)
    ry = rust_round(centers[:, 1]).to(torch.int64)
    in_b = ((ry - hp2 >= 0) & (ry + hp2 < h) & (ry + ro - hp2 >= 0) & (ry + ro + hp2 < gh)
            & (rx - hp2 >= 0) & (rx + hp2 < w))
    x0, y0, c3, c4, c5, ok = fit_record(
        gather_patches(blur, rx, ry, hp2 // 2), hp2 // 2, move_thr
    )
    rows = torch.stack(
        [
            rx.to(torch.float32) + x0, (ry + ro).to(torch.float32) + y0,
            torch.zeros_like(x0), c3, c4, c5, torch.ones_like(x0),
            (root + 1).to(torch.float32),
        ],
        -1,
    )
    return rows[in_b & ok]


def cluster_from_blur_plain(blur: torch.Tensor, thr: torch.Tensor,
                            hp2: int = 4, move_thr: float = 1.0,
                            row_off: torch.Tensor | None = None,
                            global_h: int | None = None):
    """Plain cluster + ROCHADE on (B, h, w) blur planes
    (``candidate_rows_plain`` per frame, cut to the capacity; with
    ``row_off`` frame i is a window at row offset row_off[i] of a
    ``global_h``-row frame). Returns what ``cluster_rochade_raw`` returns,
    rows in scan order."""
    b = blur.shape[0]
    fields = torch.zeros((b, _CAPF, 8), dtype=torch.float32, device=blur.device)
    counts = torch.zeros((b, 2), dtype=torch.float32, device=blur.device)
    offs = [0] * b if row_off is None else [int(v) for v in row_off.tolist()]
    for i in range(b):
        rows = candidate_rows_plain(blur[i], thr[i], hp2, move_thr, offs[i],
                                    global_h)[:_CAPF]
        fields[i, : rows.shape[0]] = rows
        counts[i, 0] = rows.shape[0]
    return fields, counts


def raw_blur_plain(raw_p, h, w, channels=1, u16=False, sigma=1.5, luma_f32=False):
    """The (B, h, w) blur plane that ``cluster_rochade_raw_plain`` clusters:
    the blur of the padded frame, whose margins are the frame's replicated
    edges or a window's neighbouring rows."""
    lf = raw_p[:, :, : w * channels]
    if not luma_f32:
        lf, _ = raw_luma(lf, channels, u16)
    return gaussian_blur(lf, sigma)[:, 8 : 8 + h]


def cluster_rochade_raw_plain(raw_p, thr, h, w, channels=1, u16=False,
                              sigma=1.5, hp2=4, move_thr=1.0, luma_f32=False,
                              row_off=None, global_h=None):
    """Plain PyTorch version of ``cluster_rochade_raw``."""
    blur = raw_blur_plain(raw_p, h, w, channels, u16, sigma, luma_f32)
    return cluster_from_blur_plain(blur, thr, hp2, move_thr, row_off, global_h)


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
    luma_f32: bool = False,
    row_off: torch.Tensor | None = None,  # (B,) int32 window row offsets
    global_h: int | None = None,
):
    """Accepted candidate saddles, append-compacted per frame.

    With ``luma_f32`` the input is an f32 luma plane in the ``pad_half``
    layout (the turbo path's half plane from ``front_kernel_decimate``)
    and ``h, w`` are its true size: the blur reads the plane as it is,
    everything after is unchanged.

    Row sharding (the counterpart of ``cluster_rochade_raw``'s
    ``row_off``/``global_h``): frame i is a window whose row r is row
    r + row_off[i] of a ``global_h``-row frame, its margin and padding rows
    the frame's neighbouring rows. The mask and the rounded centroid's
    bounds gate hold in the window's rows and in the frame's; y is emitted
    in the frame's rows, the label stays the window's scan-order index.

    Returns (fields (B, _CAPF, 8) f32: [x, y, k, c3, c4, c5, ok, label+1]
    with k left 0 (saddles_from_candidates derives it), counters (B, 2)
    f32: [#appended (== _CAPF signals possible overflow), #clusters
    dropped — always 0, the labeling has no blob-size cap])."""
    check_raw(raw_p, channels, u16, "cluster_rochade_raw", luma_f32)
    row_off = check_rows(row_off, global_h, raw_p.shape[0], raw_p.device,
                         "cluster_rochade_raw")
    gh = h if row_off is None else global_h
    # the window's labels, and the frame's once a caller makes them global
    _check_fit_args("cluster_rochade_raw", raw_p, thr, max(h, gh), w, hp2)
    if raw_p.device.type == "cpu":
        return cluster_rochade_raw_plain(
            raw_p, thr, h, w, channels, u16, sigma, hp2, move_thr, luma_f32,
            row_off, global_h,
        )
    require_cuda(raw_p, "cluster_rochade_raw")
    b, rows, _ = raw_p.shape
    h_pad, w_pad = rows - 16, raw_p.shape[2] // channels
    thr = thr.contiguous()
    blur = torch.empty((b, h_pad, w_pad), dtype=torch.float32, device=raw_p.device)
    scratch = _scratch(blur)
    taps = _taps(sigma)
    fit = fit_struct(hp2 // 2)
    err = launch(
        "cluster_rochade_raw", raw_p,
        raw_p.data_ptr(), b, h_pad, w_pad, channels,
        _MODE_F32 if luma_f32 else int(u16), h, w, thr.data_ptr(),
        ctypes.addressof(taps), ctypes.addressof(fit),
        float(move_thr), hp2, None if row_off is None else row_off.data_ptr(), gh,
        blur.data_ptr(), *(t.data_ptr() for t in scratch), _CAPF,
    )
    check(err, "cluster_rochade_raw")
    key = "cluster_rochade_raw[luma_f32]" if luma_f32 else "cluster_rochade_raw"
    if row_off is not None:
        key = "cluster_rochade_raw[luma_f32,row_off]" if luma_f32 else "cluster_rochade_raw[row_off]"
    LAUNCHES[key] += 1
    return _results(scratch)


def _check_fit_args(name: str, frames: torch.Tensor, thr: torch.Tensor,
                    h: int, w: int, hp2: int) -> None:
    """The argument contract both cluster wrappers share."""
    if hp2 != 4:
        raise ValueError(f"{name}: the fit takes half_patch 2 (hp2=4)")
    # candidate rows store the scan-order label row*w + col + 1 as f32
    if w >= 2**16 or h * w >= 2**24:
        raise ValueError(
            f"{name}: {h}x{w} is beyond the label domain (w < 2^16, scan-order "
            "labels h*w < 2^24 exact in f32); such frames take the plane path "
            "(pipeline.planes_frontend_batch), which saddle_frontend_batch "
            "routes them to"
        )
    if thr.shape != (frames.shape[0],) or thr.dtype != torch.float32:
        raise ValueError(f"{name}: thr must be (B,) f32")
    if thr.device != frames.device:
        raise ValueError(f"{name}: thr must be on the frames' device")


def _scratch(blur: torch.Tensor):
    """Device scratch and outputs of the component launches for a
    (B, Hp, Wp) blur plane: ``labels`` and the masked-pixel list ``plist``
    (a pixel each), the root list ``rlist`` with the member count ``cnt``
    and the row/column sums ``sums`` per root slot (half the pixels: two
    horizontal neighbours never root two components), the zeroed cursors
    ``ctr`` (3, B) — pixels listed, roots listed, rows appended — and the
    zeroed ``fields``, in the order of the C entries' arguments. Only list
    entries in use are ever touched."""
    b, dev = blur.shape[0], blur.device
    half = blur.shape[1] * blur.shape[2] // 2
    labels = torch.empty(blur.shape, dtype=torch.int32, device=dev)
    plist = torch.empty(blur.shape, dtype=torch.int32, device=dev)
    rlist = torch.empty((b, half), dtype=torch.int32, device=dev)
    cnt = torch.empty((b, half), dtype=torch.int32, device=dev)
    sums = torch.empty((b, half, 2), dtype=torch.int64, device=dev)
    ctr = torch.zeros((3, b), dtype=torch.int32, device=dev)
    fields = torch.zeros((b, _CAPF, 8), dtype=torch.float32, device=dev)
    return labels, plist, rlist, cnt, sums, ctr, fields


def _results(scratch):
    """What the wrappers return, from the scratch the launches filled:
    the fields and the counters [rows appended, capped at the capacity; 0]."""
    ctr, fields = scratch[-2:]
    counts = torch.zeros((fields.shape[0], 2), dtype=torch.float32, device=fields.device)
    counts[:, 0] = torch.clamp(ctr[2], max=_CAPF)
    return fields, counts


def cluster_rochade_plain(blur: torch.Tensor, thr: torch.Tensor, h: int, w: int,
                          hp2: int = 4, move_thr: float = 1.0):
    """Plain PyTorch version of ``cluster_rochade``."""
    return cluster_from_blur_plain(blur[:, :h, :w], thr, hp2, move_thr)


def cluster_rochade(
    blur: torch.Tensor,   # (B, Hp, Wp) f32, padded
    thr: torch.Tensor,    # (B,) f32
    h: int,               # true image height
    w: int,               # true image width
    hp2: int = 4,
    move_thr: float = 1.0,
):
    """``cluster_rochade_raw`` fed the padded blur plane instead of raw
    frames: accepted candidate saddles of the (h, w) image in the top-left
    corner of ``blur``, append-compacted per frame; same returns. The
    plane has no margin rows above the image (``pad_raw`` arrays have 8)."""
    if blur.ndim != 3 or blur.dtype != torch.float32 or not blur.is_contiguous():
        raise ValueError("cluster_rochade: blur must be a contiguous (B, Hp, Wp) f32 plane")
    hp, wp = blur.shape[1:]
    if hp % 8 or wp % 128 or hp < h or wp < w:
        raise ValueError(
            f"cluster_rochade: a {hp}x{wp} plane is not a padded layout of a "
            f"{h}x{w} image (rows a multiple of 8, columns of 128)"
        )
    _check_fit_args("cluster_rochade", blur, thr, h, w, hp2)
    if blur.device.type == "cpu":
        return cluster_rochade_plain(blur, thr, h, w, hp2, move_thr)
    require_cuda(blur, "cluster_rochade")
    thr = thr.contiguous()
    scratch = _scratch(blur)
    fit = fit_struct(hp2 // 2)
    err = launch(
        "cluster_rochade", blur,
        blur.data_ptr(), blur.shape[0], hp, wp, h, w, thr.data_ptr(),
        ctypes.addressof(fit), float(move_thr), hp2,
        *(t.data_ptr() for t in scratch), _CAPF,
    )
    check(err, "cluster_rochade")
    LAUNCHES["cluster_rochade"] += 1
    return _results(scratch)


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
