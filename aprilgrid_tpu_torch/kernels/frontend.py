"""Front kernels: raw frames or luma planes -> luma, blur and response.

``front_kernel`` replaces the JAX package's
``pallas/frontend.py::front_kernel``: padded raw frames -> u8 luma plane +
response tile minima (the exact hybrid path), and with ``emit_blur=True``
also the padded f32 blur plane that feeds ``cluster_rochade``. On a CUDA
tensor it launches ``csrc/frontend.cu::front_tile_kernel``; on a CPU
tensor it runs ``front_kernel_plain``, the same function in plain PyTorch.
What bounds each kernel on the H100 and what its design does about it is
noted at the top of ``csrc/frontend.cu`` (for ``front_kernel``: what bound
the first version as measured, and how the register-blocked stencil that
replaced it answers that).

``front_kernel_decimate`` replaces
``pallas/frontend.py::front_kernel_decimate``, the turbo path's front
kernel: the same luma8, plus the half-resolution f32 luma plane (2x2 mean)
and the response minima taken at half resolution, in one launch of
``csrc/frontend.cu::front_decimate_kernel`` on a CUDA tensor.

``fused_frontend`` replaces ``pallas/frontend.py::fused_frontend``, the
plane path's stencil: f32 luma planes -> blur and Hessian-response planes,
cropped to the input or padded with per-tile response minima.

``gray_kernel`` replaces ``pallas/frontend.py::gray_kernel``: bare raw
frames -> padded f32 and u8 luma planes.

``pad_raw`` lays the frames out as the front, cluster and refine kernels
read them; ``pad_half`` does the same for a half-resolution luma plane.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.frontend import decimate2, gaussian_blur, gaussian_kernel, hessian_response
from ..ops.gray import raw_luma
from . import LAUNCHES
from ._lib import check, launch, require_cuda

TILE_H = 64    # image rows per tile (the TPU kernel's grid step)
STRIP_W = 64   # image columns per CUDA block
# front_kernel_decimate on a window: its first and last half rows blur into
# the window's own replicated edge rows, so their responses are left to the
# neighbouring window (csrc/frontend.cu: the decimating kernel's Rows)
_WINDOW_INSET = 4


def _raw_mode(img: torch.Tensor, name: str):
    """(B, H, W[, C]) raw frames -> (frames without alpha, channels, u16).
    The in-kernel gray conversion handles exactly three raw modes (u8
    gray, u16 gray, u8 RGB); anything else (LA, RGB16, f32) must be
    folded first by pipeline.normalize_raw_batch, which the detector does."""
    if img.ndim == 4 and img.shape[3] == 4 and img.dtype == torch.uint8:
        img = img[..., :3]  # alpha is ignored (ops/gray.py semantics)
    channels = img.shape[3] if img.ndim == 4 else 1
    u16 = img.dtype == torch.uint16
    if img.ndim not in (3, 4) or channels not in (1, 3) or (u16 and channels != 1) or (
        img.dtype not in (torch.uint8, torch.uint16)
    ):
        raise TypeError(
            f"{name}: unsupported raw mode (shape={tuple(img.shape)}, "
            f"dtype={img.dtype}); fold exotic DynamicImage modes with "
            "pipeline.normalize_raw_batch first"
        )
    return img, channels, u16


def padded_shape(h: int, w: int) -> tuple[int, int]:
    """(Hp, Wp) of an (h, w) plane: 64-row tiles, 128-column alignment."""
    return -(-h // TILE_H) * TILE_H, -(-w // 128) * 128


def _edge_pad(plane: torch.Tensor, h_pad: int, w_pad: int, margin: int = 0) -> torch.Tensor:
    """(B, hin, win[, C]) -> (B, h_pad + 2*margin, w_pad[, C]): ``margin``
    rows above the plane, rows up to ``h_pad`` (+ ``margin``) below and
    columns up to ``w_pad``, every element outside the plane a replica of
    the plane's own nearest edge value."""
    hin, win = plane.shape[1:3]
    if (hin, win) == (h_pad, w_pad) and margin == 0:
        return plane
    dev = plane.device
    rows = torch.clamp(torch.arange(-margin, h_pad + margin, device=dev), 0, hin - 1)
    cols = torch.clamp(torch.arange(w_pad, device=dev), max=win - 1)
    return plane[:, rows][:, :, cols]


def pad_raw(img: torch.Tensor):
    """Edge-pad raw frames for the fused kernels: 8 rows above, row/lane
    alignment below/right, channels flattened into the row. Returns
    (padded (B, Hp+16, Wp*C), h, w, channels, u16) with Hp = ceil(h/64)*64
    and Wp = ceil(w/128)*128 — the same padded array feeds both kernels."""
    img, channels, u16 = _raw_mode(img, "pad_raw")
    b, hgt, wid = img.shape[:3]
    h_pad, w_pad = padded_shape(hgt, wid)
    # index through the int16 view: u16 indexing is not served everywhere
    src = img.view(torch.int16) if u16 else img
    out = _edge_pad(src, h_pad, w_pad, 8).reshape(b, h_pad + 16, w_pad * channels)
    if u16:
        out = out.view(torch.uint16)
    return out.contiguous(), hgt, wid, channels, u16


def _zero_border(resp: torch.Tensor, true_shape: tuple[int, int],
                 row_off: torch.Tensor | None = None, global_h: int | None = None,
                 inset: int = 0) -> torch.Tensor:
    """(..., R, C) response plane with the one-pixel border of the true
    (h, w) image and everything outside it set to 0. With ``row_off`` the
    (B, R, C) planes are windows: row r of frame i is row r + row_off[i] of
    a ``global_h``-row frame, whose border is zeroed, as are the window's
    rows from h on and its first and last ``inset`` rows."""
    h, w = true_shape
    r = torch.arange(resp.shape[-2], device=resp.device)[:, None]
    c = torch.arange(resp.shape[-1], device=resp.device)[None, :]
    g, gh = r, h
    if row_off is not None:
        g, gh = r + row_off.to(device=resp.device, dtype=torch.int64)[:, None, None], global_h
    border = ((g <= 0) | (g >= gh - 1) | (r >= h) | (r < inset) | (r >= h - inset)
              | (c == 0) | (c >= w - 1))
    return torch.where(border, torch.zeros_like(resp), resp)


def _tile_min(resp: torch.Tensor) -> torch.Tensor:
    """(B, Hp, Wp) -> (B, Hp/64) minima per 64-row tile."""
    b, h_pad, w_pad = resp.shape
    return resp.reshape(b, h_pad // TILE_H, TILE_H * w_pad).amin(-1)


def _blur_and_tile_min(lf_p: torch.Tensor, sigma: float,
                       true_shape: tuple[int, int], *rows):
    """(B, Hp+16, Wp) f32 luma in the padded layout -> (blur (B, Hp, Wp),
    (B, Hp/64) minima of the Hessian response per 64-row tile, the border
    of the true (h, w) image and everything outside it zeroed; ``rows``:
    the window arguments of ``_zero_border``)."""
    # blur over the whole padded plane: its clamped borders equal the
    # reference's (the padding replicates the image's edge pixels)
    blur = gaussian_blur(lf_p, sigma)
    resp = _zero_border(hessian_response(blur)[:, 8:-8], true_shape, *rows)
    return blur[:, 8:-8], _tile_min(resp)


def _response_tile_min(lf_p: torch.Tensor, sigma: float,
                       true_shape: tuple[int, int], *rows) -> torch.Tensor:
    """The tile minima of ``_blur_and_tile_min`` alone."""
    return _blur_and_tile_min(lf_p, sigma, true_shape, *rows)[1]


def front_kernel_plain(raw_p: torch.Tensor, sigma: float,
                       true_shape: tuple[int, int], channels: int, u16: bool,
                       emit_blur: bool = False, row_off: torch.Tensor | None = None,
                       global_h: int | None = None):
    """Plain PyTorch version of ``front_kernel`` (same outputs)."""
    lf, l8 = raw_luma(raw_p, channels, u16)
    blur, tile_min = _blur_and_tile_min(lf, sigma, true_shape, row_off, global_h)
    l8 = l8[:, 8:-8].contiguous()
    if emit_blur:
        return blur.contiguous(), l8, tile_min
    return l8, tile_min


def pad_half(half: torch.Tensor) -> torch.Tensor:
    """(B, hh, wh) f32 half-resolution luma plane -> (B, Hhp+16, Whp) in
    the padded layout of ``pad_raw``: 8 rows above, Hhp = ceil(hh/64)*64,
    Whp = ceil(wh/128)*128, every element outside the plane a replica of
    the plane's own nearest edge value."""
    return _edge_pad(half, *padded_shape(*half.shape[1:]), 8).contiguous()


def front_kernel_decimate_plain(raw_p: torch.Tensor, sigma: float,
                                true_shape: tuple[int, int], channels: int,
                                u16: bool, row_off: torch.Tensor | None = None,
                                global_h: int | None = None):
    """Plain PyTorch version of ``front_kernel_decimate`` (same outputs)."""
    h, w = true_shape
    lf, l8 = raw_luma(raw_p, channels, u16)
    half_p = pad_half(decimate2(lf[:, 8 : 8 + h, :w]))
    rows = () if row_off is None else (row_off, global_h, _WINDOW_INSET)
    tile_min = _response_tile_min(half_p, sigma, (h // 2, w // 2), *rows)
    return l8[:, 8:-8].contiguous(), half_p, tile_min


@functools.lru_cache(maxsize=None)
def _taps(sigma: float) -> ctypes.Array:
    """The blur's 7 taps as the C array the launches take, built once per
    sigma; callers only read it."""
    taps = gaussian_kernel(sigma)
    if len(taps) != 7:
        raise ValueError("the kernels take a 7-tap blur (sigma <= 1.5)")
    return (ctypes.c_float * 7)(*(float(v) for v in taps))


def check_raw(raw_p: torch.Tensor, channels: int, u16: bool, name: str,
              luma_f32: bool = False):
    """Shape/type contract shared by the kernel wrappers: a ``pad_raw``
    array, or with ``luma_f32`` a ``pad_half`` plane (f32, one channel)."""
    if raw_p.ndim != 3 or not raw_p.is_contiguous():
        raise ValueError(f"{name}: raw_p must be a contiguous (B, Hp+16, Wp*C) array")
    if luma_f32:
        if raw_p.dtype != torch.float32 or channels != 1 or u16:
            raise TypeError(
                f"{name}: an f32 luma plane is (B, Hp+16, Wp) float32 with "
                f"channels=1, u16=False (got {raw_p.dtype}, channels={channels}, u16={u16})"
            )
    elif raw_p.dtype != (torch.uint16 if u16 else torch.uint8):
        raise TypeError(f"{name}: raw_p dtype {raw_p.dtype} does not match u16={u16}")
    h_pad = raw_p.shape[1] - 16
    if h_pad <= 0 or h_pad % TILE_H or raw_p.shape[2] % (128 * channels):
        raise ValueError(f"{name}: raw_p shape {tuple(raw_p.shape)} is not a pad_raw layout")


def check_rows(row_off, global_h, b: int, dev, name: str):
    """The row-sharding arguments' contract shared by the kernel wrappers:
    ``row_off`` (B,) int32 on the frames' device comes with ``global_h``
    (alone it would be ignored); ``global_h`` alone means offsets 0.
    Returns the offsets, or None without row sharding."""
    if global_h is None:
        if row_off is not None:
            raise ValueError(f"{name}: row_off without global_h would be ignored")
        return None
    if row_off is None:
        return torch.zeros(b, dtype=torch.int32, device=dev)
    if row_off.shape != (b,) or row_off.dtype != torch.int32 or row_off.device != dev:
        raise ValueError(f"{name}: row_off must be (B,) int32 on the frames' device")
    return row_off


def front_kernel(raw_p: torch.Tensor, sigma: float,
                 true_shape: tuple[int, int], channels: int, u16: bool,
                 emit_blur: bool = False, row_off: torch.Tensor | None = None,
                 global_h: int | None = None):
    """(B, Hp+16, Wp*C) pad_raw output -> (luma8 (B, Hp, Wp) u8,
    tile_min (B, Hp/64) f32): image-crate gray, 7-tap clamped Gaussian
    blur and the Hessian response with the image border zeroed, reduced
    to one minimum per 64-row tile. The global minimum times the response
    ratio is the cluster threshold.

    With ``emit_blur`` the outputs are (blur_p (B, Hp, Wp) f32, luma8,
    tile_min): the blur of the whole padded plane (the padding blurs the
    frame's replicated edge pixels), which ``cluster_rochade`` reads.

    Row sharding: with ``row_off`` (B,) int32 and ``global_h``, frame i is
    a window whose row r is row r + row_off[i] of a ``global_h``-row frame;
    the response border is that frame's, and the window's rows from h on
    are zeroed too (the counterpart of ``front_kernel``'s
    ``row_off``/``global_h``)."""
    check_raw(raw_p, channels, u16, "front_kernel")
    h, w = true_shape
    row_off = check_rows(row_off, global_h, raw_p.shape[0], raw_p.device, "front_kernel")
    if raw_p.device.type == "cpu":
        return front_kernel_plain(raw_p, sigma, true_shape, channels, u16, emit_blur,
                                  row_off, global_h)
    require_cuda(raw_p, "front_kernel")
    b, rows, _ = raw_p.shape
    h_pad, w_pad = rows - 16, raw_p.shape[2] // channels
    taps = _taps(sigma)
    dev = raw_p.device
    luma8 = torch.empty((b, h_pad, w_pad), dtype=torch.uint8, device=dev)
    blur = (torch.empty((b, h_pad, w_pad), dtype=torch.float32, device=dev)
            if emit_blur else None)
    strip_min = torch.empty(
        (b, h_pad // TILE_H, w_pad // STRIP_W), dtype=torch.float32, device=dev
    )
    err = launch(
        "front_kernel", raw_p,
        raw_p.data_ptr(), b, h_pad, w_pad, channels, int(u16), h, w,
        ctypes.addressof(taps), None if row_off is None else row_off.data_ptr(),
        h if row_off is None else global_h, luma8.data_ptr(),
        blur.data_ptr() if emit_blur else None, strip_min.data_ptr(),
    )
    check(err, "front_kernel")
    if row_off is not None:
        LAUNCHES["front_kernel[row_off]"] += 1
    else:
        LAUNCHES["front_kernel[emit_blur]" if emit_blur else "front_kernel"] += 1
    if emit_blur:
        return blur, luma8, strip_min.amin(-1)
    return luma8, strip_min.amin(-1)


def front_kernel_decimate(raw_p: torch.Tensor, sigma: float,
                          true_shape: tuple[int, int], channels: int, u16: bool,
                          row_off: torch.Tensor | None = None,
                          global_h: int | None = None):
    """(B, Hp+16, Wp*C) pad_raw output -> (luma8 (B, Hp, Wp) u8, half_p
    (B, Hhp+16, Whp) f32, tile_min (B, Hhp/64) f32): the turbo front-end.

    ``luma8`` is ``front_kernel``'s. ``half_p`` is the 2x2-mean decimated
    f32 luma of the true (h, w) frame, ``half[y, x] = ((l[2y, 2x] +
    l[2y, 2x+1]) + (l[2y+1, 2x] + l[2y+1, 2x+1])) * 0.25`` over
    (h//2, w//2), stored in the ``pad_half`` layout: row 8 + y, column x,
    with 8 rows above, rows up to Hhp = ceil((h//2)/64)*64 (+8) below and
    columns up to Whp = ceil((w//2)/128)*128, all replicas of the half
    plane's own edge values (not decimated full-resolution padding, which
    would sit half a pixel off). It feeds ``cluster_rochade_raw(...,
    luma_f32=True)`` and ``nms_extract_raw``. ``tile_min`` holds the
    Hessian-response minima of the blurred half plane per 64 half rows,
    with the half image's one-pixel border zeroed; the global minimum
    times the response ratio is the turbo threshold.

    Row sharding: ``row_off`` (B,) int32 and ``global_h`` count HALF rows;
    half row r of frame i is half row r + row_off[i] of a ``global_h``-row
    half frame, whose border is zeroed in the minima, as are the window's
    first and last 4 half rows (they blur into its replicated edge rows;
    the neighbouring window holds them). The half plane is the window's
    own, its edges replicated as without row sharding."""
    check_raw(raw_p, channels, u16, "front_kernel_decimate")
    h, w = true_shape
    if h < 2 or w < 2:
        raise ValueError(f"front_kernel_decimate: a {h}x{w} frame has no half plane")
    row_off = check_rows(row_off, global_h, raw_p.shape[0], raw_p.device,
                         "front_kernel_decimate")
    if raw_p.device.type == "cpu":
        return front_kernel_decimate_plain(raw_p, sigma, true_shape, channels, u16,
                                           row_off, global_h)
    require_cuda(raw_p, "front_kernel_decimate")
    b, rows, _ = raw_p.shape
    h_pad, w_pad = rows - 16, raw_p.shape[2] // channels
    hh_pad = -(-(h // 2) // TILE_H) * TILE_H
    wh_pad = -(-(w // 2) // 128) * 128
    taps = _taps(sigma)
    dev = raw_p.device
    luma8 = torch.empty((b, h_pad, w_pad), dtype=torch.uint8, device=dev)
    half_p = torch.empty((b, hh_pad + 16, wh_pad), dtype=torch.float32, device=dev)
    strip_min = torch.empty(
        (b, hh_pad // TILE_H, wh_pad // STRIP_W), dtype=torch.float32, device=dev
    )
    err = launch(
        "front_kernel_decimate", raw_p,
        raw_p.data_ptr(), b, h_pad, w_pad, channels, int(u16), h, w,
        ctypes.addressof(taps), None if row_off is None else row_off.data_ptr(),
        h // 2 if row_off is None else global_h, luma8.data_ptr(), half_p.data_ptr(),
        hh_pad, wh_pad, strip_min.data_ptr(),
    )
    check(err, "front_kernel_decimate")
    LAUNCHES["front_kernel_decimate[row_off]" if row_off is not None
             else "front_kernel_decimate"] += 1
    return luma8, half_p, strip_min.amin(-1)


def fused_frontend_plain(luma: torch.Tensor, sigma: float = 1.5, crop: bool = True,
                         true_shape: tuple[int, int] | None = None,
                         emit_resp: bool = True):
    """Plain PyTorch version of ``fused_frontend`` on (B, hin, win) planes
    (same outputs): ops/frontend.py's blur and response over the padded
    plane, border and padding of the response zeroed."""
    h, w = true_shape if true_shape is not None else luma.shape[1:]
    blur = gaussian_blur(_edge_pad(luma, *padded_shape(h, w)), sigma)
    resp = _zero_border(hessian_response(blur), (h, w))
    if crop:
        return blur[:, :h, :w].contiguous(), resp[:, :h, :w].contiguous()
    if emit_resp:
        return blur, resp, _tile_min(resp)
    return blur, _tile_min(resp)


def fused_frontend(luma: torch.Tensor, sigma: float = 1.5, crop: bool = True,
                   true_shape: tuple[int, int] | None = None,
                   emit_resp: bool = True):
    """(H, W) or (B, H, W) f32 luma -> (blur, resp) of the same shape:
    ops/frontend.py's ``gaussian_blur`` (7 taps, clamped borders) and
    ``hessian_response``, the response 0 on the image's one-pixel border.

    ``crop=False`` returns the planes padded to Hp = ceil(h/64)*64 rows
    and Wp = ceil(w/128)*128 columns — the blur of the edge-replicated
    plane, the response 0 in all padding — and the response minima per
    64-row tile, the layout ``cluster_rochade`` reads: (blur_p, resp_p,
    tile_min (B, Hp/64)), always batched. ``emit_resp=False`` (padded form
    only) drops the response plane: (blur_p, tile_min). ``true_shape``
    names the real (h, w) of a plane that arrives already padded (the
    output of ``gray_kernel``): border and minima follow the true shape."""
    if luma.dtype != torch.float32 or luma.ndim not in (2, 3):
        raise TypeError("fused_frontend: luma must be an (H, W) or (B, H, W) float32 plane")
    if not emit_resp and crop:
        raise ValueError("fused_frontend: emit_resp=False implies padded outputs (crop=False)")
    squeeze = luma.ndim == 2
    if squeeze:
        luma = luma[None]
    b, hin, win = luma.shape
    h, w = true_shape if true_shape is not None else (hin, win)
    h_pad, w_pad = padded_shape(h, w)
    if not (0 < h <= hin <= h_pad and 0 < w <= win <= w_pad):
        raise ValueError(
            f"fused_frontend: a {hin}x{win} plane does not hold a {h}x{w} "
            f"image padded to at most {h_pad}x{w_pad}"
        )
    if luma.device.type == "cpu":
        outs = fused_frontend_plain(luma, sigma, crop, (h, w), emit_resp)
    else:
        require_cuda(luma, "fused_frontend")
        luma = luma.contiguous()
        taps = _taps(sigma)
        dev = luma.device
        shape = (b, h, w) if crop else (b, h_pad, w_pad)
        blur = torch.empty(shape, dtype=torch.float32, device=dev)
        resp = torch.empty(shape, dtype=torch.float32, device=dev) if emit_resp else None
        strip_min = torch.empty(
            (b, h_pad // TILE_H, w_pad // STRIP_W), dtype=torch.float32, device=dev
        )
        err = launch(
            "fused_frontend", luma,
            luma.data_ptr(), b, hin, win, h, w, h_pad, w_pad,
            ctypes.addressof(taps), blur.data_ptr(),
            resp.data_ptr() if emit_resp else None, shape[1], shape[2],
            strip_min.data_ptr(),
        )
        check(err, "fused_frontend")
        LAUNCHES["fused_frontend"] += 1
        if crop:
            outs = blur, resp
        elif emit_resp:
            outs = blur, resp, strip_min.amin(-1)
        else:
            outs = blur, strip_min.amin(-1)
    if crop and squeeze:
        return outs[0][0], outs[1][0]
    return outs


def gray_kernel_plain(img: torch.Tensor):
    """Plain PyTorch version of ``gray_kernel`` (same outputs)."""
    img, channels, u16 = _raw_mode(img, "gray_kernel")
    b, h, w = img.shape[:3]
    h_pad, w_pad = padded_shape(h, w)
    # index through the int16 view: u16 indexing is not served everywhere
    src = img.view(torch.int16) if u16 else img
    raw = _edge_pad(src, h_pad, w_pad).reshape(b, h_pad, w_pad * channels)
    if u16:
        raw = raw.view(torch.uint16)
    lf, l8 = raw_luma(raw, channels, u16)
    return lf.contiguous(), l8.contiguous()


def gray_kernel(img: torch.Tensor):
    """(B, H, W[, 3]) u8 / (B, H, W) u16 raw frames -> (luma_f (B, Hp, Wp)
    f32, luma_u8 (B, Hp, Wp) u8) with the image-crate gray conversion of
    ``ops/gray.py::raw_luma``, padded to Hp = ceil(H/64)*64 rows and Wp =
    ceil(W/128)*128 columns. The padding of both planes holds the luma of
    the frame's nearest edge pixel (the raw frame is edge-replicated
    before the conversion, as the JAX kernel's wrapper pads it), so a
    clamped-border blur of ``luma_f`` equals that of the true plane."""
    img, channels, u16 = _raw_mode(img, "gray_kernel")
    if img.device.type == "cpu":
        return gray_kernel_plain(img)
    require_cuda(img, "gray_kernel")
    img = img.contiguous()
    b, h, w = img.shape[:3]
    h_pad, w_pad = padded_shape(h, w)
    luma_f = torch.empty((b, h_pad, w_pad), dtype=torch.float32, device=img.device)
    luma8 = torch.empty((b, h_pad, w_pad), dtype=torch.uint8, device=img.device)
    err = launch(
        "gray_kernel", img,
        img.data_ptr(), b, h, w, channels, int(u16), h_pad, w_pad,
        luma_f.data_ptr(), luma8.data_ptr(),
    )
    check(err, "gray_kernel")
    LAUNCHES["gray_kernel"] += 1
    return luma_f, luma8
