"""Front kernel: padded raw frames -> u8 luma plane + response tile minima.

``front_kernel`` replaces the JAX package's
``pallas/frontend.py::front_kernel`` with ``emit_blur=False`` (the exact
hybrid path). On a CUDA tensor it launches ``csrc/frontend.cu``; on a CPU
tensor it runs ``front_kernel_plain``, the same function in plain PyTorch.
What bounds the kernel on the H100 and what its design does about it is
noted at the top of ``csrc/frontend.cu`` (memory: raw read + luma8 write,
the f32 planes stay in shared memory).

``front_kernel_decimate`` replaces
``pallas/frontend.py::front_kernel_decimate``, the turbo path's front
kernel: the same luma8, plus the half-resolution f32 luma plane (2x2 mean)
and the response minima taken at half resolution.

``pad_raw`` lays the frames out as the front, cluster and refine kernels
read them; ``pad_half`` does the same for a half-resolution luma plane.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.frontend import decimate2, gaussian_blur, gaussian_kernel, hessian_response
from ..ops.gray import raw_luma
from . import LAUNCHES
from ._lib import check, lib, require_cuda, stream_of

TILE_H = 64    # image rows per tile (the TPU kernel's grid step)
STRIP_W = 64   # image columns per CUDA block


def pad_raw(img: torch.Tensor):
    """Edge-pad raw frames for the fused kernels: 8 rows above, row/lane
    alignment below/right, channels flattened into the row. Returns
    (padded (B, Hp+16, Wp*C), h, w, channels, u16) with Hp = ceil(h/64)*64
    and Wp = ceil(w/128)*128 — the same padded array feeds both kernels."""
    if img.ndim == 4 and img.shape[3] == 4 and img.dtype == torch.uint8:
        img = img[..., :3]  # alpha is ignored (ops/gray.py semantics)
    b, hgt, wid = img.shape[:3]
    channels = img.shape[3] if img.ndim == 4 else 1
    u16 = img.dtype == torch.uint16
    # the in-kernel gray conversion handles exactly three raw modes;
    # anything else (LA, RGB16, f32) must be folded first by
    # pipeline.normalize_raw_batch, which the detector does
    if channels not in (1, 3) or (u16 and channels != 1) or (
        img.dtype not in (torch.uint8, torch.uint16)
    ):
        raise TypeError(
            f"pad_raw: unsupported raw mode (channels={channels}, "
            f"dtype={img.dtype}); fold exotic DynamicImage modes with "
            "pipeline.normalize_raw_batch first"
        )
    h_pad = -(-hgt // TILE_H) * TILE_H
    w_pad = -(-wid // 128) * 128
    dev = img.device
    rows = torch.clamp(torch.arange(-8, h_pad + 8, device=dev), 0, hgt - 1)
    cols = torch.clamp(torch.arange(w_pad, device=dev), 0, wid - 1)
    # index through the int16 view: u16 indexing is not served everywhere
    src = img.view(torch.int16) if u16 else img
    out = src[:, rows][:, :, cols].reshape(b, h_pad + 16, w_pad * channels)
    if u16:
        out = out.view(torch.uint16)
    return out.contiguous(), hgt, wid, channels, u16


def _response_tile_min(lf_p: torch.Tensor, sigma: float,
                       true_shape: tuple[int, int]) -> torch.Tensor:
    """(B, Hp+16, Wp) f32 luma in the padded layout -> (B, Hp/64) minima of
    the Hessian response per 64-row tile, the border of the true (h, w)
    image and everything outside it zeroed."""
    h, w = true_shape
    b, rows, w_pad = lf_p.shape
    h_pad = rows - 16
    # blur over the whole padded plane: its clamped borders equal the
    # reference's (the padding replicates the image's edge pixels)
    resp = hessian_response(gaussian_blur(lf_p, sigma))[:, 8 : 8 + h_pad]
    r = torch.arange(h_pad, device=lf_p.device)[:, None]
    c = torch.arange(w_pad, device=lf_p.device)[None, :]
    border = (r <= 0) | (r >= h - 1) | (c == 0) | (c >= w - 1)
    resp = torch.where(border, torch.zeros_like(resp), resp)
    return resp.reshape(b, h_pad // TILE_H, TILE_H * w_pad).amin(-1)


def front_kernel_plain(raw_p: torch.Tensor, sigma: float,
                       true_shape: tuple[int, int], channels: int, u16: bool):
    """Plain PyTorch version of ``front_kernel`` (same outputs)."""
    lf, l8 = raw_luma(raw_p, channels, u16)
    tile_min = _response_tile_min(lf, sigma, true_shape)
    return l8[:, 8:-8].contiguous(), tile_min


def pad_half(half: torch.Tensor) -> torch.Tensor:
    """(B, hh, wh) f32 half-resolution luma plane -> (B, Hhp+16, Whp) in
    the padded layout of ``pad_raw``: 8 rows above, Hhp = ceil(hh/64)*64,
    Whp = ceil(wh/128)*128, every element outside the plane a replica of
    the plane's own nearest edge value."""
    hh, wh = half.shape[1:]
    dev = half.device
    rows = torch.clamp(torch.arange(-8, -(-hh // TILE_H) * TILE_H + 8, device=dev), 0, hh - 1)
    cols = torch.clamp(torch.arange(-(-wh // 128) * 128, device=dev), 0, wh - 1)
    return half[:, rows][:, :, cols].contiguous()


def front_kernel_decimate_plain(raw_p: torch.Tensor, sigma: float,
                                true_shape: tuple[int, int], channels: int,
                                u16: bool):
    """Plain PyTorch version of ``front_kernel_decimate`` (same outputs)."""
    h, w = true_shape
    lf, l8 = raw_luma(raw_p, channels, u16)
    half_p = pad_half(decimate2(lf[:, 8 : 8 + h, :w]))
    tile_min = _response_tile_min(half_p, sigma, (h // 2, w // 2))
    return l8[:, 8:-8].contiguous(), half_p, tile_min


def _taps(sigma: float) -> ctypes.Array:
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


def front_kernel(raw_p: torch.Tensor, sigma: float,
                 true_shape: tuple[int, int], channels: int, u16: bool):
    """(B, Hp+16, Wp*C) pad_raw output -> (luma8 (B, Hp, Wp) u8,
    tile_min (B, Hp/64) f32): image-crate gray, 7-tap clamped Gaussian
    blur and the Hessian response with the image border zeroed, reduced
    to one minimum per 64-row tile. The global minimum times the response
    ratio is the cluster threshold."""
    check_raw(raw_p, channels, u16, "front_kernel")
    if raw_p.device.type == "cpu":
        return front_kernel_plain(raw_p, sigma, true_shape, channels, u16)
    require_cuda(raw_p, "front_kernel")
    h, w = true_shape
    b, rows, _ = raw_p.shape
    h_pad, w_pad = rows - 16, raw_p.shape[2] // channels
    taps = _taps(sigma)
    luma8 = torch.empty((b, h_pad, w_pad), dtype=torch.uint8, device=raw_p.device)
    strip_min = torch.empty(
        (b, h_pad // TILE_H, w_pad // STRIP_W), dtype=torch.float32,
        device=raw_p.device,
    )
    err = lib().ag_front_kernel(
        raw_p.data_ptr(), b, h_pad, w_pad, channels, int(u16), h, w,
        ctypes.addressof(taps), luma8.data_ptr(), strip_min.data_ptr(),
        stream_of(raw_p),
    )
    check(err, "front_kernel")
    LAUNCHES["front_kernel"] += 1
    return luma8, strip_min.amin(-1)


def front_kernel_decimate(raw_p: torch.Tensor, sigma: float,
                          true_shape: tuple[int, int], channels: int, u16: bool):
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
    times the response ratio is the turbo threshold."""
    check_raw(raw_p, channels, u16, "front_kernel_decimate")
    h, w = true_shape
    if h < 2 or w < 2:
        raise ValueError(f"front_kernel_decimate: a {h}x{w} frame has no half plane")
    if raw_p.device.type == "cpu":
        return front_kernel_decimate_plain(raw_p, sigma, true_shape, channels, u16)
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
    err = lib().ag_front_kernel_decimate(
        raw_p.data_ptr(), b, h_pad, w_pad, channels, int(u16), h, w,
        ctypes.addressof(taps), luma8.data_ptr(), half_p.data_ptr(),
        hh_pad, wh_pad, strip_min.data_ptr(), stream_of(raw_p),
    )
    check(err, "front_kernel_decimate")
    LAUNCHES["front_kernel_decimate"] += 1
    return luma8, half_p, strip_min.amin(-1)
