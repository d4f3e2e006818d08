"""Front kernel: padded raw frames -> u8 luma plane + response tile minima.

``front_kernel`` replaces the JAX package's
``pallas/frontend.py::front_kernel`` with ``emit_blur=False`` (the exact
hybrid path). On a CUDA tensor it launches ``csrc/frontend.cu``; on a CPU
tensor it runs ``front_kernel_plain``, the same function in plain PyTorch.
What bounds the kernel on the H100 and what its design does about it is
noted at the top of ``csrc/frontend.cu`` (memory: raw read + luma8 write,
the f32 planes stay in shared memory).

``pad_raw`` lays the frames out as both this kernel and the cluster
kernel read them.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.frontend import gaussian_blur, gaussian_kernel, hessian_response
from ..ops.gray import as_int32, ieee_div
from . import LAUNCHES
from ._lib import check, lib, require_cuda, stream_of

TILE_H = 64    # image rows per tile (the TPU kernel's grid step)
STRIP_W = 64   # image columns per CUDA block

# Rec.709 weights pre-divided by 255 (the reference's f32 matrix entries)
_COEF = (0.2126 / 255.0, 0.7152 / 255.0, 0.0722 / 255.0)


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


def raw_luma(raw: torch.Tensor, channels: int, u16: bool):
    """(..., R, W*C) padded raw -> (f32 luma, u8 luma), (..., R, W), with
    the kernel's formulas: u8 x/255; u16 x/65535 and
    floor((x*255 + 32767)/65535); RGB the fused multiply-add chain
    fma(b, cB, fma(g, cG, r*cR)) and integer (2126r+7152g+722b)//10000.
    Divides are IEEE divides on every device (``ieee_div``), as the
    kernel's ``__fdiv_rn`` and the JAX ops chain evaluate them.
    The fused multiply-adds are evaluated in f64 and rounded once: for
    these operands (u8 integers times f32 weights) the f64 sum is exact,
    so this equals a hardware FMA bit for bit."""
    if channels == 3:
        x = raw.reshape(*raw.shape[:-1], raw.shape[-1] // 3, 3).to(torch.int32)
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        cr, cg, cb = (float(torch.tensor(c, dtype=torch.float32)) for c in _COEF)
        acc = r.to(torch.float32) * cr
        acc = (g.to(torch.float64) * cg + acc.to(torch.float64)).to(torch.float32)
        lf = (b.to(torch.float64) * cb + acc.to(torch.float64)).to(torch.float32)
        l8 = torch.div(2126 * r + 7152 * g + 722 * b, 10000, rounding_mode="floor")
        return lf, l8.to(torch.uint8)
    if u16:
        x = as_int32(raw).to(torch.float32)
        l8 = torch.floor(ieee_div(x * 255.0 + 32767.0, 65535.0))
        return ieee_div(x, 65535.0), l8.to(torch.uint8)
    return ieee_div(raw.to(torch.float32), 255.0), raw


def front_kernel_plain(raw_p: torch.Tensor, sigma: float,
                       true_shape: tuple[int, int], channels: int, u16: bool):
    """Plain PyTorch version of ``front_kernel`` (same outputs)."""
    h, w = true_shape
    b, rows, _ = raw_p.shape
    h_pad = rows - 16
    lf, l8 = raw_luma(raw_p, channels, u16)
    w_pad = lf.shape[-1]
    # blur over the whole padded plane: its clamped borders equal the
    # reference's (the padding replicates the image's edge pixels)
    resp = hessian_response(gaussian_blur(lf, sigma))[:, 8 : 8 + h_pad]
    r = torch.arange(h_pad, device=raw_p.device)[:, None]
    c = torch.arange(w_pad, device=raw_p.device)[None, :]
    border = (r <= 0) | (r >= h - 1) | (c == 0) | (c >= w - 1)
    resp = torch.where(border, torch.zeros_like(resp), resp)
    tile_min = resp.reshape(b, h_pad // TILE_H, TILE_H * w_pad).amin(-1)
    return l8[:, 8 : 8 + h_pad].contiguous(), tile_min


def _taps(sigma: float) -> ctypes.Array:
    taps = gaussian_kernel(sigma)
    if len(taps) != 7:
        raise ValueError("the kernels take a 7-tap blur (sigma <= 1.5)")
    return (ctypes.c_float * 7)(*(float(v) for v in taps))


def check_raw(raw_p: torch.Tensor, channels: int, u16: bool, name: str):
    """Shape/type contract shared by the front and cluster wrappers."""
    if raw_p.ndim != 3 or not raw_p.is_contiguous():
        raise ValueError(f"{name}: raw_p must be a contiguous (B, Hp+16, Wp*C) array")
    if raw_p.dtype != (torch.uint16 if u16 else torch.uint8):
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
