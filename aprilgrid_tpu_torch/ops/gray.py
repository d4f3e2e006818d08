"""Grayscale conversion with image-crate semantics.

The reference converts the input twice (src/detector.rs:409,507):
``to_luma32f`` feeds the saddle front-end and ``to_luma8`` feeds the bit
sampler. Both conversions are reproduced here exactly — including the
image crate's Rec.709 float path for f32 luma and its integer fixed-point
path for u8 luma. The front kernel (kernels/frontend.py) converts the
padded raw frames itself; this module is the exact reference for every
DynamicImage mode, and ``raw_luma`` states the kernels' own conversion of
their three raw modes.
"""

from __future__ import annotations

import torch

# Rec.709 luma coefficients (image crate's SRGB_LUMA).
_LUMA_R, _LUMA_G, _LUMA_B = 0.2126, 0.7152, 0.0722
# The same weights pre-divided by 255 (the kernels' f32 matrix entries)
_COEF = (0.2126 / 255.0, 0.7152 / 255.0, 0.0722 / 255.0)


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """u8/u16 tensor -> int32 values (u16 goes through its int16 bit
    pattern, which every device supports)."""
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    return x.to(torch.int32)


def ieee_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as one IEEE f32 divide on every device. PyTorch's
    CUDA division by a Python scalar multiplies by the reciprocal instead,
    which is off by an ulp for some ``x``; a 0-dim tensor divisor on
    ``x``'s device keeps the true divide."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _scale_u16_to_u8(v: torch.Tensor) -> torch.Tensor:
    """Image-crate u16 -> u8 component conversion (rounding 255/65535)."""
    return torch.div(v * 255 + 32767, 65535, rounding_mode="floor").to(
        torch.uint8
    )


def _rec709(rgbf: torch.Tensor) -> torch.Tensor:
    return (
        _LUMA_R * rgbf[..., 0] + _LUMA_G * rgbf[..., 1]
    ) + _LUMA_B * rgbf[..., 2]


def _int_luma(rgbi: torch.Tensor) -> torch.Tensor:
    return torch.div(
        2126 * rgbi[..., 0] + 7152 * rgbi[..., 1] + 722 * rgbi[..., 2],
        10000, rounding_mode="floor",
    )


def _f32_to_u8(f: torch.Tensor) -> torch.Tensor:
    # f32::round is half away from zero (not banker's rounding)
    return torch.floor(torch.clamp(f, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def to_luma(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Return ``(luma_f32 in [0,1], luma_u8)`` for any supported input.

    Covers the reference's full DynamicImage contract
    (src/detector.rs:409,507 accept ANY variant): (H, W) u8/u16/f32
    gray, (H, W, 2) gray+alpha (alpha dropped — image-crate FromColor
    semantics, no premultiply), (H, W, 3|4) u8/u16/f32 RGB(A)."""
    if img.ndim == 3 and img.shape[2] == 2:
        return to_luma(img[..., 0])  # LumaA: alpha is dropped
    if img.ndim == 2:
        if img.dtype == torch.uint8:
            return ieee_div(img.to(torch.float32), 255.0), img
        if img.dtype == torch.uint16:
            v = as_int32(img)
            return ieee_div(v.to(torch.float32), 65535.0), _scale_u16_to_u8(v)
        if img.dtype in (torch.float32, torch.float64):
            f = img.to(torch.float32)
            return f, _f32_to_u8(f)
        raise TypeError(f"unsupported gray dtype {img.dtype}")
    if img.ndim == 3 and img.shape[2] in (3, 4):
        if img.dtype == torch.uint8:
            rgbi = img[..., :3].to(torch.int32)
            luma_f = _rec709(ieee_div(rgbi.to(torch.float32), 255.0))
            return luma_f, _int_luma(rgbi).to(torch.uint8)
        if img.dtype == torch.uint16:
            rgbi = as_int32(img[..., :3])
            luma_f = _rec709(ieee_div(rgbi.to(torch.float32), 65535.0))
            # integer luma in the u16 source domain, then component scale
            # to u8 (fits int32: the weighted sum is <= 10000 * 65535)
            return luma_f, _scale_u16_to_u8(_int_luma(rgbi))
        if img.dtype in (torch.float32, torch.float64):
            luma_f = _rec709(img[..., :3].to(torch.float32))
            return luma_f, _f32_to_u8(luma_f)
        raise TypeError(f"unsupported rgb dtype {img.dtype}")
    raise TypeError(f"unsupported image shape/dtype {tuple(img.shape)} {img.dtype}")


def to_luma_batch(imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``to_luma`` over a batch of same-shape frames: (B, H, W[, C]) ->
    ((B, H, W) f32, (B, H, W) u8). The conversion is per pixel, so the
    frames are read as one (B*H, W[, C]) image."""
    b, h = imgs.shape[:2]
    luma_f, luma_u8 = to_luma(imgs.reshape(b * h, *imgs.shape[2:]))
    return luma_f.reshape(b, h, -1), luma_u8.reshape(b, h, -1)


def raw_luma(raw: torch.Tensor, channels: int, u16: bool):
    """(..., R, W*C) raw rows of the three kernel modes (u8 gray, u16
    gray, u8 RGB with the channels flattened into the row) -> (f32 luma,
    u8 luma), (..., R, W), with the kernels' formulas: u8 x/255; u16 x/65535 and
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
