"""Dense front-end: separable Gaussian blur + Hessian saddle response.

These are the whole-image hot loops of the reference
(gaussian_blur_f32 src/image_util.rs:110-206, hessian_response
src/image_util.rs:72-109), written as shifted multiply-adds in the
reference tap order — not as a convolution, whose summation order (and,
through cuDNN, TF32 rounding) would differ. They are the plain versions
the front and cluster kernels are held against.

Semantics preserved exactly:

* blur kernel radius = ceil(2*sigma), normalized, borders clamped
  (edge-replicate) in both passes, horizontal first; each tap is one
  multiply and one add, accumulated from 0 in tap order;
* Hessian response computed on the interior only, borders left 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gaussian_kernel(sigma: float) -> np.ndarray:
    radius = int(math.ceil(sigma * 2.0))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x * x) / np.float32(2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float = 1.5) -> torch.Tensor:
    """Separable blur with clamped borders over the last two axes
    (src/image_util.rs:110-206)."""
    k = [float(v) for v in gaussian_kernel(sigma)]
    radius = (len(k) - 1) // 2
    h, w = img.shape[-2:]
    cols = torch.clamp(
        torch.arange(-radius, w + radius, device=img.device), 0, w - 1
    )
    padded = img[..., cols]
    temp = torch.zeros_like(img)
    for i, kw in enumerate(k):
        temp = temp + padded[..., i : i + w] * kw
    rows = torch.clamp(
        torch.arange(-radius, h + radius, device=img.device), 0, h - 1
    )
    padded = temp[..., rows, :]
    out = torch.zeros_like(img)
    for i, kw in enumerate(k):
        out = out + padded[..., i : i + h, :] * kw
    return out


def hessian_response(img: torch.Tensor) -> torch.Tensor:
    """det(Hessian) 3x3 stencil over the last two axes; borders 0
    (src/image_util.rs:72-109)."""
    v = img
    lxx = v[..., 1:-1, :-2] - 2.0 * v[..., 1:-1, 1:-1] + v[..., 1:-1, 2:]
    lyy = v[..., :-2, 1:-1] - 2.0 * v[..., 1:-1, 1:-1] + v[..., 2:, 1:-1]
    lxy = (v[..., :-2, 2:] - v[..., :-2, :-2] + v[..., 2:, :-2]
           - v[..., 2:, 2:]) * 0.25
    resp = lxx * lyy - lxy * lxy
    return torch.nn.functional.pad(resp, (1, 1, 1, 1))
