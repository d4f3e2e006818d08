"""Sparse refine kernel: full-resolution ROCHADE records at the turbo
path's surviving candidates, straight from the padded raw frames.

``sparse_refine_raw`` replaces the JAX package's
``pallas/refine.py::sparse_refine_raw``. On a CUDA tensor it launches
``csrc/refine.cu``: one launch, a warp per (frame, slot), eight slots a
block, that writes every slot's finished row — position, k, theta, phi and
the accept bit with the bounds gate — so the wrapper enqueues the launch
and one compare; what the launch costs is instruction throughput, ~2 k warp
instructions per live slot (the source's head has the details). On a CPU
tensor it runs ``sparse_refine_raw_plain``, which is
``ops/rochade.py::refine_at_raw`` on the frames inside the padding.

Difference from the TPU kernel, by design: it takes every frame width. The
TPU kernel's window DMA needs RGB frames at least 384 pixels wide and the
JAX pipeline refines narrower ones on another path; here there is one
refine path.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.rochade import Saddles, refine_at_raw
from . import LAUNCHES
from ._fit import fit_struct
from ._lib import check, launch, require_cuda
from .frontend import _taps, check_raw


def sparse_refine_raw_plain(raw_p, centers, valid, h, w, channels=1, u16=False,
                            sigma=1.5, hp2=4, move_thr=1.0) -> Saddles:
    """Plain PyTorch version of ``sparse_refine_raw``."""
    img = raw_p[:, 8 : 8 + h, : w * channels]
    if channels == 3:
        img = img.reshape(img.shape[0], h, w, 3)
    return refine_at_raw(img, centers, valid, sigma, hp2 // 2, move_thr)


def sparse_refine_raw(
    raw_p: torch.Tensor,    # pad_raw() output: (B, Hp+16, Wp*C) u8/u16
    centers: torch.Tensor,  # (B, K, 2) f32 full-resolution positions (x, y)
    valid: torch.Tensor,    # (B, K) bool
    h: int,
    w: int,
    channels: int = 1,
    u16: bool = False,
    sigma: float = 1.5,
    hp2: int = 4,
    move_thr: float = 1.0,
) -> Saddles:
    """Slot-aligned sparse ROCHADE refine from the padded raw frames: row i
    of the returned ``Saddles`` refines ``centers[:, i]``; slots that are
    not ``valid``, whose rounded centre lies within ``hp2`` pixels of the
    image edge, or whose fit is rejected come back ``valid=False``."""
    check_raw(raw_p, channels, u16, "sparse_refine_raw")
    if hp2 != 4:
        raise ValueError("sparse_refine_raw: the fit takes half_patch 2 (hp2=4)")
    b = raw_p.shape[0]
    if (centers.ndim != 3 or centers.shape[0] != b or centers.shape[2] != 2
            or centers.dtype != torch.float32):
        raise ValueError("sparse_refine_raw: centers must be (B, K, 2) f32")
    if valid.shape != centers.shape[:2] or valid.dtype != torch.bool:
        raise ValueError("sparse_refine_raw: valid must be (B, K) bool")
    if raw_p.device.type == "cpu":
        return sparse_refine_raw_plain(
            raw_p, centers, valid, h, w, channels, u16, sigma, hp2, move_thr
        )
    require_cuda(raw_p, "sparse_refine_raw")
    if centers.device != raw_p.device or valid.device != raw_p.device:
        raise ValueError("sparse_refine_raw: centers and valid must be on raw_p's device")
    kcap = centers.shape[1]
    centers = centers.contiguous()
    valid = valid.contiguous()
    # the kernel writes every row: [x, y, k, theta, phi, ok, 0, 0]
    fields = torch.empty((b, kcap, 8), dtype=torch.float32, device=raw_p.device)
    taps = _taps(sigma)
    fit = fit_struct(hp2 // 2)
    err = launch(
        "sparse_refine_raw", raw_p,
        raw_p.data_ptr(), b, raw_p.shape[1] - 16, raw_p.shape[2] // channels,
        channels, int(u16), h, w, ctypes.addressof(taps), centers.data_ptr(),
        valid.data_ptr(), kcap, ctypes.addressof(fit), float(move_thr), hp2,
        fields.data_ptr(),
    )
    check(err, "sparse_refine_raw")
    LAUNCHES["sparse_refine_raw"] += 1
    return Saddles(p=fields[..., 0:2], k=fields[..., 2], theta=fields[..., 3],
                   phi=fields[..., 4], valid=fields[..., 5] > 0.5)
