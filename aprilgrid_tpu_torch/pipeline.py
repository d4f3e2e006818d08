"""The hybrid detector's device half: raw frames -> packed saddles.

``saddle_frontend_batch`` is the dense front half of detect()
(reference: TagDetector::refined_saddle_points, src/detector.rs:408-446)
on the fused-kernel path of the JAX package
(pipeline.py::saddle_frontend_batch with the Pallas kernels):

    pad_raw -> front_kernel (luma8 + response tile minima)
            -> threshold = global minimum x response ratio
            -> cluster_rochade_raw -> saddles_from_candidates
            -> filter_and_compact

``frontend_packed`` packs the saddles and the capacity counters into one
(B, N+1, 4) array so the host reads them with a single copy.
"""

from __future__ import annotations

import torch

from .config import Capacities, DetectorParams, PipelineConstants
from .kernels.cluster import _CAPF, cluster_rochade_raw, saddles_from_candidates
from .kernels.frontend import front_kernel, pad_raw
from .ops.gray import as_int32
from .ops.rochade import filter_and_compact


def _to_u16(v: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65535] -> uint16 (through int16's wraparound,
    which every device supports)."""
    return v.to(torch.int16).view(torch.uint16)


def normalize_raw_batch(imgs: torch.Tensor) -> torch.Tensor:
    """Map the reference's full DynamicImage input contract
    (src/detector.rs:409,507 accept ANY variant) onto the three raw modes
    the kernels convert themselves (u8 gray, u16 gray, u8 RGB[A]):

    * (B, H, W, 1) and (B, H, W, 2) — Luma(+alpha): channel 0 (the image
      crate drops alpha without premultiplying);
    * (B, H, W, 3|4) u16 — RGB(A)16: the crate's integer luma in the u16
      source domain (alpha dropped); luma8 stays bit-exact while the f32
      plane becomes luma16/65535 — a <= 1.6e-5 luma quantization;
    * (B, H, W[, 3|4]) f32/f64 — Luma32F/Rgb32F: float luma quantized to
      u16 (round), the same <= 1.6e-5 quantization."""
    if imgs.ndim == 4 and imgs.shape[3] in (1, 2):
        imgs = imgs[..., 0]
    if imgs.ndim == 4 and imgs.shape[3] in (3, 4):
        if imgs.dtype == torch.uint16:
            rgbi = as_int32(imgs[..., :3])
            luma16 = torch.div(
                2126 * rgbi[..., 0] + 7152 * rgbi[..., 1] + 722 * rgbi[..., 2],
                10000, rounding_mode="floor",
            )
            imgs = _to_u16(luma16)
        elif imgs.dtype in (torch.float32, torch.float64):
            rgbf = imgs[..., :3].to(torch.float32)
            imgs = (0.2126 * rgbf[..., 0] + 0.7152 * rgbf[..., 1]) + (
                0.0722 * rgbf[..., 2]
            )
    if imgs.ndim == 3 and imgs.dtype in (torch.float32, torch.float64):
        q = torch.floor(
            torch.clamp(imgs.to(torch.float32), 0.0, 1.0) * 65535.0 + 0.5
        )
        imgs = _to_u16(q.to(torch.int32))
    return imgs


def saddle_frontend_batch(
    imgs: torch.Tensor,
    params: DetectorParams,
    consts: PipelineConstants,
    caps: Capacities,
):
    """(B, H, W[, C]) frames -> (saddles (B, max_saddles), luma8
    (B, Hp, Wp) u8, counters (B, 3) f32).

    The counters are [candidate-buffer overflow flag, clusters dropped at
    a blob-size cap (always 0 here: the labeling has none), saddle slots
    full flag]; non-zero entries mean the fixed-capacity pipeline MAY have
    diverged from the reference on that frame."""
    imgs = normalize_raw_batch(imgs)
    h, w = int(imgs.shape[1]), int(imgs.shape[2])
    raw_p, _, _, channels, u16 = pad_raw(imgs)
    luma8, tile_min = front_kernel(
        raw_p, consts.blur_sigma, (h, w), channels, u16
    )
    # threshold = ratio * global response minimum (src/detector.rs:414-418)
    thr = tile_min.amin(-1) * consts.response_threshold_ratio
    fields, counts = cluster_rochade_raw(
        raw_p, thr, h, w, channels=channels, u16=u16,
        sigma=consts.blur_sigma, hp2=2 * consts.rochade_half_patch,
        move_thr=consts.rochade_move_threshold,
    )
    saddles = filter_and_compact(
        saddles_from_candidates(fields),
        caps.max_saddles,
        consts.saddle_k_ratio,
        params.min_saddle_angle,
        params.max_saddle_angle,
    )
    counters = torch.stack(
        [
            (counts[:, 0] >= _CAPF).to(torch.float32),
            counts[:, 1],
            saddles.valid.all(-1).to(torch.float32),
        ],
        dim=1,
    )
    return saddles, luma8, counters


def frontend_packed(imgs, params, consts, caps):
    """Front-end + saddles packed for one device-to-host copy: returns
    (packed (B, N+1, 4) f32, luma8). Rows of ``packed`` are
    [x, y, theta, valid] per saddle, then one row [overflow, dropped,
    slots full, 0] of capacity counters."""
    saddles, luma8, counters = saddle_frontend_batch(imgs, params, consts, caps)
    packed = torch.cat(
        [
            saddles.p,
            saddles.theta[..., None],
            saddles.valid.to(torch.float32)[..., None],
        ],
        dim=-1,
    )
    crow = torch.cat([counters, torch.zeros_like(counters[:, :1])], dim=1)
    return torch.cat([packed, crow[:, None, :]], dim=1), luma8
