"""The hybrid detector's device half: raw frames -> packed saddles.

``saddle_frontend_batch`` is the dense front half of detect()
(reference: TagDetector::refined_saddle_points, src/detector.rs:408-446)
on the fused-kernel path of the JAX package
(pipeline.py::saddle_frontend_batch with the Pallas kernels):

    pad_raw -> front_kernel (luma8 + response tile minima)
            -> threshold = global minimum x response ratio
            -> cluster_rochade_raw -> saddles_from_candidates
            -> filter_and_compact

With ``decimate`` it takes the approximate turbo path
(``decimated_frontend_batch``): detection at half resolution, survivors
re-refined at full resolution from the raw frames:

    pad_raw -> front_kernel_decimate (luma8 + half plane + half-res minima)
            -> threshold at half resolution
            -> nms_extract_raw + cells_to_fields      (NMS variant)
               or cluster_rochade_raw(luma_f32=True)  (drain variant)
            -> saddles_from_candidates -> filter_and_compact
            -> sparse_refine_raw at 2 p + 0.5 -> filter_and_compact

``frontend_packed`` packs the saddles and the capacity counters into one
(B, N+1, 4) array so the host reads them with a single copy.
"""

from __future__ import annotations

import os

import torch

from .config import Capacities, DetectorParams, PipelineConstants
from .kernels.cluster import _CAPF, cluster_rochade_raw, saddles_from_candidates
from .kernels.frontend import front_kernel, front_kernel_decimate, pad_raw
from .kernels.nms import cells_to_fields, nms_extract_raw
from .kernels.refine import sparse_refine_raw
from .ops.gray import as_int32
from .ops.rochade import Saddles, filter_and_compact


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


def turbo_fast_path_ok(h: int, w: int) -> bool:
    """Whether an (h, w) full-resolution frame lies in the domain of the
    JAX package's fused turbo path. Kept as that package states it
    (``pipeline.py::turbo_fast_path_ok``) — the half plane's padded height
    must cover one 184-row window of its cluster kernel, widths stay below
    2^16, half-plane labels below 2^24 — although the kernels here have no
    window: the facade's ``"auto"`` choice between the NMS and the drain
    variant keys on it, so the port picks the variant the JAX package
    picks for the same frame."""
    hh, wh = h // 2, w // 2
    cluster_ok = -(-hh // 64) * 64 >= 184 and wh < 2**16 and hh * wh < 2**24
    return cluster_ok and w < 2**16


def _turbo_nms_env() -> str:
    """Turbo extraction policy from the environment variable
    ``AG_TURBO_NMS``: ``"0"`` (or empty) forces the drain variant (the
    cluster kernel on the half plane), ``"auto"`` (the default) leaves the
    choice to the facade (NMS iff ``turbo_fast_path_ok`` and the host has
    more than one core), anything else forces the NMS kernel."""
    v = os.environ.get("AG_TURBO_NMS", "auto")
    if v in ("0", ""):
        return "0"
    return v if v == "auto" else "1"


def _resolve_nms(nms: bool | None) -> bool:
    """An explicit choice wins; ``None`` follows the environment policy,
    where only ``"1"`` selects the NMS kernel (``"auto"`` without a
    chooser takes the drain)."""
    if nms is not None:
        return bool(nms)
    return _turbo_nms_env() == "1"


def _gated(saddles: Saddles, params, consts, caps) -> Saddles:
    return filter_and_compact(
        saddles,
        caps.max_saddles,
        consts.saddle_k_ratio,
        params.min_saddle_angle,
        params.max_saddle_angle,
    )


def _counters(counts: torch.Tensor, saddles: Saddles) -> torch.Tensor:
    return torch.stack(
        [
            (counts[:, 0] >= _CAPF).to(torch.float32),
            counts[:, 1],
            saddles.valid.all(-1).to(torch.float32),
        ],
        dim=1,
    )


def decimated_frontend_batch(
    imgs: torch.Tensor,
    params: DetectorParams,
    consts: PipelineConstants,
    caps: Capacities,
    nms: bool | None = None,
):
    """The turbo front-end on normalized raw frames; returns what
    ``saddle_frontend_batch`` returns. ``nms`` picks the extraction
    variant (``_resolve_nms``). Approximate by design: tag recall at
    >= 2 MP matches the exact path on the golden scenes with corners
    within 0.1 px of the oracle (tests/test_torch_decimate.py); smaller
    frames lose recall, so the facade's ``"auto"`` engages it at >= 2 MP
    only. The second counter is peaks beyond the candidate capacity for
    the NMS variant and 0 for the drain."""
    h, w = int(imgs.shape[1]), int(imgs.shape[2])
    raw_p, _, _, channels, u16 = pad_raw(imgs)
    luma8, half_p, tile_min = front_kernel_decimate(
        raw_p, consts.blur_sigma, (h, w), channels, u16
    )
    thr = tile_min.amin(-1) * consts.response_threshold_ratio
    kw = dict(sigma=consts.blur_sigma, hp2=2 * consts.rochade_half_patch,
              move_thr=consts.rochade_move_threshold)
    if _resolve_nms(nms):
        cells = nms_extract_raw(half_p, thr, h // 2, w // 2, **kw)
        fields, n_peaks = cells_to_fields(cells, _CAPF)
        counts = torch.stack(
            [n_peaks.clamp(max=float(_CAPF)), (n_peaks - float(_CAPF)).clamp(min=0.0)],
            dim=1,
        )
    else:
        fields, counts = cluster_rochade_raw(
            half_p, thr, h // 2, w // 2, luma_f32=True, **kw
        )
    half_saddles = _gated(saddles_from_candidates(fields), params, consts, caps)
    # half pixel (x, y) sits at full-resolution (2x + 0.5, 2y + 0.5)
    refined = sparse_refine_raw(
        raw_p, half_saddles.p * 2.0 + 0.5, half_saddles.valid, h, w,
        channels=channels, u16=u16, **kw,
    )
    saddles = _gated(refined, params, consts, caps)
    return saddles, luma8, _counters(counts, saddles)


def saddle_frontend_batch(
    imgs: torch.Tensor,
    params: DetectorParams,
    consts: PipelineConstants,
    caps: Capacities,
    decimate: bool = False,
    nms: bool | None = None,
):
    """(B, H, W[, C]) frames -> (saddles (B, max_saddles), luma8
    (B, Hp, Wp) u8, counters (B, 3) f32); ``decimate`` takes the turbo
    path (``decimated_frontend_batch``, extraction variant ``nms``).

    The counters are [candidate-buffer overflow flag, candidates dropped
    (always 0 on the exact path: the labeling has no blob-size cap),
    saddle slots full flag]; non-zero entries mean the fixed-capacity
    pipeline MAY have diverged from the reference on that frame."""
    imgs = normalize_raw_batch(imgs)
    if decimate:
        return decimated_frontend_batch(imgs, params, consts, caps, nms)
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
    saddles = _gated(saddles_from_candidates(fields), params, consts, caps)
    return saddles, luma8, _counters(counts, saddles)


def frontend_packed(imgs, params, consts, caps, decimate=False, nms=None):
    """Front-end + saddles packed for one device-to-host copy: returns
    (packed (B, N+1, 4) f32, luma8). Rows of ``packed`` are
    [x, y, theta, valid] per saddle, then one row [overflow, dropped,
    slots full, 0] of capacity counters."""
    saddles, luma8, counters = saddle_frontend_batch(
        imgs, params, consts, caps, decimate, nms
    )
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
