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

Frames beyond the cluster kernel's label domain (``fused_path_ok``: widths
from 2^16, scan-order labels from 2^24 — 8K-class exact frames; at half
resolution for turbo) take the plane path (``planes_frontend_batch``),
with a warning once per shape; ``saddle_frontend``, the single-image
front-end behind ``refined_saddle_points``, takes it for every frame:

    to_luma [-> decimate2] -> fused_frontend (blur + response planes)
            -> cluster_centroids_bounded -> rochade_refine
            -> filter_and_compact
            [-> sparse_refine_raw at 2 p + 0.5 -> filter_and_compact]

``frontend_packed`` packs the saddles and the capacity counters into one
(B, N+1, 4) array so the host reads them with a single copy.

``detect_pipeline_batch`` and ``detect_pipeline`` are the whole detect on
the device (the facade's ``mode="xla"``): the batch front-end (or the
single-image one), then ``detect_tail`` — ``max_num_of_boards`` passes of
the on-device board search (``ops/search.py``) and the decode
(``ops/decode.py::decode_quads_batch``, whose table scan is the
``hamming_scan`` kernel), each pass releasing the saddles of its decoded
tags.
"""

from __future__ import annotations

import functools
import os
import warnings
from typing import NamedTuple

import torch

from .config import Capacities, DetectorParams, PipelineConstants
from .families import FamilySpec
from .kernels.cluster import _CAPF, cluster_rochade_raw, saddles_from_candidates
from .kernels.frontend import front_kernel, front_kernel_decimate, fused_frontend, pad_raw
from .kernels.nms import cells_to_fields, nms_extract_raw
from .kernels.refine import sparse_refine_raw
from .ops.cluster import cluster_centroids_bounded
from .ops.compact import nonzero_sized, take
from .ops.decode import decode_quads_batch
from .ops.frontend import decimate2
from .ops.gray import as_int32, to_luma_batch
from .ops.rochade import Saddles, filter_and_compact, rochade_refine
from .ops.search import find_best_board


# Pixels one piece of a plane-path batch may hold. Sixteen 4100 x 4100 RGB
# frames (half of it) peak at 14.62 GiB of device memory on an H100 80GB
# (chip_smoke.py prints the figure): about 58 bytes per pixel.
PLANE_PIXELS = 2**29


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


def fused_path_ok(h: int, w: int, decimate: bool = False) -> bool:
    """Whether (h, w) frames lie in the label domain of the fused kernels:
    widths below 2^16 (the JAX package packs the column into 16 bits) and
    the scan-order label ``row * w + col + 1``, stored as f32, exact
    below 2^24. The turbo path
    labels the half plane, so it reaches four times the pixels. Frames
    outside take the plane path. (The JAX package also sends frames
    shorter than one sweep window of its cluster kernel around it; the
    kernels here have no window, small frames stay on the fused path.)"""
    lh, lw = (h // 2, w // 2) if decimate else (h, w)
    return w < 2**16 and lh * lw < 2**24


@functools.lru_cache(maxsize=None)
def _warn_plane_path(h: int, w: int, decimate: bool) -> None:
    """Tell the user, once per frame shape and mode, that frames were
    routed around the fused kernels."""
    mode = "turbo, half resolution" if decimate else "exact"
    warnings.warn(
        f"{h}x{w} frames ({mode}) are beyond the fused kernels' label domain "
        "(w < 2^16 and h*w < 2^24 at the labeled resolution): they take the "
        "plane path (fused_frontend + plain PyTorch clustering), which "
        "writes whole f32 planes to device memory. The turbo mode "
        "(decimate=True) labels at half resolution and keeps frames of up "
        "to four times the pixels on the fused kernels.",
        RuntimeWarning,
        stacklevel=3,
    )


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


def _nms_merge() -> int:
    """Sweeps of the NMS kernel's geodesic peak merge, from the environment
    variable ``AG_NMS_MERGE`` (default 0, clamped to 0-8): it collapses a
    response blob's duplicate peaks onto the first in scan order, so fewer
    candidates reach the board search. The JAX package's policy
    (``pipeline.py::_nms_merge``), read the same way."""
    return max(0, min(8, int(os.environ.get("AG_NMS_MERGE", "0"))))


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
    the NMS variant and 0 for the drain. The NMS variant runs the peak merge
    that ``AG_NMS_MERGE`` asks for (``_nms_merge``)."""
    h, w = int(imgs.shape[1]), int(imgs.shape[2])
    raw_p, _, _, channels, u16 = pad_raw(imgs)
    luma8, half_p, tile_min = front_kernel_decimate(
        raw_p, consts.blur_sigma, (h, w), channels, u16
    )
    thr = tile_min.amin(-1) * consts.response_threshold_ratio
    kw = dict(sigma=consts.blur_sigma, hp2=2 * consts.rochade_half_patch,
              move_thr=consts.rochade_move_threshold)
    if _resolve_nms(nms):
        cells = nms_extract_raw(half_p, thr, h // 2, w // 2, merge=_nms_merge(), **kw)
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


def _frontend_tail(blur: torch.Tensor, resp: torch.Tensor, params, consts,
                   caps) -> Saddles:
    """cluster -> ROCHADE -> gates on (B, h, w) blur and response planes."""
    clusters = cluster_centroids_bounded(
        resp, consts.response_threshold_ratio, caps.max_clusters,
        caps.max_masked, caps.label_prop_rounds,
    )
    raw = rochade_refine(
        blur, clusters.centers, clusters.valid, consts.rochade_half_patch,
        consts.rochade_move_threshold,
    )
    return _gated(raw, params, consts, caps)


def _decimated_tail(imgs: torch.Tensor, blur_h: torch.Tensor,
                    resp_h: torch.Tensor, params, consts, caps) -> Saddles:
    """The turbo back half on planes: the whole front-end tail at half
    resolution on ``blur_h``/``resp_h``, survivors scaled back (half pixel
    (x, y) sits at full-resolution (2x + 0.5, 2y + 0.5)) and re-refined at
    full resolution straight from the raw frames ``imgs``
    (``sparse_refine_raw``), then gated again."""
    half_saddles = _frontend_tail(blur_h, resp_h, params, consts, caps)
    # the refine kernel converts the three raw modes itself
    raw_p, h, w, channels, u16 = pad_raw(normalize_raw_batch(imgs))
    refined = sparse_refine_raw(
        raw_p, half_saddles.p * 2.0 + 0.5, half_saddles.valid, h, w,
        channels=channels, u16=u16, sigma=consts.blur_sigma,
        hp2=2 * consts.rochade_half_patch, move_thr=consts.rochade_move_threshold,
    )
    return _gated(refined, params, consts, caps)


def planes_frontend_batch(
    imgs: torch.Tensor,
    params: DetectorParams,
    consts: PipelineConstants,
    caps: Capacities,
    decimate: bool = False,
):
    """The plane path on raw frames: f32 luma planes through
    ``fused_frontend``, then clustering, ROCHADE and the gates in plain
    PyTorch at the capacities of ``caps`` (turbo: the survivors re-refined
    by ``sparse_refine_raw``). Returns what ``saddle_frontend_batch``
    returns, with ``luma8`` the unpadded (B, h, w) plane. It has no
    candidate buffer and no blob-size cap: the first two counters are
    always 0.

    A batch goes through in pieces of at most ``PLANE_PIXELS`` pixels (at
    least one frame), which bounds the f32 planes and label temporaries a
    call holds at once. One frame may hold up to 2^31 - 1 pixels, the
    range of the int32 labels; ``label_components`` raises beyond."""
    b, h, w = (int(n) for n in imgs.shape[:3])
    step = max(1, PLANE_PIXELS // (h * w))
    if b > step:
        parts = [planes_frontend_batch(imgs[i : i + step], params, consts, caps, decimate)
                 for i in range(0, b, step)]
        saddles = Saddles(*(torch.cat(t) for t in zip(*(p[0] for p in parts))))
        return saddles, torch.cat([p[1] for p in parts]), torch.cat([p[2] for p in parts])
    luma_f, luma8 = to_luma_batch(imgs)
    if decimate:
        luma_f = decimate2(luma_f)
    blur, resp = fused_frontend(luma_f, consts.blur_sigma)
    if decimate:
        saddles = _decimated_tail(imgs, blur, resp, params, consts, caps)
    else:
        saddles = _frontend_tail(blur, resp, params, consts, caps)
    zeros = torch.zeros(b, dtype=torch.float32, device=imgs.device)
    counters = torch.stack([zeros, zeros, saddles.valid.all(-1).to(torch.float32)], 1)
    return saddles, luma8, counters


def saddle_frontend(
    img: torch.Tensor,
    params: DetectorParams,
    consts: PipelineConstants,
    caps: Capacities,
    decimate: bool = False,
):
    """Refined saddle points + u8 luma plane of ONE image of any
    DynamicImage mode, (H, W[, C]), on the plane path: ``to_luma`` takes
    every mode exactly, so nothing is folded first. Returns (Saddles with
    (max_saddles, ...) fields, luma8 (H, W))."""
    saddles, luma8, _ = planes_frontend_batch(img[None], params, consts, caps, decimate)
    return Saddles(*(t[0] for t in saddles)), luma8[0]


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
    Frames outside ``fused_path_ok`` take ``planes_frontend_batch``
    instead (``luma8`` then is the unpadded (B, H, W) plane).

    The counters are [candidate-buffer overflow flag, candidates dropped
    (always 0 on the exact path: the labeling has no blob-size cap),
    saddle slots full flag]; non-zero entries mean the fixed-capacity
    pipeline MAY have diverged from the reference on that frame."""
    imgs = normalize_raw_batch(imgs)
    h, w = int(imgs.shape[1]), int(imgs.shape[2])
    if not fused_path_ok(h, w, decimate):
        _warn_plane_path(h, w, bool(decimate))
        return planes_frontend_batch(imgs, params, consts, caps, decimate)
    if decimate:
        return decimated_frontend_batch(imgs, params, consts, caps, nms)
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


class DetectResult(NamedTuple):
    """Fixed-capacity detection output of the on-device detect; the host
    unpacks it to {id: corners}. Leading (B,) axis (none from
    ``detect_pipeline``); T = ``max_num_of_boards`` x the decode capacity."""

    ids: torch.Tensor      # (B, T) int32, -1 where invalid
    corners: torch.Tensor  # (B, T, 4, 2) float32
    valid: torch.Tensor    # (B, T) bool
    # (B, 2) f32 capacity audit [saddle slots full, kNN-pool prunes]:
    # non-zero means the fixed-capacity pipeline MAY diverge from the
    # reference on this frame; the facade warns on the first
    flags: torch.Tensor


def detect_tail(
    saddles: Saddles,
    luma8: torch.Tensor,
    spec: FamilySpec,
    params: DetectorParams,
    consts: PipelineConstants,
    caps: Capacities,
    true_shape: tuple[int, int] | None = None,
    slots_full: torch.Tensor | None = None,
) -> DetectResult:
    """``max_num_of_boards`` rounds of board search + decode per frame,
    removing the saddles of successfully decoded tags between rounds
    (src/detector.rs:510-538). ``saddles`` (B, N) and ``luma8`` (B, Hp, Wp),
    padded when ``true_shape`` gives the real (h, w); ``slots_full`` (B,),
    the front-end's saddle capacity audit, goes into ``flags``."""
    bsz, n = saddles.valid.shape
    dev = saddles.p.device
    alive = saddles.valid
    g2 = (2 * caps.grid_radius + 1) ** 2
    # the placed cells are compacted to the decode capacity first (a real
    # board places <= ~66 of the G2 cells); overflow rides the audit
    dcap = min(g2, 2 * caps.max_tags)
    pruned = torch.zeros(bsz, dtype=torch.float32, device=dev)
    out = []
    for _ in range(params.max_num_of_boards):
        res = find_best_board(
            saddles.p, saddles.theta, alive,
            params.tag_spacing_ratio, caps.grid_radius, consts.quad_nn,
            caps.max_quads, caps.max_boards, caps.seeds_per_group,
            caps.max_attempts, consts.max_seeds, consts.early_exit_score,
            caps.knn_pool,
        )
        tag_valid = res.board.placed & res.found[:, None]          # (B, G2)
        sel = nonzero_sized(tag_valid, dcap, g2)
        live = sel < g2
        quad_idx = take(res.board.cell_quad, sel.clamp(max=g2 - 1)).long()  # (B, dcap, 4)
        pruned = pruned + (tag_valid.sum(-1) - live.sum(-1)).to(torch.float32)
        quad_pos = take(saddles.p, quad_idx.clamp(min=0))          # (B, dcap, 4, 2)
        decoded = decode_quads_batch(
            luma8, quad_pos, live, spec, consts.decode_margin,
            consts.valid_brightness_threshold, consts.max_invalid_bit,
            consts.min_contrast, true_shape=true_shape,
        )
        out.append(decoded)
        pruned = pruned + res.board.pruned.to(torch.float32)
        # only successfully decoded quads release their saddles
        # (src/detector.rs:517-536)
        used = torch.where(decoded.valid[..., None], quad_idx, n).reshape(bsz, -1)
        alive = torch.cat([alive, alive[:, :1]], 1).scatter_(1, used, False)[:, :n]

    full = (torch.zeros(bsz, dtype=torch.float32, device=dev) if slots_full is None
            else slots_full.to(torch.float32))
    return DetectResult(
        ids=torch.cat([d.ids for d in out], 1),
        corners=torch.cat([d.corners for d in out], 1),
        valid=torch.cat([d.valid for d in out], 1),
        flags=torch.stack([full, pruned], 1),
    )


def detect_pipeline(
    img: torch.Tensor,
    spec: FamilySpec,
    params: DetectorParams,
    consts: PipelineConstants,
    caps: Capacities,
    decimate: bool = False,
) -> DetectResult:
    """The whole detect() (src/detector.rs:505-540) of ONE image (H, W[, C])
    on its device: the single-image front-end (``saddle_frontend``, the
    plane path), then ``detect_tail``. Returns the result without the
    batch axis."""
    saddles, luma8 = saddle_frontend(img, params, consts, caps, decimate)
    batched = Saddles(*(t[None] for t in saddles))
    res = detect_tail(batched, luma8[None], spec, params, consts, caps,
                      slots_full=batched.valid.all(-1))
    return DetectResult(*(t[0] for t in res))


def detect_pipeline_batch(
    imgs: torch.Tensor,
    spec: FamilySpec,
    params: DetectorParams,
    consts: PipelineConstants,
    caps: Capacities,
    decimate: bool = False,
) -> DetectResult:
    """The whole detect() of a (B, H, W[, C]) batch on its device: the
    batch front-end (``saddle_frontend_batch``: the fused kernels, the
    turbo path with ``decimate``, or the plane path beyond their domain),
    then ``detect_tail`` on every frame."""
    hw = (int(imgs.shape[1]), int(imgs.shape[2]))
    saddles, luma8, _ = saddle_frontend_batch(imgs, params, consts, caps, decimate)
    return detect_tail(saddles, luma8, spec, params, consts, caps, hw,
                       slots_full=saddles.valid.all(-1))
