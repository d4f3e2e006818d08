"""Tag bit decoding: affine sampling + 4-rotation hamming table search.

Reference pipeline: decode_positions (src/detector.rs:42-72) maps bit-cell
centers through a least-squares affine fitted to the quad
(tag_affine, src/image_util.rs:39-70); bit_code (src/detector.rs:74-122)
samples the u8 gray image, thresholds at mid-brightness and assembles the
code MSB-first; best_tag (src/detector.rs:142-169) scans the family table
at 4 rotations (rotate_bits, src/detector.rs:124-140) and accepts the
first rotation whose best hamming score beats the family threshold.

Batched over frames and candidate quads at once:

* the affine solve collapses to one constant (6, 8) pseudo-inverse (the
  source points depend only on family constants) times the corner vector,
  summed term by term in a fixed order so every device rounds alike;
* bit sampling is one gather; thresholds/invalid-counts are reductions;
* the 4 rotations are precomputed bit permutations, and the table scan is
  the ``hamming_scan`` kernel (kernels/decode.py).

Rust cast quirks are preserved: sample coordinates round half away from
zero and saturate negatives to 0 before the >= width/height bound check.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..families import FamilySpec, rotation_permutation
from .compact import device_table
from .geometry import rust_round


class DecodedTags(NamedTuple):
    ids: torch.Tensor      # (B, T) int32 tag ids, -1 where invalid
    corners: torch.Tensor  # (B, T, 4, 2) float32, canonical order
    valid: torch.Tensor    # (B, T) bool


@functools.lru_cache(maxsize=None)
def _affine_pinv(side_bits: int, margin: float) -> np.ndarray:
    """Constant pseudo-inverse of the 8x6 affine design matrix
    (tag_affine, src/image_util.rs:39-70)."""
    s = float(side_bits) - 1.0 + margin
    source = [(-margin, -margin), (-margin, s), (s, s), (s, -margin)]
    a = np.zeros((8, 6), dtype=np.float64)
    for p in range(4):
        a[2 * p, 0:3] = (source[p][0], source[p][1], 1.0)
        a[2 * p + 1, 3:6] = (source[p][0], source[p][1], 1.0)
    return np.linalg.pinv(a).astype(np.float32)  # (6, 8)


@functools.lru_cache(maxsize=None)
def _bit_grid(edge: int, border: int) -> np.ndarray:
    """Bit-cell centers in tag frame, x-major (src/detector.rs:60-71)."""
    pts = [
        (float(x), float(y))
        for x in range(border, border + edge)
        for y in range(border, border + edge)
    ]
    return np.array(pts, dtype=np.float32)  # (edge^2, 2)


@functools.lru_cache(maxsize=None)
def _rot_perms(edge: int) -> np.ndarray:
    """Permutations for 0..3 90-degree rotations over LSB-first bits."""
    n = edge * edge
    p1 = rotation_permutation(edge)
    perms = [np.arange(n, dtype=np.int64)]
    for _ in range(3):
        perms.append(perms[-1][p1])
    return np.stack(perms)  # (4, n)


def tag_homography(corners, side_bits: int, margin: float) -> torch.Tensor:
    """The 8-DoF DLT homography from the canonical tag frame to the image
    quad (reference: tag_homography, src/image_util.rs:5-37, dead code
    there; the pipeline uses the affine). Returns the (3, 3) float32 H from
    the last right singular vector of the 8x9 DLT system (the reference's
    ``svd.V().col(8)``), by ``torch.linalg.svd`` in f32 on ``corners``'
    device (CPU for a list).

    Unlike the reference, the system is solved with the corners centred on
    their mean and scaled by their largest offset, and H maps back: the
    raw system's smallest singular vector is ill-conditioned in f32 at
    image-scale coordinates (with PyTorch's SVD the mapped corners of
    quads at 100 and 1800 px missed a 1e-3-px bound), the conditioned one
    keeps them within it. A singular vector's sign and scale are not
    unique: compare two such H by the mapping, not entry by entry."""
    c = torch.as_tensor(corners, dtype=torch.float32).reshape(4, 2)
    mu = c.mean(0)
    scale = (c - mu).abs().max().clamp_min(1.0)
    cn = (c - mu) / scale
    s = float(side_bits) - 1.0 + margin
    src = torch.tensor([(-margin, -margin, 1.0), (-margin, s, 1.0), (s, s, 1.0),
                        (s, -margin, 1.0)], dtype=torch.float32, device=c.device)
    zero = torch.zeros((4, 3), dtype=torch.float32, device=c.device)
    rows_x = torch.cat([src, zero, -cn[:, :1] * src], dim=1)
    rows_y = torch.cat([zero, src, -cn[:, 1:] * src], dim=1)
    a = torch.stack([rows_x, rows_y], dim=1).reshape(8, 9)
    hn = torch.linalg.svd(a).Vh[-1].reshape(3, 3)
    back = torch.eye(3, dtype=torch.float32, device=c.device)
    back[0, 0] = back[1, 1] = scale
    back[:2, 2] = mu
    return back @ hn


def decode_positions_px(corners, spec: FamilySpec, margin: float,
                        width: int, height: int):
    """Public bit-cell sample positions for one quad — the standalone
    decode_positions the reference exposes and its demo calls per
    detected tag for the overlay (src/detector.rs:42-72,
    examples/demo.rs:83). Host-side NumPy; returns (edge^2, 2) float32
    or None when a rounded corner falls outside the image."""
    c = np.asarray(corners, np.float32).reshape(4, 2)
    rc = np.copysign(np.floor(np.abs(c) + 0.5), c)
    if (np.maximum(rc, 0.0)[:, 0] >= width).any() or (
        np.maximum(rc, 0.0)[:, 1] >= height
    ).any():
        return None
    pinv = _affine_pinv(spec.side_bits, margin)
    params = pinv @ c.reshape(8)
    grid = _bit_grid(spec.edge, spec.border)
    px = params[0] * grid[:, 0] + params[1] * grid[:, 1] + params[2]
    py = params[3] * grid[:, 0] + params[4] * grid[:, 1] + params[5]
    return np.stack([px, py], axis=-1)


def _decode_pre(
    luma8: torch.Tensor,      # (B, Hp, Wp) u8
    quad_pos: torch.Tensor,   # (B, T, 4, 2) float32 corner positions
    quad_valid: torch.Tensor,  # (B, T) bool
    spec: FamilySpec,
    margin: float,
    valid_brightness_threshold: int,
    max_invalid_bit: int,
    min_contrast: int,
    true_shape: tuple[int, int] | None = None,
):
    """decode_positions + bit_code + rotation expansion; returns
    (rots (B, T, 4, nb) f32 0/1, gates (B, T, 3) bool)."""
    bsz, hp, wp = luma8.shape
    h, w = true_shape if true_shape is not None else (hp, wp)
    dev = quad_pos.device

    # --- decode_positions: corner bound gate + affine bit centers
    rc = rust_round(quad_pos)
    rcx = torch.clamp(rc[..., 0], min=0.0)
    rcy = torch.clamp(rc[..., 1], min=0.0)
    corners_ok = ((rcx < w) & (rcy < h)).all(dim=-1) & quad_valid

    pinv = _affine_pinv(spec.side_bits, margin)
    b = quad_pos.reshape(bsz, -1, 8)  # x0,y0,x1,y1,... row order
    params = []
    for p in range(6):
        acc = torch.zeros_like(b[..., 0])
        for k in range(8):
            acc = acc + float(pinv[p, k]) * b[..., k]
        params.append(acc[..., None])
    grid = device_table(_bit_grid, (spec.edge, spec.border), dev)
    gx, gy = grid[:, 0], grid[:, 1]
    px = params[0] * gx + params[1] * gy + params[2]  # (B, T, nb)
    py = params[3] * gx + params[4] * gy + params[5]

    # --- bit_code: sample, contrast, mid-threshold, invalid count
    sx = torch.clamp(rust_round(px), min=0.0)
    sy = torch.clamp(rust_round(py), min=0.0)
    sample_ok = ((sx < w) & (sy < h)).all(dim=-1)
    xi = torch.clamp(sx.to(torch.int64), 0, w - 1)
    yi = torch.clamp(sy.to(torch.int64), 0, h - 1)
    flat = luma8.reshape(bsz, hp * wp)
    bright = torch.gather(flat, 1, (yi * wp + xi).reshape(bsz, -1))
    bright = bright.to(torch.int32).reshape(xi.shape)  # (B, T, nb)

    min_b = bright.amin(dim=-1)
    max_b = bright.amax(dim=-1)
    contrast_ok = (max_b - min_b) >= min_contrast
    mid = torch.div(min_b + max_b + 1, 2, rounding_mode="floor")
    bits_msb = bright > mid[..., None]  # position order (MSB first)
    invalid = (
        torch.abs(mid[..., None] - bright) < valid_brightness_threshold
    ).sum(-1)
    bits_ok = invalid <= max_invalid_bit

    lsb = torch.flip(bits_msb, dims=(-1,)).to(torch.float32)
    perms = device_table(_rot_perms, (spec.edge,), dev)     # (4, nb)
    rots = lsb[..., perms]                                   # (B, T, 4, nb)
    gates = torch.stack([corners_ok, sample_ok, contrast_ok & bits_ok], -1)
    return rots, gates


def _decode_post(
    best_score: torch.Tensor,  # (B, T, 4) min hamming per rotation
    best_idx: torch.Tensor,    # (B, T, 4) FIRST argmin per rotation
    gates: torch.Tensor,       # (B, T, 3) bool
    quad_pos: torch.Tensor,    # (B, T, 4, 2)
    spec: FamilySpec,
) -> DecodedTags:
    rot_ok = best_score < float(spec.hamming_distance)
    rotation = torch.argmax(rot_ok.to(torch.uint8), dim=-1)  # first accepted
    tag_ok = rot_ok.any(dim=-1)
    ids = torch.gather(best_idx, -1, rotation[..., None])[..., 0]

    # --- canonical corner order: rotate_left(rotation) then reverse
    j = torch.arange(4, device=quad_pos.device)
    order = (3 - j + rotation[..., None]) % 4  # (B, T, 4)
    corners = torch.gather(
        quad_pos, 2, order[..., None].expand(*order.shape, 2)
    )

    valid = gates.all(dim=-1) & tag_ok
    return DecodedTags(
        ids=torch.where(valid, ids.to(torch.int32), -1),
        corners=corners,
        valid=valid,
    )


def decode_quads_batch(
    luma8: torch.Tensor,       # (B, Hp, Wp) u8
    quad_pos: torch.Tensor,    # (B, T, 4, 2)
    quad_valid: torch.Tensor,  # (B, T) bool
    spec: FamilySpec,
    margin: float,
    valid_brightness_threshold: int,
    max_invalid_bit: int,
    min_contrast: int,
    true_shape: tuple[int, int] | None = None,
) -> DecodedTags:
    """try_decode_quad for every candidate quad of every frame
    (src/detector.rs:448-476). ``true_shape`` gives the real (h, w) when
    ``luma8`` is padded."""
    from ..kernels.decode import hamming_scan

    rots, gates = _decode_pre(
        luma8, quad_pos, quad_valid, spec, margin,
        valid_brightness_threshold, max_invalid_bit, min_contrast,
        true_shape,
    )
    bsz, t, _, nb = rots.shape
    mins, idxs = hamming_scan(
        rots.reshape(bsz, t * 4, nb), spec.code_bits_tensor(rots.device)
    )
    return _decode_post(
        mins.reshape(bsz, t, 4), idxs.reshape(bsz, t, 4), gates, quad_pos,
        spec,
    )
