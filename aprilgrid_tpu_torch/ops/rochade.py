"""Batched ROCHADE subpixel saddle refinement.

The reference refines each cluster centroid with a per-corner scalar loop
(rochade_refine, src/detector.rs:194-361): smooth a 5x5 patch of the
blurred image with a cone kernel, fit a 6-parameter quadric, require a
saddle (negative Hessian det), solve grad=0 for the subpixel offset, and
gate on a <=1 px move. Here all corners refine at once on gathered 9x9
support patches.

The quadric fit is evaluated as the cluster kernel evaluates it: each of
the five fit stencils is exactly rank-1, so it runs as a 5-tap vertical
pass then a 5-tap horizontal pass (``_pinv_rank1``), every tap one
multiply and one add in a fixed order. The JAX package's XLA path
contracts the dense 25-tap pseudo-inverse instead; the two agree to a few
f32 ulps. Keeping one op sequence here and in ``csrc/cluster.cu`` makes
the kernel and its plain version bit-identical.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .geometry import rust_round


class Saddles(NamedTuple):
    """SoA saddle set (reference struct: src/saddle.rs:3-9); leading
    dimensions are free (the pipeline uses (B, K))."""

    p: torch.Tensor       # (..., K, 2) float32 subpixel positions (x, y)
    k: torch.Tensor       # (..., K) saddle strength
    theta: torch.Tensor   # (..., K) ridge orientation, degrees
    phi: torch.Tensor     # (..., K) opening angle, degrees
    valid: torch.Tensor   # (..., K) bool


@functools.lru_cache(maxsize=None)
def _constants(half_patch: int) -> tuple[np.ndarray, np.ndarray]:
    """(pinv (6, n), cone (size, size)) — reference src/detector.rs:208-254."""
    size = 2 * half_patch + 1
    rows = []
    for r in range(size):
        for c in range(size):
            x = float(c - half_patch)
            y = float(r - half_patch)
            rows.append([x * x, x * y, y * y, x, y, 1.0])
    pinv = np.linalg.pinv(np.array(rows, dtype=np.float64)).astype(np.float32)
    gamma = float(half_patch)
    cone = np.zeros((size, size), dtype=np.float64)
    for i in range(size):
        for j in range(size):
            cone[i, j] = max(0.0, gamma + 1.0 - math.hypot(gamma - i, gamma - j))
    cone = (cone / cone.sum()).astype(np.float32)
    return pinv, cone


@functools.lru_cache(maxsize=None)
def _pinv_rank1(half_patch: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Rank-1 (vertical, horizontal) float64 factors of the 5 quadric-fit
    stencils — exact: each pinv row over the product grid is separable
    (singular values beyond the first are ~1e-17)."""
    pinv, _ = _constants(half_patch)
    size = 2 * half_patch + 1
    out = []
    for j in range(5):
        m = pinv[j].reshape(size, size).astype(np.float64)
        u, s, vt = np.linalg.svd(m)
        assert s[1] < 1e-10 * max(s[0], 1e-30), "pinv stencil not rank-1"
        c = u[:, 0] * np.sqrt(s[0])
        r = vt[0] * np.sqrt(s[0])
        # sign-normalize the vertical factor so equal factors share
        k = np.argmax(np.abs(c))
        if c[k] < 0:
            c, r = -c, -r
        out.append((c, r))
    return out


@functools.lru_cache(maxsize=None)
def fit_taps(half_patch: int) -> tuple[tuple, tuple]:
    """The fit's f32 tap lists, in evaluation order.

    Returns ``(cone, fits)``: ``cone`` is ((dr, dc, w), ...) over the
    nonzero cone weights, row-major; ``fits`` holds, per coefficient
    a1..a5, ``(vid, vtaps, htaps)`` where ``vid`` names the vertical
    factor (equal factors share one pass, as the cluster kernel shares
    them) and the tap lists are ((d, w), ...) over nonzero weights."""
    _, cone_np = _constants(half_patch)
    size = 2 * half_patch + 1
    cone = tuple(
        (dr, dc, float(cone_np[dr, dc]))
        for dr in range(size) for dc in range(size)
        if float(cone_np[dr, dc]) != 0.0
    )
    vkeys: dict = {}
    fits = []
    for cvec, rvec in _pinv_rank1(half_patch):
        key = tuple(np.round(cvec, 12))
        if key not in vkeys:
            vkeys[key] = (len(vkeys), cvec)
        vid, cfirst = vkeys[key]
        vt = tuple((d, float(np.float32(cfirst[d]))) for d in range(size)
                   if float(cfirst[d]) != 0.0)
        ht = tuple((d, float(np.float32(rvec[d]))) for d in range(size)
                   if float(rvec[d]) != 0.0)
        fits.append((vid, vt, ht))
    return cone, tuple(fits)


def fit_record(patch: torch.Tensor, half_patch: int = 2,
               move_threshold: float = 1.0):
    """Quadric fit on (..., 9, 9) blur support patches centred on the
    rounded candidate (reference src/detector.rs:330-356).

    Returns ``(x0, y0, c3, c4, c5, ok)``: the subpixel offsets, the
    quadric coefficients and the accept gate (d < 0, |move| <= thr,
    |c5| < k), each of shape (...)."""
    cone, fits = fit_taps(half_patch)
    size = 2 * half_patch + 1
    smooth = torch.zeros(patch.shape[:-2] + (size, size), dtype=patch.dtype,
                         device=patch.device)
    for dr, dc, wgt in cone:
        smooth = smooth + wgt * patch[..., dr : dr + size, dc : dc + size]
    vert: dict = {}
    a = []
    for vid, vtaps, htaps in fits:
        if vid not in vert:
            v = torch.zeros_like(smooth[..., 0, :])
            for d, wgt in vtaps:
                v = v + wgt * smooth[..., d, :]
            vert[vid] = v
        acc = torch.zeros_like(smooth[..., 0, 0])
        for d, wgt in htaps:
            acc = acc + wgt * vert[vid][..., d]
        a.append(acc)
    a1, a2, a3, a4, a5 = a
    dqf = (2.0 * a1) * (2.0 * a3) - a2 * a2
    safe_d = torch.where(dqf == 0.0, torch.ones_like(dqf), dqf)
    x0 = (-2.0 * a3 * a4 + a2 * a5) / safe_d
    y0 = (-2.0 * a1 * a5 + a2 * a4) / safe_d
    c5 = (a1 + a3) * 0.5
    c4 = (a1 - a3) * 0.5
    c3 = a2 * 0.5
    kk = torch.sqrt(c4 * c4 + c3 * c3)
    ok = (
        (dqf < 0.0)
        & (torch.abs(x0) <= move_threshold)
        & (torch.abs(y0) <= move_threshold)
        & (torch.abs(c5) < kk)
    )
    return x0, y0, c3, c4, c5, ok


def saddle_angles(c3: torch.Tensor, c4: torch.Tensor, c5: torch.Tensor):
    """(k, theta, phi) from the quadric coefficients
    (src/detector.rs:344-353)."""
    k = torch.sqrt(c4 * c4 + c3 * c3)
    safe_k = torch.where(k == 0, torch.ones_like(k), k)
    theta = torch.rad2deg(torch.atan2(c3, c4) / 2.0)
    phi = torch.rad2deg(torch.acos(torch.clamp(-c5 / safe_k, -1.0, 1.0)) / 2.0)
    return k, theta, phi


def refine_patches(
    patch: torch.Tensor,      # (K, 9, 9) blur values
    rx: torch.Tensor,         # (K,) int rounded centers
    ry: torch.Tensor,
    in_bounds: torch.Tensor,  # (K,) bool validity incl. bounds gate
    half_patch: int = 2,
    move_threshold: float = 1.0,
) -> Saddles:
    """Quadric fit + gates on pre-gathered blur support patches."""
    x0, y0, c3, c4, c5, ok = fit_record(patch, half_patch, move_threshold)
    k, theta, phi = saddle_angles(c3, c4, c5)
    p = torch.stack([rx.to(torch.float32) + x0, ry.to(torch.float32) + y0], -1)
    return Saddles(p=p, k=k, theta=theta, phi=phi, valid=in_bounds & ok)


def gather_patches(blur: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
                   half_patch: int = 2) -> torch.Tensor:
    """(K, 9, 9) support patches of an (H, W) blur plane around the
    rounded centers (clamped to the plane; out-of-bounds candidates are
    gated by the caller)."""
    h, w = blur.shape
    hp2 = 2 * half_patch
    sx = torch.clamp(rx - hp2, 0, w - 2 * hp2 - 1)
    sy = torch.clamp(ry - hp2, 0, h - 2 * hp2 - 1)
    off = torch.arange(2 * hp2 + 1, device=blur.device)
    ys = sy[:, None, None] + off[None, :, None]
    xs = sx[:, None, None] + off[None, None, :]
    return blur[ys, xs]


def rochade_refine(
    blur: torch.Tensor,
    centers: torch.Tensor,
    centers_valid: torch.Tensor,
    half_patch: int = 2,
    move_threshold: float = 1.0,
) -> Saddles:
    """Refine all candidate corners of one (H, W) blur plane at once
    (src/detector.rs:194-361)."""
    hp2 = 2 * half_patch
    h, w = blur.shape
    rx = rust_round(centers[:, 0]).to(torch.int64)
    ry = rust_round(centers[:, 1]).to(torch.int64)
    in_bounds = (
        (ry - hp2 >= 0) & (ry + hp2 < h) & (rx - hp2 >= 0) & (rx + hp2 < w)
    ) & centers_valid
    patch = gather_patches(blur, rx, ry, half_patch)
    return refine_patches(patch, rx, ry, in_bounds, half_patch, move_threshold)


def filter_and_compact(
    s: Saddles,
    max_saddles: int,
    k_ratio: float,
    min_phi: float,
    max_phi: float,
) -> Saddles:
    """Strength + opening-angle gates and compaction to capacity
    (src/detector.rs:432-445), per frame over (B, K) saddle sets: the
    kept saddles move to the front in their original order."""
    neg_inf = torch.full_like(s.k, -math.inf)
    max_k = torch.amax(torch.where(s.valid, s.k, neg_inf), dim=-1, keepdim=True)
    keep = (
        s.valid
        & (s.k >= max_k * k_ratio)
        & (s.phi >= min_phi)
        & (s.phi <= max_phi)
    )
    b, n = keep.shape
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)
    if n < max_saddles:
        order = torch.cat(
            [order, order.new_zeros((b, max_saddles - n))], dim=-1
        )
    idx = order[:, :max_saddles]
    valid = torch.arange(max_saddles, device=keep.device)[None, :] < keep.sum(
        -1, keepdim=True
    )

    def take(x):
        x = torch.gather(x, 1, idx)
        return torch.where(valid, x, torch.zeros_like(x))

    p = torch.gather(s.p, 1, idx[..., None].expand(b, max_saddles, 2))
    return Saddles(
        p=torch.where(valid[..., None], p, torch.zeros_like(p)),
        k=take(s.k),
        theta=take(s.theta),
        phi=take(s.phi),
        valid=valid,
    )
