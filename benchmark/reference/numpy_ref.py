"""NumPy oracle: a semantics-exact host re-implementation of the reference
AprilGrid detector (powei-lin/aprilgrid-rs).

Frozen copy of ``aprilgrid_tpu/oracle/numpy_ref.py`` for the benchmark:
only the imports of the default parameters and the family table changed,
to the frozen ones in ``config.py`` beside this file
(``benchmark/tests/test_bench_reference.py`` holds the two equal).

This module is NOT the TPU pipeline — it exists so the JAX/Pallas pipeline
has a bit-accurate oracle to test against (SURVEY.md section 4: per-stage
numerical parity tests), and to dump golden per-stage artifacts for the
bundled test images. Every function cites the reference code it models.

Performance is irrelevant here; fidelity is everything. In particular we
reproduce Rust quirks: ``f32::round`` rounds half away from zero and
``as u32`` saturates negatives to 0 (reference relies on this when bounds
checking decode sample positions, src/detector.rs:50-55,83-89).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy import ndimage
from scipy.spatial import cKDTree

# ---------------------------------------------------------------------------
# Image conversions (image-crate semantics)
# ---------------------------------------------------------------------------

# Rec.709 luma coefficients used by the `image` crate for RGB -> Luma.
_SRGB_LUMA = (0.2126, 0.7152, 0.0722)


def to_luma32f(img: np.ndarray) -> np.ndarray:
    """DynamicImage::to_luma32f equivalent -> float32 gray in [0, 1].

    Accepts every DynamicImage layout the reference converts at
    src/detector.rs:409: (H, W) u8/u16/f32 gray, (H, W, 2) u8/u16
    gray+alpha (alpha dropped, no premultiply — image-crate FromColor
    semantics), and (H, W, 3|4) u8/u16/f32 RGB(A). RGB uses the crate's
    Rec.709 float weights on normalized channels; integer gray scales
    by the type maximum.
    """
    if img.ndim == 3 and img.shape[2] == 2:
        return to_luma32f(img[..., 0])  # LumaA: alpha is dropped
    if img.ndim == 2:
        if img.dtype == np.uint8:
            return img.astype(np.float32) / 255.0
        if img.dtype == np.uint16:
            return img.astype(np.float32) / 65535.0
        if img.dtype in (np.float32, np.float64):
            return img.astype(np.float32)  # Luma32F: identity
        raise TypeError(f"unsupported gray dtype {img.dtype}")
    if img.ndim == 3 and img.shape[2] in (3, 4):
        if img.dtype == np.uint8:
            rgb = img[..., :3].astype(np.float32) / 255.0
        elif img.dtype == np.uint16:
            rgb = img[..., :3].astype(np.float32) / 65535.0
        elif img.dtype in (np.float32, np.float64):
            rgb = img[..., :3].astype(np.float32)
        else:
            raise TypeError(f"unsupported rgb dtype {img.dtype}")
        return (
            _SRGB_LUMA[0] * rgb[..., 0]
            + _SRGB_LUMA[1] * rgb[..., 1]
            + _SRGB_LUMA[2] * rgb[..., 2]
        ).astype(np.float32)
    raise TypeError(f"unsupported image shape/dtype {img.shape} {img.dtype}")


def _scale_u16_to_u8(v: np.ndarray) -> np.ndarray:
    """Image-crate u16 -> u8 component conversion (rounding 255/65535)."""
    return ((v.astype(np.uint32) * 255 + 32767) // 65535).astype(np.uint8)


def to_luma8(img: np.ndarray) -> np.ndarray:
    """DynamicImage::to_luma8 equivalent -> uint8 gray.

    Same input coverage as :func:`to_luma32f` (src/detector.rs:507).
    Integer RGB uses the crate's integer luma path in the SOURCE
    component domain — (2126 R + 7152 G + 722 B) / 10000 — then scales
    the component to u8; float components clamp to [0, 1] and round
    (f32::round: half away from zero)."""
    if img.ndim == 3 and img.shape[2] == 2:
        return to_luma8(img[..., 0])  # LumaA: alpha is dropped
    if img.ndim == 2:
        if img.dtype == np.uint8:
            return img
        if img.dtype == np.uint16:
            # u16 -> u8 with rounding scale by 255/65535.
            return _scale_u16_to_u8(img)
        if img.dtype in (np.float32, np.float64):
            return rust_round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
        raise TypeError(f"unsupported gray dtype {img.dtype}")
    if img.ndim == 3 and img.shape[2] in (3, 4):
        if img.dtype == np.uint8:
            # Integer luma path: (2126 R + 7152 G + 722 B) / 10000.
            rgb = img[..., :3].astype(np.uint32)
            return (
                (2126 * rgb[..., 0] + 7152 * rgb[..., 1] + 722 * rgb[..., 2])
                // 10000
            ).astype(np.uint8)
        if img.dtype == np.uint16:
            # luma in the u16 source domain, then component scale to u8
            rgb = img[..., :3].astype(np.uint32)
            luma16 = (
                2126 * rgb[..., 0] + 7152 * rgb[..., 1] + 722 * rgb[..., 2]
            ) // 10000
            return _scale_u16_to_u8(luma16)
        if img.dtype in (np.float32, np.float64):
            return to_luma8(to_luma32f(img))
        raise TypeError(f"unsupported rgb dtype {img.dtype}")
    raise TypeError(f"unsupported image shape/dtype {img.shape} {img.dtype}")


def load_image(path: str) -> np.ndarray:
    """Load a PNG preserving bit depth/channels (test set has L8/I;16/RGB8)."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("I;16", "I;16B", "I"):
            arr = np.array(im, dtype=np.uint16 if im.mode != "I" else np.int32)
            if arr.dtype == np.int32:
                arr = arr.astype(np.uint16)
            return arr
        if im.mode == "L":
            return np.array(im, dtype=np.uint8)
        if im.mode == "LA":
            return np.array(im, dtype=np.uint8)  # (H, W, 2) gray+alpha
        if im.mode == "RGBA":
            return np.array(im, dtype=np.uint8)  # alpha dropped downstream
        return np.array(im.convert("RGB"), dtype=np.uint8)


def rust_round(x):
    """f32::round — half away from zero (numpy rounds half to even)."""
    return np.copysign(np.floor(np.abs(x) + 0.5), x)


# ---------------------------------------------------------------------------
# Math utils (reference: src/math_util.rs)
# ---------------------------------------------------------------------------

def find_xy(a0, b0, c0, a1, b1, c1):
    """Solve [[a0,b0],[a1,b1]] @ [x,y] = [-c0,-c1] (src/math_util.rs:5-12)."""
    det = a0 * b1 - b0 * a1
    x = (-c0 * b1 - b0 * -c1) / det
    y = (a0 * -c1 - -c0 * a1) / det
    return x, y


def theta_distance_degree(t0, t1):
    """Line-angle distance folded to [0, 90] (src/math_util.rs:15-23)."""
    d = t0 - t1 + 90.0
    if d < 0.0:
        d += 180.0
    elif d > 180.0:
        d -= 180.0
    return d - 90.0 if d > 90.0 else 90.0 - d


def cross(v0, v1):
    return v0[0] * v1[1] - v0[1] * v1[0]


def dot(v0, v1):
    return v0[0] * v1[0] + v0[1] * v1[1]


def angle_degree(v0, v1):
    """Signed angle from v0 to v1 in degrees (src/math_util.rs:31-33)."""
    return math.degrees(
        math.atan2(v1[1] * v0[0] - v1[0] * v0[1], v0[0] * v1[0] + v0[1] * v1[1])
    )


# ---------------------------------------------------------------------------
# Saddle struct + quad validity (reference: src/saddle.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Saddle:
    p: tuple  # (x, y)
    k: float
    theta: float
    phi: float


def is_valid_quad(s0: Saddle, d0: Saddle, s1: Saddle, d1: Saddle) -> bool:
    """Geometric gates for a candidate tag quad (src/saddle.rs:17-67)."""
    if theta_distance_degree(d0.theta, d1.theta) > 5.0:
        return False
    v01 = (d0.p[0] - s0.p[0], d0.p[1] - s0.p[1])
    v03 = (d1.p[0] - s0.p[0], d1.p[1] - s0.p[1])
    v02 = (s1.p[0] - s0.p[0], s1.p[1] - s0.p[1])

    # white-block filter: diagonal must be 60..120 deg from s0's ridge axis
    s0_theta = math.radians(s0.theta)
    v_theta = (math.cos(s0_theta), math.sin(s0_theta))
    angle = abs(angle_degree(v02, v_theta))
    if not (60.0 <= angle <= 120.0):
        return False

    c0 = cross(v01, v02)
    c1 = cross(v02, v03)
    if c0 * c1 < 0.0:
        return False
    v12 = (s1.p[0] - d0.p[0], s1.p[1] - d0.p[1])
    v23 = (d1.p[0] - s1.p[0], d1.p[1] - s1.p[1])
    c01 = cross(v01, v12)
    c12 = cross(v12, v23)
    if c01 * c12 < 0.0:
        return False
    v30 = (s0.p[0] - d1.p[0], s0.p[1] - d1.p[1])
    a0 = angle_degree(v01, v12)
    a1 = angle_degree(v12, v23)
    a2 = angle_degree(v23, v30)
    a3 = angle_degree(v30, v01)
    if abs(a0 - a2) > 10.0 or abs(a1 - a3) > 10.0:
        return False
    if dot(v01, v02) < 0.0 or dot(v03, v02) < 0.0:
        return False
    return True


# ---------------------------------------------------------------------------
# Dense front-end (reference: src/image_util.rs)
# ---------------------------------------------------------------------------

def gaussian_kernel(sigma: float) -> np.ndarray:
    """Normalized 1-D kernel, radius = ceil(2*sigma) (src/image_util.rs:110-124)."""
    radius = int(math.ceil(sigma * 2.0))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x * x) / np.float32(2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur_f32(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable blur with clamped (edge-replicate) borders
    (src/image_util.rs:110-206): horizontal pass then vertical pass."""
    k = gaussian_kernel(sigma)
    radius = (len(k) - 1) // 2
    img = img.astype(np.float32)
    padded = np.pad(img, ((0, 0), (radius, radius)), mode="edge")
    temp = np.zeros_like(img)
    for i, kw in enumerate(k):
        temp += padded[:, i : i + img.shape[1]] * kw
    padded = np.pad(temp, ((radius, radius), (0, 0)), mode="edge")
    out = np.zeros_like(img)
    for i, kw in enumerate(k):
        out += padded[i : i + img.shape[0], :] * kw
    return out


def hessian_response(img: np.ndarray) -> np.ndarray:
    """det of the 3x3 Hessian stencil; borders stay 0 (src/image_util.rs:72-109)."""
    out = np.zeros_like(img, dtype=np.float32)
    v = img
    lxx = v[1:-1, :-2] - 2.0 * v[1:-1, 1:-1] + v[1:-1, 2:]
    lyy = v[:-2, 1:-1] - 2.0 * v[1:-1, 1:-1] + v[2:, 1:-1]
    lxy = (v[:-2, 2:] - v[:-2, :-2] + v[2:, :-2] - v[2:, 2:]) * 0.25
    out[1:-1, 1:-1] = lxx * lyy - lxy * lxy
    return out


def saddle_cluster_centers(resp: np.ndarray, threshold: float) -> list:
    """Flood-fill clustering + centroids
    (src/image_util.rs:208-236, src/detector.rs:171-187,421-429).

    4-connected components of {resp < threshold}; centroid in (x, y)."""
    mask = resp < threshold
    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)
    labels, n = ndimage.label(mask, structure=structure)
    centers = []
    if n:
        ys, xs = np.nonzero(mask)
        lab = labels[ys, xs]
        sx = np.bincount(lab, weights=xs, minlength=n + 1)
        sy = np.bincount(lab, weights=ys, minlength=n + 1)
        cnt = np.bincount(lab, minlength=n + 1)
        for i in range(1, n + 1):
            centers.append((sx[i] / cnt[i], sy[i] / cnt[i]))
    return centers


def _rochade_pinv(half_patch: int) -> np.ndarray:
    """Pseudo-inverse of the quadric design matrix [x^2 xy y^2 x y 1]
    (src/detector.rs:208-237). Returns (6, n_pixels)."""
    size = 2 * half_patch + 1
    rows = []
    for r in range(size):
        for c in range(size):
            x = float(c - half_patch)
            y = float(r - half_patch)
            rows.append([x * x, x * y, y * y, x, y, 1.0])
    a = np.array(rows, dtype=np.float64)
    return np.linalg.pinv(a)


def _cone_kernel(half_patch: int) -> np.ndarray:
    """Normalized cone smoothing kernel (src/detector.rs:240-254)."""
    size = 2 * half_patch + 1
    gamma = float(half_patch)
    k = np.zeros((size, size), dtype=np.float64)
    for i in range(size):
        for j in range(size):
            k[i, j] = max(
                0.0, gamma + 1.0 - math.hypot(gamma - i, gamma - j)
            )
    return k / k.sum()


def rochade_refine(img_blur: np.ndarray, initial_corners, half_patch: int = 2):
    """ROCHADE saddle refinement (src/detector.rs:194-361)."""
    pinv = _rochade_pinv(half_patch)
    cone = _cone_kernel(half_patch)
    size = 2 * half_patch + 1
    h, w = img_blur.shape
    hp2 = half_patch * 2
    out = []
    for (ix, iy) in initial_corners:
        rx = int(rust_round(ix))
        ry = int(rust_round(iy))
        if ry - hp2 < 0 or ry + hp2 >= h or rx - hp2 < 0 or rx + hp2 >= w:
            continue
        patch = img_blur[ry - hp2 : ry + hp2 + 1, rx - hp2 : rx + hp2 + 1]
        # 'valid' correlation of the (2k+1)x(2k+1) patch with the cone kernel
        smooth = np.zeros((size, size), dtype=np.float64)
        for r in range(size):
            for c in range(size):
                smooth[r, c] = float(
                    np.sum(patch[r : r + size, c : c + size].astype(np.float64) * cone)
                )
        a1, a2, a3, a4, a5, _a6 = pinv @ smooth.reshape(-1)
        d = (2.0 * a1) * (2.0 * a3) - a2 * a2
        if d >= 0.0:
            continue
        x0, y0 = find_xy(2.0 * a1, a2, a4, a2, 2.0 * a3, a5)
        if abs(x0) > 1.0 or abs(y0) > 1.0:
            continue
        c5 = (a1 + a3) / 2.0
        c4 = (a1 - a3) / 2.0
        c3 = a2 / 2.0
        k = math.hypot(c4, c3)
        if abs(c5) >= k:
            continue
        phi = math.degrees(math.acos(-c5 / k) / 2.0)
        theta = math.degrees(math.atan2(c3, c4) / 2.0)
        out.append(Saddle(p=(rx + x0, ry + y0), k=k, theta=theta, phi=phi))
    return out


def refined_saddle_points(img: np.ndarray, params=None):
    """Front-end: gray -> blur -> hessian -> clusters -> ROCHADE -> filters
    (src/detector.rs:408-446)."""
    from .config import DEFAULT_PARAMS

    params = params or DEFAULT_PARAMS
    luma = to_luma32f(img)
    blur = gaussian_blur_f32(luma, 1.5)
    resp = hessian_response(blur)
    thr = float(resp.min()) * 0.05
    centers = saddle_cluster_centers(resp, thr)
    saddles = rochade_refine(blur, centers, 2)
    if not saddles:
        return []
    max_k = max(s.k for s in saddles) / 10.0
    return [
        s
        for s in saddles
        if s.k >= max_k and params.min_saddle_angle <= s.phi <= params.max_saddle_angle
    ]


def decimated_refined_saddle_points(img: np.ndarray, params=None):
    """Oracle for the APPROXIMATE decimated ("turbo") front-end (no
    reference equivalent — pipeline._decimated_tail semantics): the full
    half-resolution front-end (blur -> response -> clusters -> ROCHADE ->
    k/phi gates on the 2x2-mean plane), survivors scaled back to full
    resolution (half pixel (x, y) sits at (2x+0.5, 2y+0.5)) and
    re-refined with a full-resolution ROCHADE fit, then re-gated."""
    from .config import DEFAULT_PARAMS

    params = params or DEFAULT_PARAMS
    luma = to_luma32f(img)
    h, w = luma.shape
    hh, ww = h // 2 * 2, w // 2 * 2
    x = luma[:hh, :ww].reshape(hh // 2, 2, ww // 2, 2)
    # pairwise association matches pipeline._decimate2 / the Pallas
    # turbo front-end bit-exactly
    half = (
        (x[:, 0, :, 0] + x[:, 0, :, 1]) + (x[:, 1, :, 0] + x[:, 1, :, 1])
    ) * np.float32(0.25)
    blur_h = gaussian_blur_f32(half, 1.5)
    resp_h = hessian_response(blur_h)
    thr = float(resp_h.min()) * 0.05
    centers_h = saddle_cluster_centers(resp_h, thr)
    saddles_h = rochade_refine(blur_h, centers_h, 2)
    if not saddles_h:
        return []
    max_k = max(s.k for s in saddles_h) / 10.0
    survivors = [
        s
        for s in saddles_h
        if s.k >= max_k and params.min_saddle_angle <= s.phi <= params.max_saddle_angle
    ]
    if not survivors:
        return []
    blur_f = gaussian_blur_f32(luma, 1.5)
    pts = [(2.0 * s.p[0] + 0.5, 2.0 * s.p[1] + 0.5) for s in survivors]
    refined = rochade_refine(blur_f, pts, 2)
    if not refined:
        return []
    max_k = max(s.k for s in refined) / 10.0
    return [
        s
        for s in refined
        if s.k >= max_k and params.min_saddle_angle <= s.phi <= params.max_saddle_angle
    ]


# ---------------------------------------------------------------------------
# Quad hypotheses (reference: src/detector.rs:543-586)
# ---------------------------------------------------------------------------

def init_quads(refined, s0_idx, tree: cKDTree):
    out = []
    s0 = refined[s0_idx]
    n = min(50, len(refined))
    _dists, idxs = tree.query(s0.p, k=n)
    idxs = np.atleast_1d(idxs)
    same, diff = [], []
    for s_idx in idxs[1:]:
        s = refined[s_idx]
        td = theta_distance_degree(s0.theta, s.theta)
        if td < 5.0:
            same.append(int(s_idx))
        elif td > 80.0:
            diff.append(int(s_idx))
    for s1_idx in same:
        s1 = refined[s1_idx]
        for a in range(len(diff)):
            for b in range(a + 1, len(diff)):
                d0 = refined[diff[a]]
                d1 = refined[diff[b]]
                if not is_valid_quad(s0, d0, s1, d1):
                    continue
                v01 = (d0.p[0] - s0.p[0], d0.p[1] - s0.p[1])
                v02 = (s1.p[0] - s0.p[0], s1.p[1] - s0.p[1])
                if cross(v01, v02) > 0.0:
                    out.append([s0_idx, diff[a], s1_idx, diff[b]])
                else:
                    out.append([s0_idx, diff[b], s1_idx, diff[a]])
    return out


# ---------------------------------------------------------------------------
# Board growth (reference: src/board.rs)
# ---------------------------------------------------------------------------

class Board:
    """Grid growth from a seed quad (src/board.rs:18-235)."""

    def __init__(self, refined, active_mask, quad_idxs, spacing_ratio, tree):
        self.refined = refined
        self.tree = tree
        self.spacing_ratio = spacing_ratio
        self.active = list(active_mask)
        for i in quad_idxs[1:]:
            self.active[i] = False
        self.cells = {(0, 0): tuple(quad_idxs)}  # BoardIdx -> quad or None
        self.score = 1
        self._try_expand((0, 0))

    def all_tag_indexes(self):
        return [q for q in self.cells.values() if q is not None]

    def _try_expand(self, bidx):
        quad = self.cells.get(bidx)
        if quad is None:
            return
        x, y = bidx
        for i in range(4):
            qs = list(quad[i:]) + list(quad[:i])  # rotate_left(i)
            new_bidx = [(x + 1, y), (x, y - 1), (x - 1, y), (x, y + 1)][i]
            if self.cells.get(new_bidx) is not None:
                continue
            valid = self._try_expand_one(qs)
            if valid is not None:
                v = valid[-i:] + valid[:-i] if i else valid  # rotate_right(i)
                for vv in v:
                    self.active[vv] = False
                self.score += 1
                self.cells[new_bidx] = tuple(v)
                self._try_expand(new_bidx)
            else:
                self.cells[new_bidx] = None

    def _try_expand_one(self, qs):
        s0, s1, s2, s3 = (self.refined[i] for i in qs)
        n0s, n0, n1s, n1 = self._closest_potential(s0, s1)
        n3s, n3, n2s, n2 = self._closest_potential(s3, s2)
        for idx0 in n0s[:n0]:
            for idx1 in n1s[:n1]:
                for idx2 in n2s[:n2]:
                    for idx3 in n3s[:n3]:
                        if is_valid_quad(
                            self.refined[idx0],
                            self.refined[idx1],
                            self.refined[idx2],
                            self.refined[idx3],
                        ):
                            return [idx0, idx1, idx2, idx3]
        return None

    def _closest_potential(self, s0, s1):
        """Extrapolate the s0->s1 edge outward and 3-NN gate both targets
        (src/board.rs:177-234)."""
        ratio0 = 1.0 + self.spacing_ratio
        dx = s1.p[0] - s0.p[0]
        dy = s1.p[1] - s0.p[1]
        radius_sq = 0.5 * (dx * dx + dy * dy)
        new0 = (s0.p[0] + dx * ratio0, s0.p[1] + dy * ratio0)
        new1 = (s1.p[0] + dx * ratio0, s1.p[1] + dy * ratio0)
        res = []
        for target, ref_s in ((new0, s0), (new1, s1)):
            k = min(3, len(self.refined))
            dists, idxs = self.tree.query(target, k=k)
            dists = np.atleast_1d(dists)
            idxs = np.atleast_1d(idxs)
            out, count = [0, 0, 0], 0
            for dsq, idx in zip(dists * dists, idxs):
                if dsq <= radius_sq and self.active[idx]:
                    td = theta_distance_degree(ref_s.theta, self.refined[idx].theta)
                    if td < 5.0:
                        out[count] = int(idx)
                        count += 1
                        if count == 3:
                            break
            res.extend([out, count])
        return res[0], res[1], res[2], res[3]

    def try_fix_missing(self):
        """Repair interior holes with both neighbors present
        (src/board.rs:52-112)."""
        fixes = []
        for (x, y), q in self.cells.items():
            if q is not None:
                continue
            b0, b1 = (x + 1, y), (x - 1, y)
            b2, b3 = (x, y + 1), (x, y - 1)
            if b0 in self.cells and b1 in self.cells:
                if self.cells[b0] is not None and self.cells[b1] is not None:
                    fixes.append((b0, b1))
            elif (
                b2 in self.cells
                and b3 in self.cells
                and self.cells[b2] is not None
                and self.cells[b3] is not None
            ):
                fixes.append((b2, b3))
        for b0, b1 in fixes:
            q0 = self.cells[b0]
            q1 = self.cells[b1]
            saddle_idxs = []
            for i in range(4):
                mx = (self.refined[q0[i]].p[0] + self.refined[q1[i]].p[0]) / 2.0
                my = (self.refined[q0[i]].p[1] + self.refined[q1[i]].p[1]) / 2.0
                _d, idx = self.tree.query((mx, my), k=1)
                saddle_idxs.append(int(idx))
            if is_valid_quad(*(self.refined[i] for i in saddle_idxs)):
                mid = ((b0[0] + b1[0]) // 2, (b0[1] + b1[1]) // 2)
                self.cells[mid] = tuple(saddle_idxs)


def try_find_best_board(refined):
    """Seed selection + growth + repair (src/detector.rs:588-639)."""
    if not refined:
        return None
    pts = np.array([s.p for s in refined], dtype=np.float64)
    tree = cKDTree(pts)
    active_mask = [True] * len(refined)
    # theta histogram by Rust-rounded integer degree
    buckets = {}
    for i, s in enumerate(refined):
        buckets.setdefault(int(rust_round(s.theta)), []).append(i)
    s0_idxs = list(max(buckets.values(), key=len))
    best_score, best_board = 0, None
    count = 0
    while s0_idxs and count < 30:
        s0_idx = s0_idxs.pop()
        for q in init_quads(refined, s0_idx, tree):
            board = Board(refined, active_mask, q, 0.3, tree)
            if board.score > best_score:
                best_score = board.score
                best_board = board
        if best_score >= 36:
            break
        count += 1
    if best_board is None:
        return None
    best_board.try_fix_missing()
    return best_board.all_tag_indexes()


# ---------------------------------------------------------------------------
# Decode (reference: src/detector.rs:42-169)
# ---------------------------------------------------------------------------

def tag_affine(corners, side_bits: int, margin: float) -> np.ndarray:
    """6-parameter affine via least squares (src/image_util.rs:39-70)."""
    s = float(side_bits) - 1.0 + margin
    source = [(-margin, -margin), (-margin, s), (s, s), (s, -margin)]
    a = np.zeros((8, 6), dtype=np.float64)
    b = np.zeros(8, dtype=np.float64)
    for p in range(4):
        a[2 * p, 0:3] = (source[p][0], source[p][1], 1.0)
        a[2 * p + 1, 3:6] = (source[p][0], source[p][1], 1.0)
        b[2 * p] = corners[p][0]
        b[2 * p + 1] = corners[p][1]
    h, *_ = np.linalg.lstsq(a, b, rcond=None)
    return np.array(
        [[h[0], h[1], h[2]], [h[3], h[4], h[5]], [0.0, 0.0, 1.0]], dtype=np.float64
    )


def decode_positions(img_w, img_h, quad_pts, border_bits, edge_bits, margin):
    """Bit-cell centers in image coords, x-major (src/detector.rs:42-72).

    Rust bound check: round then `as u32` (negative saturates to 0), reject
    only when >= width/height."""
    for (x, y) in quad_pts:
        xi = max(0, int(rust_round(x)))
        yi = max(0, int(rust_round(y)))
        if xi >= img_w or yi >= img_h:
            return None
    side_bits = border_bits * 2 + edge_bits
    aff = tag_affine(quad_pts, side_bits, margin)
    out = []
    for x in range(border_bits, border_bits + edge_bits):
        for y in range(border_bits, border_bits + edge_bits):
            t = aff @ np.array([x, y, 1.0])
            out.append((float(t[0]), float(t[1])))
    return out


def bit_code(img_gray_u8, decode_pts, valid_brightness_threshold, max_invalid_bit):
    """Sample, threshold at mid brightness, assemble MSB-first
    (src/detector.rs:74-122)."""
    h, w = img_gray_u8.shape
    brightness = []
    for (x, y) in decode_pts:
        xi = max(0, int(rust_round(x)))
        yi = max(0, int(rust_round(y)))
        if xi >= w or yi >= h:
            return None
        brightness.append(int(img_gray_u8[yi, xi]))
    min_b, max_b = min(brightness), max(brightness)
    if max_b - min_b < 50:
        return None
    mid = int(rust_round((min_b + max_b) / 2.0))
    bits = 0
    invalid = 0
    for i, b in enumerate(reversed(brightness)):
        if abs(mid - b) < valid_brightness_threshold:
            invalid += 1
        if b > mid:
            bits |= 1 << i
    if invalid > max_invalid_bit:
        return None
    return bits


def rotate_bits(bits: int, edge_bits: int) -> int:
    """90-degree rotation of the edge x edge bit square
    (src/detector.rs:124-140)."""
    b = 0
    count = 0
    for r in range(edge_bits - 1, -1, -1):
        for c in range(edge_bits):
            b |= ((bits >> (r + c * edge_bits)) & 1) << count
            count += 1
    return b


def best_tag(bits, thres, codes, edge_bits):
    """4-rotation hamming search over the family table
    (src/detector.rs:142-169)."""
    for rotated in range(4):
        scores = [bin(int(c) ^ bits).count("1") for c in codes]
        best_idx = int(np.argmin(scores))
        if scores[best_idx] < thres:
            return best_idx, rotated
        if rotated == 3:
            break
        bits = rotate_bits(bits, edge_bits)
    return None


# ---------------------------------------------------------------------------
# Detector facade (reference: src/detector.rs:363-541)
# ---------------------------------------------------------------------------

class TagDetector:
    def __init__(self, family="t36h11", params=None):
        from .config import DEFAULT_PARAMS, get_family

        self.spec = get_family(family)
        self.params = params or DEFAULT_PARAMS

    def refined_saddle_points(self, img):
        return refined_saddle_points(img, self.params)

    def _try_decode_quad(self, img_gray_u8, quad_points):
        h, w = img_gray_u8.shape
        pts = decode_positions(
            w, h, quad_points, self.spec.border, self.spec.edge, 0.5
        )
        if pts is None:
            return None
        bits = bit_code(img_gray_u8, pts, 10, 3)
        if bits is None:
            return None
        res = best_tag(bits, self.spec.hamming_distance, self.spec.codes, self.spec.edge)
        if res is None:
            return None
        tag_id, rotation = res
        q = list(quad_points)
        q = q[rotation:] + q[:rotation]  # rotate_left
        q.reverse()
        return tag_id, q

    def detect(self, img):
        """Main entry (src/detector.rs:505-540): returns {id: 4 corners}."""
        detected = {}
        gray8 = to_luma8(img)
        refined = self.refined_saddle_points(img)
        for _ in range(self.params.max_num_of_boards):
            board_tags = try_find_best_board(refined)
            if board_tags is None:
                continue
            to_remove = set()
            for quad_indexes in board_tags:
                quad_points = [refined[i].p for i in quad_indexes]
                res = self._try_decode_quad(gray8, quad_points)
                if res is not None:
                    tag_id, corners = res
                    detected[tag_id] = corners
                    to_remove.update(quad_indexes)
            refined = [s for i, s in enumerate(refined) if i not in to_remove]
        return detected
