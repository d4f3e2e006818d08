"""TagDetector facade — the public detect API, hybrid mode (exact and turbo).

Mirrors the reference facade (TagDetector, src/detector.rs:17-23,363-541):
the dense front-end and the tag decode run on the card through the port's
kernels; the board search runs on the host in native C++ (native/). A
batch is processed in chunks, each in order:

    front-end -> one device-to-host copy of the packed saddles
    -> board search -> decode -> release decoded saddles -> next pass

for ``max_num_of_boards`` passes (src/detector.rs:510-538). With
``decimate`` the front-end is the approximate turbo path
(pipeline.py::decimated_frontend_batch); frames beyond the fused kernels'
label domain (8K-class) take the plane path
(pipeline.py::planes_frontend_batch) with a warning; everything after the
front-end is the same. ``refined_saddle_points`` is the single-image
front-end (pipeline.py::saddle_frontend), always on the plane path.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from . import native
from .config import CONSTANTS, DEFAULT_CAPACITIES, Capacities, DetectorParams, PipelineConstants
from .families import FamilySpec, TagFamily, get_family
from .kernels.decode import decode_packed
from .pipeline import (
    _turbo_nms_env,
    frontend_packed,
    saddle_frontend,
    turbo_fast_path_ok,
)


class Tag:
    """Detected-tag record (reference struct: src/detector.rs:189-192 —
    declared but unused there; `detect` returns a dict, as the
    reference's detect returns a HashMap). Provided for API parity."""

    __slots__ = ("id", "p")

    def __init__(self, id: int, p):
        self.id = id
        self.p = p

    def __repr__(self):
        return f"Tag(id={self.id}, p={self.p})"


class Saddle:
    """Host-side saddle record (reference struct: src/saddle.rs:3-9)."""

    __slots__ = ("p", "k", "theta", "phi")

    def __init__(self, p, k, theta, phi):
        self.p = p
        self.k = k
        self.theta = theta
        self.phi = phi

    def __repr__(self):
        return f"Saddle(p={self.p}, k={self.k}, theta={self.theta}, phi={self.phi})"


class TagDetector:
    """AprilGrid detector (reference: TagDetector::new, src/detector.rs:364-406).

    ``device`` is where the dense stages run: "cuda" (the default) runs the
    CUDA kernels and raises if no card is present; "cpu" runs their plain
    PyTorch versions.

    ``decimate`` selects the approximate turbo mode: detect at half
    resolution and re-refine the surviving corners at full resolution from
    the raw frame. On frames of 2 MP and more it finds the exact mode's
    tags with corners within 0.1 px of the oracle
    (tests/test_torch_decimate.py); smaller frames lose recall. ``True``:
    always; ``"auto"``: only on frames >= 2 MP; ``False`` (default): the
    exact mode, which keeps reference parity.

    Frames of up to 2^31 - 1 pixels are served: exact frames with ``w >=
    2^16`` or ``h*w >= 2^24`` (turbo: the half plane) are beyond the fused
    kernels' label domain and take the plane path — f32 planes through the
    ``fused_frontend`` kernel, clustering at the sizes of ``capacities``
    (``max_clusters``, ``max_masked``, ``label_prop_rounds``) — with one
    RuntimeWarning per shape. That path takes a chunk in pieces of at most
    ``pipeline.PLANE_PIXELS`` pixels; its int32 labels end at 2^31 pixels
    per frame.

    Only the hybrid mode exists so far: ``mode="xla"`` raises
    NotImplementedError (ROADMAP.md lists the slice that brings it), any
    other mode ValueError, as the JAX facade does."""

    def __init__(
        self,
        family: TagFamily | str = TagFamily.T36H11,
        params: DetectorParams | None = None,
        capacities: Capacities | None = None,
        constants: PipelineConstants | None = None,
        device: str | torch.device = "cuda",
        mode: str = "hybrid",
        decimate: bool | str = False,
    ) -> None:
        if mode not in ("hybrid", "xla"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "xla":
            raise NotImplementedError(
                f"mode={mode!r}: only the hybrid mode is ported; the "
                "on-device board search is queued in ROADMAP.md"
            )
        if decimate not in (False, True, "auto"):
            raise ValueError(f"decimate must be False/True/'auto', got {decimate!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TagDetector: no CUDA device is available; pass "
                    "device='cpu' to run the plain PyTorch versions"
                )
        elif self.device.type != "cpu":
            raise ValueError(f"TagDetector: unsupported device {self.device}")
        self.spec: FamilySpec = get_family(family)
        self.params = params or DetectorParams()
        self.caps = capacities or DEFAULT_CAPACITIES
        self.consts = constants or CONSTANTS
        self.mode = mode
        self.decimate = decimate
        native.build()  # the hybrid path needs the host search: raise now

    def _use_decimate(self, h: int, w: int) -> bool:
        """Resolve the ``decimate`` policy for an (h, w) frame: "auto"
        engages only at >= 2 MP (1024x1024 scenes lose tags at half
        resolution)."""
        if self.decimate == "auto":
            return h * w >= 2_000_000
        return bool(self.decimate)

    def _turbo_nms(self, h: int, w: int) -> bool:
        """The turbo extraction variant for (h, w) frames, a static choice
        as in the JAX package's facade: ``AG_TURBO_NMS`` pins it; "auto"
        takes the NMS kernel iff the frame lies in ``turbo_fast_path_ok``
        and the host has more than one core, else the drain."""
        policy = _turbo_nms_env()
        if policy == "auto":
            return turbo_fast_path_ok(h, w) and (os.cpu_count() or 1) > 1
        return policy == "1"

    # -- public API ---------------------------------------------------------

    def detect(self, img) -> dict[int, list[tuple[float, float]]]:
        """Detect tags in one image; returns {tag_id: 4 corners} with the
        reference's canonical corner ordering (src/detector.rs:505-540)."""
        return self._detect_hybrid(_as_tensor(img)[None])[0]

    def detect_batch(
        self, imgs, chunk: int | None = None
    ) -> list[dict[int, list[tuple[float, float]]]]:
        """Detect over a batch of same-shape frames (axis 0). ``chunk``
        sizes the sub-batches (default: the ``AG_CHUNK`` environment
        variable if set, else ``_default_chunk``)."""
        return self._detect_hybrid(_as_tensor(imgs), chunk=chunk)

    def refined_saddle_points(self, img) -> list[Saddle]:
        """Front-end only (reference: src/detector.rs:408-446): the
        refined saddles of one image, for corner-only consumers. It runs
        the single-image plane path (``pipeline.saddle_frontend``) on
        every DynamicImage mode, whatever the frame size (below 2^31
        pixels)."""
        frame = _as_tensor(img).to(self.device)
        saddles, _ = saddle_frontend(
            frame, self.params, self.consts, self.caps,
            decimate=self._use_decimate(int(frame.shape[0]), int(frame.shape[1])),
        )
        p, k, theta, phi, valid = (t.cpu().numpy() for t in saddles)
        return [
            Saddle(p=(float(p[i, 0]), float(p[i, 1])), k=float(k[i]),
                   theta=float(theta[i]), phi=float(phi[i]))
            for i in np.flatnonzero(valid)
        ]

    # -- hybrid runtime -----------------------------------------------------

    def _detect_hybrid(self, imgs: torch.Tensor, chunk: int | None = None):
        b = int(imgs.shape[0])
        hw = (int(imgs.shape[1]), int(imgs.shape[2]))
        results: list[dict] = [{} for _ in range(b)]
        if self.params.max_num_of_boards == 0 or b == 0:
            return results  # no pass reads a front-end: dispatch none
        if chunk is None:
            env = os.environ.get("AG_CHUNK")
            chunk = int(env) if env is not None else _default_chunk(*hw)
        chunk = max(1, int(chunk))
        n_chunks = -(-b // chunk)
        dec = self._use_decimate(*hw)
        nms = self._turbo_nms(*hw) if dec else None
        for i in range(n_chunks):
            lo, hi = i * b // n_chunks, (i + 1) * b // n_chunks
            self._detect_chunk(imgs[lo:hi], hw, results[lo:hi], dec, nms)
        return results

    def _detect_chunk(self, frames: torch.Tensor, hw, results: list[dict],
                      decimate: bool, nms: bool | None):
        packed, luma8 = frontend_packed(
            frames.to(self.device), self.params, self.consts, self.caps,
            decimate, nms,
        )
        pk = packed.cpu().numpy()  # the chunk's one saddle transfer
        _warn_counters(pk[:, -1, :3])
        pk = pk[:, :-1]
        px = np.ascontiguousarray(pk[..., 0])
        py = np.ascontiguousarray(pk[..., 1])
        theta = np.ascontiguousarray(pk[..., 2])
        alive = (pk[..., 3] > 0.5).astype(np.uint8)
        nb = pk.shape[0]
        # did the LAST pass decode any tag (and so release saddles)?
        changed = np.ones(nb, bool)
        cap = (2 * self.caps.grid_radius + 1) ** 2
        dcap = min(cap, 2 * self.caps.max_tags)
        for p in range(self.params.max_num_of_boards):
            search_alive = alive
            if p > 0:
                # a frame whose previous pass decoded nothing released no
                # saddles: its search input and result are unchanged, so
                # zeroing its alive mask skips it (exact)
                search_alive = alive * changed[:, None].astype(np.uint8)
            changed = np.zeros(nb, bool)
            quads, counts = native.find_board_batch(
                px, py, theta, np.ascontiguousarray(search_alive),
                spacing_ratio=self.params.tag_spacing_ratio,
                max_seeds=self.consts.max_seeds,
                early_exit_score=self.consts.early_exit_score,
                cap=cap,
            )
            if not counts.any():
                continue
            # bucket the decode capacity to the chunk's largest count
            mx = int(counts.max())
            dc = dcap
            for cand in (24, 48, 96):
                if mx <= cand < dcap:
                    dc = cand
                    break
            quads = np.ascontiguousarray(quads[:, :dc])
            arr = self._decode(packed, luma8, quads, counts, hw).cpu().numpy()
            valid = arr[..., 1] > 0.5
            fi, fj = np.nonzero(valid)
            if not fi.size:
                continue
            ids = arr[fi, fj, 0].astype(np.int64).tolist()
            cs = arr[fi, fj, 2:]
            cols = [cs[:, k].tolist() for k in range(8)]
            corners = [
                [(x0, y0), (x1, y1), (x2, y2), (x3, y3)]
                for x0, y0, x1, y1, x2, y2, x3, y3 in zip(*cols)
            ]
            for f, tid, cr in zip(fi.tolist(), ids, corners):
                results[f][tid] = cr
            # successfully decoded quads release their saddles
            # (src/detector.rs:517-536)
            alive[np.repeat(fi, 4), quads[fi, fj].reshape(-1)] = 0
            changed[np.unique(fi)] = True

    def _decode(self, packed, luma8, quads: np.ndarray, counts: np.ndarray, hw):
        """Decode the searched quads of a chunk on the device, one upload
        of quads | count (as aprilgrid_tpu/detector.py:555-559 packs them)
        and one ``decode_packed`` call; returns (B, dc, 10) f32 rows [id,
        valid, corners x8]."""
        c = self.consts
        qarr = torch.from_numpy(pack_qarr(quads, counts)).to(packed.device)
        return decode_packed(
            packed, luma8, qarr, hw, quads.shape[1],
            self.spec, c.decode_margin, c.valid_brightness_threshold,
            c.max_invalid_bit, c.min_contrast,
        )


def pack_qarr(quads: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The search's (B, dc, 4) quads and (B,) counts as one (B, dc*4 + 1)
    int32 array, quads | count, the decode's one upload."""
    return np.concatenate(
        [quads.reshape(len(counts), -1), counts[:, None]], axis=1
    ).astype(np.int32)


def _as_tensor(imgs) -> torch.Tensor:
    if isinstance(imgs, torch.Tensor):
        return imgs
    return torch.from_numpy(np.ascontiguousarray(imgs))


def _default_chunk(h: int, w: int) -> int:
    """Frames per chunk for an (h, w) frame: 32 at 1080p, scaled at a
    constant pixel budget and rounded down to a power of two in [16, 64]
    (the JAX package's choice; 4K gets 16, small frames 64). The turbo
    mode uses the same sizes."""
    px = h * w
    budget = max(16, min(64, (40 * 1920 * 1080) // max(px, 1)))
    return 1 << (budget.bit_length() - 1)


def _warn_counters(cnts: np.ndarray) -> None:
    """Surface front-end capacity counters (per-frame (B, 3):
    [candidate-buffer overflow, oversized-cluster drops, saddle slots
    full]) as warnings — a user must not have to read raw counters to
    learn the fixed-capacity pipeline may have diverged."""
    if (cnts[:, 0] > 0).any():
        warnings.warn(
            "cluster candidate buffer hit capacity on at least one frame; "
            "the saddle set may be truncated vs the reference (raise "
            "kernels.cluster._CAPF)",
            RuntimeWarning,
            stacklevel=3,
        )
    if (cnts[:, 1] > 0).any():
        warnings.warn(
            "oversized response clusters were dropped on at least one "
            "frame; detections near very large blobs may differ from the "
            "reference",
            RuntimeWarning,
            stacklevel=3,
        )
    if (cnts[:, 2] > 0).any():
        warnings.warn(
            "saddle capacity (max_saddles) filled on at least one frame; "
            "excess saddles were truncated — raise Capacities.max_saddles",
            RuntimeWarning,
            stacklevel=3,
        )
