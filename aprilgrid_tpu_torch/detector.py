"""TagDetector facade — the public detect API, exact hybrid mode.

Mirrors the reference facade (TagDetector, src/detector.rs:17-23,363-541):
the dense front-end and the tag decode run on the card through the port's
kernels; the board search runs on the host in native C++ (native/). A
batch is processed in chunks, each in order:

    front-end -> one device-to-host copy of the packed saddles
    -> board search -> decode -> release decoded saddles -> next pass

for ``max_num_of_boards`` passes (src/detector.rs:510-538).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import native
from .config import CONSTANTS, DEFAULT_CAPACITIES, Capacities, DetectorParams, PipelineConstants
from .families import FamilySpec, TagFamily, get_family
from .ops.decode import decode_quads_batch
from .pipeline import frontend_packed


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
    PyTorch versions. Only the exact hybrid mode exists so far:
    ``mode="xla"`` and ``decimate=True/"auto"`` raise NotImplementedError
    (ROADMAP.md lists the slices that bring them)."""

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
        if mode != "hybrid":
            raise NotImplementedError(
                f"mode={mode!r}: only the hybrid mode is ported; the "
                "on-device board search is queued in ROADMAP.md"
            )
        if decimate is not False:
            raise NotImplementedError(
                f"decimate={decimate!r}: the turbo mode is not ported yet "
                "(ROADMAP.md, turbo slice)"
            )
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

    # -- public API ---------------------------------------------------------

    def detect(self, img) -> dict[int, list[tuple[float, float]]]:
        """Detect tags in one image; returns {tag_id: 4 corners} with the
        reference's canonical corner ordering (src/detector.rs:505-540)."""
        return self._detect_hybrid(_as_tensor(img)[None])[0]

    def detect_batch(
        self, imgs, chunk: int | None = None
    ) -> list[dict[int, list[tuple[float, float]]]]:
        """Detect over a batch of same-shape frames (axis 0). ``chunk``
        sizes the sub-batches (default: ``_default_chunk``)."""
        return self._detect_hybrid(_as_tensor(imgs), chunk=chunk)

    # -- hybrid runtime -----------------------------------------------------

    def _detect_hybrid(self, imgs: torch.Tensor, chunk: int | None = None):
        b = int(imgs.shape[0])
        hw = (int(imgs.shape[1]), int(imgs.shape[2]))
        results: list[dict] = [{} for _ in range(b)]
        if self.params.max_num_of_boards == 0 or b == 0:
            return results  # no pass reads a front-end: dispatch none
        if chunk is None:
            chunk = _default_chunk(*hw)
        chunk = max(1, int(chunk))
        n_chunks = -(-b // chunk)
        for i in range(n_chunks):
            lo, hi = i * b // n_chunks, (i + 1) * b // n_chunks
            self._detect_chunk(imgs[lo:hi], hw, results[lo:hi])
        return results

    def _detect_chunk(self, frames: torch.Tensor, hw, results: list[dict]):
        packed, luma8 = frontend_packed(
            frames.to(self.device), self.params, self.consts, self.caps
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
        """Decode the searched quads of a chunk on the device; returns
        (B, dc, 10) f32 rows [id, valid, corners x8]."""
        dev = packed.device
        b, dc = quads.shape[:2]
        q = torch.from_numpy(quads).to(dev, torch.int64).clamp(min=0)
        qv = torch.arange(dc, device=dev)[None, :] < torch.from_numpy(
            counts
        ).to(dev)[:, None]
        pos = packed[..., 0:2]  # (B, N+1, 2)
        qp = torch.gather(
            pos, 1, q.reshape(b, dc * 4, 1).expand(b, dc * 4, 2)
        ).reshape(b, dc, 4, 2)
        d = decode_quads_batch(
            luma8, qp, qv, self.spec,
            self.consts.decode_margin,
            self.consts.valid_brightness_threshold,
            self.consts.max_invalid_bit,
            self.consts.min_contrast,
            true_shape=hw,
        )
        return torch.cat(
            [
                d.ids.to(torch.float32)[..., None],
                d.valid.to(torch.float32)[..., None],
                d.corners.reshape(b, dc, 8),
            ],
            dim=-1,
        )


def _as_tensor(imgs) -> torch.Tensor:
    if isinstance(imgs, torch.Tensor):
        return imgs
    return torch.from_numpy(np.ascontiguousarray(imgs))


def _default_chunk(h: int, w: int) -> int:
    """Frames per chunk for an (h, w) frame: 32 at 1080p, scaled at a
    constant pixel budget and rounded down to a power of two in [16, 64]
    (the JAX package's choice; 4K gets 16, small frames 64)."""
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
