"""Streaming ingest and multi-camera detection.

A calibration rig streams N synchronised cameras; each camera's frames
batch along time. ``detect_stream`` overlaps the upload of the next frame
batches with the detect of the current one; ``MultiCameraDetector`` runs
the cameras' frames as one batch, and with a mesh whose ``camera`` axis
holds one device a camera, keeps each camera's frames on its device
(``parallel.sharding.detect_batch_sharded``). The reference has no
counterpart (single-threaded, one image at a time).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..detector import TagDetector, _HostUpload
from .sharding import Mesh, detect_batch_sharded


class MultiCameraDetector:
    """Batched detection over synchronised cameras.

    ``detector``: the :class:`TagDetector` (its family, params and
    capacities apply to every camera). ``mesh``: optional, with a
    ``camera`` axis (``ValueError`` otherwise); each camera's frames then
    run on its device of that axis. Without a mesh every camera runs on the
    detector's device."""

    def __init__(self, detector: TagDetector, mesh: Mesh | None = None):
        if mesh is not None and "camera" not in mesh.axis_names:
            raise ValueError("mesh must define a 'camera' axis")
        self.detector = detector
        self.mesh = mesh

    def detect(self, frames) -> list[list[dict]]:
        """``frames``: (num_cameras, time, H, W[, C]) synchronised streams, a
        numpy array or a tensor. Returns per-camera lists of
        {tag_id: corners}."""
        if not isinstance(frames, torch.Tensor):
            frames = np.asarray(frames)
        n_cam, n_t = int(frames.shape[0]), int(frames.shape[1])
        flat = frames.reshape((n_cam * n_t,) + tuple(frames.shape[2:]))
        if self.mesh is not None:
            results = detect_batch_sharded(self.detector, flat, self.mesh, axis="camera")
        else:
            results = self.detector.detect_batch(flat)
        return [results[c * n_t:(c + 1) * n_t] for c in range(n_cam)]


def detect_stream(detector: TagDetector, batches, prefetch: int = 2):
    """Pipelined detect over an iterable of frame batches; yields one
    ``list[{tag_id: corners}]`` per batch, in order.

    Up to ``prefetch`` batches are in flight ahead of the one being
    detected: each is staged in pinned host memory and copied to the card
    on the detector's side stream (``detector._HostUpload``,
    ``TagDetector._upload_stream``), so its transfer overlaps
    the detect of the batches before it. The next upload starts before the
    host blocks on the current detect. Enqueuing an upload makes no
    synchronising CUDA call: the detect's stream waits on the copy's event
    on the card, not the host. The staging memcpy runs on the caller's
    thread.

    ``batches``: (B, H, W[, C]) u8/u16/f32 batches (numpy arrays, views
    included, or tensors); B may differ between batches. On a CPU detector
    a batch is wrapped with ``torch.from_numpy`` and nothing is staged."""
    it = iter(batches)
    queue: deque = deque()
    side = detector._upload_stream(detector.device) if detector.device.type == "cuda" else None

    def enqueue() -> bool:
        try:
            arr = next(it)
        except StopIteration:
            return False
        queue.append(_HostUpload(arr, detector.device, side))
        return True

    for _ in range(max(1, prefetch)):
        if not enqueue():
            break
    while queue:
        up = queue.popleft()
        enqueue()  # keep the pipeline full before blocking on the detect
        yield detector.detect_batch(up.tensor())
