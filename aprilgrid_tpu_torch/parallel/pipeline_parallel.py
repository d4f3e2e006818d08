"""Pipeline parallelism for the hybrid detector: the front-end on one
device, the decode on another.

The two device stages of the hybrid runtime run on different devices and
micro-batches stream through them:

    devices[0]: front-end(k+2)   (the front-end kernels)
    host:       board search(k+1) (native C++ on the saddle arrays)
    devices[1]: decode(k)         (``decode_packed``)

Micro-batch k's packed saddles and u8 luma plane move from ``devices[0]``
to ``devices[1]`` by a ``copy_`` between the devices (peer-to-peer over
NVLink or PCIe where the cards have it) while ``devices[0]`` already runs
micro-batch k+1's front-end. Data parallelism
(``parallel.sharding.detect_batch_sharded``) moves nothing between devices
and is the default; a pipeline helps where one device's memory cannot hold
both stages' buffers. The reference has no counterpart.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .. import native
from ..detector import _HostCopy, _HostUpload, _warn_counters
from ..pipeline import frontend_packed
from .sharding import _to


class PipelineParallelDetector:
    """Two-stage (front-end device, decode device) pipelined detector.

    ``detector``: a hybrid-mode ``TagDetector`` (``ValueError``
    otherwise); its front-end and decode are reused unchanged, each placed
    on the device its inputs lie on. ``devices``: ``(front, decode)``;
    default the visible CUDA devices (there is no CPU default: pass
    ``[torch.device("cpu")] * 2`` for the plain versions). One device is
    used for both stages. ``depth``: micro-batches whose front-end runs
    ahead of the search."""

    def __init__(self, detector, devices=None, depth: int = 2):
        if detector.mode != "hybrid":
            raise ValueError("pipeline parallelism drives the hybrid mode")
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("PipelineParallelDetector: no CUDA device; pass "
                                   "devices (e.g. [torch.device('cpu')] * 2)")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devs = [torch.device(d) for d in devices]
        if len(devs) < 2:
            devs = devs * 2
        self.det = detector
        self.dev_front, self.dev_decode = devs[0], devs[1]
        self.depth = max(1, int(depth))

    def detect_batches(self, batches):
        """Stream an iterable of (B, H, W[, C]) frame micro-batches; yields
        one ``list[{tag_id: corners}]`` per micro-batch, in order, equal to
        ``detector.detect_batch`` on it. Stage placement as in the module
        docstring."""
        det = self.det
        it = iter(batches)
        fronts: deque = deque()
        decodes: deque = deque()
        side = det._upload_stream(self.dev_front) if self.dev_front.type == "cuda" else None

        def start_front() -> bool:
            try:
                arr = next(it)
            except StopIteration:
                return False
            up = _HostUpload(arr, self.dev_front, side)
            imgs = _to(up.tensor(), self.dev_front)
            h, w = int(imgs.shape[1]), int(imgs.shape[2])
            dec = det._use_decimate(h, w)
            pk, luma8 = frontend_packed(imgs, det.params, det.consts, det.caps, dec,
                                        det._turbo_nms(h, w) if dec else None)
            # the saddle download starts now; the copies to the decode
            # device ride under the next micro-batch's front-end
            fronts.append((up, (_HostCopy(pk), _to(pk, self.dev_decode),
                                _to(luma8, self.dev_decode), (h, w))))
            return True

        def start_decode() -> bool:
            if not fronts:
                return False
            _, stage = fronts.popleft()  # the upload is held until here
            decodes.append(_search_passes(det, *stage))
            return True

        for _ in range(self.depth):
            start_front()
        while fronts or decodes:
            # keep the front device fed before draining the later stages
            start_decode()
            start_front()
            if decodes:
                yield _collect(*decodes.popleft())


def _search_passes(det, pk_copy: _HostCopy, pk_b, l8_b, hw):
    """A micro-batch's board passes on the host and their decodes on the
    decode device; returns (frames, [decoded rows of each pass])."""
    cap = (2 * det.caps.grid_radius + 1) ** 2
    dcap = min(cap, 2 * det.caps.max_tags)
    pkh = pk_copy.read()
    _warn_counters(pkh[:, -1, :3])
    pk = pkh[:, :-1]  # the counter row stripped
    px = np.ascontiguousarray(pk[..., 0])
    py = np.ascontiguousarray(pk[..., 1])
    theta = np.ascontiguousarray(pk[..., 2])
    alive = (pk[..., 3] > 0.5).astype(np.uint8)
    b = pk.shape[0]

    out = []
    changed = np.ones(b, bool)
    for p in range(det.params.max_num_of_boards):
        srch_alive = alive if p == 0 else alive * changed[:, None].astype(np.uint8)
        quads, counts = native.find_board_batch(
            px, py, theta, srch_alive,
            spacing_ratio=det.params.tag_spacing_ratio,
            max_seeds=det.consts.max_seeds,
            early_exit_score=det.consts.early_exit_score,
            cap=cap,
        )
        quads = np.ascontiguousarray(quads[:, :dcap])
        arr = _HostCopy(det._decode(pk_b, l8_b, quads, counts, hw)).read()
        fi, fj = np.nonzero(arr[..., 1] > 0.5)
        alive[np.repeat(fi, 4), quads[fi, fj].reshape(-1)] = 0
        changed = np.zeros(b, bool)
        changed[np.unique(fi)] = True
        out.append(arr)
    return b, out


def _collect(b: int, passes) -> list[dict]:
    results: list[dict] = [{} for _ in range(b)]
    for arr in passes:
        fi, fj = np.nonzero(arr[..., 1] > 0.5)
        ids = arr[fi, fj, 0].astype(np.int64).tolist()
        corners = arr[fi, fj, 2:].reshape(-1, 4, 2).tolist()
        for i, tag_id, cs in zip(fi.tolist(), ids, corners):
            results[i][tag_id] = [tuple(c) for c in cs]
    return results
