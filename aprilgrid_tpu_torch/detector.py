"""TagDetector facade — the public detect API, hybrid and xla modes (each
exact and turbo).

Mirrors the reference facade (TagDetector, src/detector.rs:17-23,363-541).
In the hybrid mode (the default) the dense front-end and the tag decode
run on the card through the port's kernels; the board search runs on the
host in native C++ (native/). Each chunk of a batch goes

    front-end -> one device-to-host copy of the packed saddles
    -> board search -> decode -> release decoded saddles -> next pass

for ``max_num_of_boards`` passes (src/detector.rs:510-538), and the
chunks overlap as in the JAX package's hybrid runtime: front-ends two
chunks ahead, the search on a background worker, chunks and passes in
wavefront order, the final pass read once (``_detect_hybrid``). With
``decimate`` the front-end is the approximate turbo path
(pipeline.py::decimated_frontend_batch); frames beyond the fused kernels'
label domain (8K-class) take the plane path
(pipeline.py::planes_frontend_batch) with a warning; everything after the
front-end is the same. ``refined_saddle_points`` is the single-image
front-end (pipeline.py::saddle_frontend), always on the plane path.

In the xla mode the whole detect runs on the device
(pipeline.py::detect_pipeline_batch, ``detect``: detect_pipeline): the
same front-end, then the board search as tensor operations
(ops/search.py) and the decode, for every frame of the batch at once; the
host reads the fixed-capacity result once and unpacks it.
"""

from __future__ import annotations

import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import native
from .adapters import from_numpy
from .config import CONSTANTS, DEFAULT_CAPACITIES, Capacities, DetectorParams, PipelineConstants
from .families import FamilySpec, TagFamily, get_family
from .kernels.decode import decode_packed
from .pipeline import (
    DetectResult,
    _turbo_nms_env,
    detect_pipeline,
    detect_pipeline_batch,
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


def saddle_distance2(s0, s1) -> float:
    """Squared distance between two saddles (reference: saddle_distance2,
    src/saddle.rs:69-73, unused by the pipeline; provided for API
    parity)."""
    x = s0.p[0] - s1.p[0]
    y = s0.p[1] - s1.p[1]
    return x * x + y * y


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

    ``mode``: "hybrid" (the default; device front-end and decode, native
    C++ board search on the host) or "xla" (the whole detect on the
    device, the board search as tensor operations; it needs no host
    toolchain). Both give the same tags. Any other mode raises ValueError,
    as the JAX facade does."""

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
        # AG_TIMELINE=1: the host timeline of the last detect call
        self.last_timeline: list | None = None
        self._upload_streams: dict = {}
        if mode == "hybrid":
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
        reference's canonical corner ordering (src/detector.rs:505-540).
        In the xla mode the image goes through the single-image front-end
        (``pipeline.detect_pipeline``), as the JAX facade's does."""
        if self.mode == "hybrid":
            return self._detect_hybrid(_as_tensor(img)[None])[0]
        if self.params.max_num_of_boards == 0:
            return {}
        frame, _held = self._upload(_as_tensor(img))
        res = detect_pipeline(
            frame, self.spec, self.params, self.consts, self.caps,
            decimate=self._use_decimate(int(frame.shape[0]), int(frame.shape[1])),
        )
        res = DetectResult(*(_to_numpy(t) for t in res))
        _warn_flags(res.flags[None])
        return _unpack_result(res)

    def detect_batch(
        self, imgs, chunk: int | None = None
    ) -> list[dict[int, list[tuple[float, float]]]]:
        """Detect over a batch of same-shape frames (axis 0). ``chunk``
        sizes the hybrid runtime's sub-batches (default: the ``AG_CHUNK``
        environment variable if set, else ``_default_chunk``); the xla mode
        ignores it and runs the batch as one."""
        if self.mode == "hybrid":
            return self._detect_hybrid(_as_tensor(imgs), chunk=chunk)
        imgs = _as_tensor(imgs)
        if int(imgs.shape[0]) == 0 or self.params.max_num_of_boards == 0:
            return [{} for _ in range(int(imgs.shape[0]))]
        frames, _held = self._upload(imgs)
        return _unpack_batch(self._detect_xla(frames))

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

    def _upload(self, imgs: torch.Tensor):
        """(``imgs`` on the detector's device, the upload to hold until the
        detect has read its result): a host batch bound for the card goes
        through pinned staging on the upload stream (``_HostUpload``, which
        holds the pinned source), anything else through ``.to``."""
        if self.device.type == "cuda" and not imgs.is_cuda:
            up = _HostUpload(imgs, self.device, self._upload_stream(self.device))
            return up.tensor(), up
        return imgs.to(self.device), None

    def _detect_xla(self, frames: torch.Tensor) -> DetectResult:
        """The xla mode's detect of a batch on its device
        (``pipeline.detect_pipeline_batch``), read back as numpy arrays. The
        turbo extraction variant follows the environment's policy, as the
        JAX facade's xla mode leaves it."""
        h, w = int(frames.shape[1]), int(frames.shape[2])
        res = detect_pipeline_batch(
            frames, self.spec, self.params, self.consts, self.caps,
            decimate=self._use_decimate(h, w),
        )
        return DetectResult(*(_to_numpy(t) for t in res))

    def _upload_stream(self, device: torch.device):
        """The side stream that host batches bound for ``device`` are copied
        on (``_HostUpload``): one a card, made on first use and kept. The
        caching allocator keeps a block for the stream it was allocated on,
        so a stream made for every call took fresh memory segments on every
        call."""
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index not in self._upload_streams:
            self._upload_streams[index] = torch.cuda.Stream(torch.device("cuda", index))
        return self._upload_streams[index]

    # -- hybrid runtime -----------------------------------------------------

    def _detect_hybrid(self, imgs: torch.Tensor, chunk: int | None = None, put=None):
        """The hybrid runtime (the JAX package's ``detector.py::
        _detect_hybrid``): device front-end, native C++ board search on the
        packed saddles, device decode, as a software pipeline over chunks
        of the batch and board passes. Results equal a chunk-by-chunk,
        pass-by-pass walk for every chunk size and schedule.

        Front-ends are dispatched lazily, two chunks ahead of the search,
        each with its saddle download started at dispatch (a copy into
        pinned host memory and an event). The search runs on one
        background worker (``AG_SEARCH_ASYNC``: ``1`` on, ``0`` inline,
        default on when the host has more than one core) and sees numpy
        arrays only. Chunks and passes are walked in wavefront order: wave
        w runs (chunk w, pass 0), (chunk w-1, pass 1), ... so the device
        is fed first and the host's waits on front-ends fill with deeper
        passes of older chunks. The final pass's decodes start no copy of
        their own; they are read once, fused, at the end.

        ``put(frames, lo)``, where given, places a chunk's frames
        ``imgs[lo:hi]`` on the device its front-end runs on (default: the
        detector's device). ``parallel.sharding.detect_batch_sharded``
        passes one that puts each shard's chunk on its shard's device; the
        chunk's saddles, decodes and their uploads then stay there, since
        each follows its ``packed`` tensor.

        ``AG_TIMELINE=1`` records ``(label, t0, t1)`` on the host clock
        around every host-side blocking site, and around each chunk's
        staging (``fe_stage``), front-end enqueue (``fe_launch``) and
        result assembly (``assemble``), into ``last_timeline``. Every span
        is recorded on the calling thread; the only overlaps are
        ``fe_stage`` and ``fe_launch``, each inside its chunk's
        ``fe_dispatch``;
        ``AG_FILL_RAMP=1`` splits a first chunk of 8 or more frames in
        half, so the host's first read waits on half a front-end."""
        b = int(imgs.shape[0])
        hw = (int(imgs.shape[1]), int(imgs.shape[2]))
        tl: list | None = [] if os.environ.get("AG_TIMELINE") else None
        self.last_timeline = tl
        results: list[dict] = [{} for _ in range(b)]
        n_passes = self.params.max_num_of_boards
        if n_passes == 0 or b == 0:
            return results  # no pass reads a front-end: dispatch none
        if chunk is None:
            env = os.environ.get("AG_CHUNK")
            chunk = int(env) if env is not None else _default_chunk(*hw)
        chunk = max(1, int(chunk))
        cap = (2 * self.caps.grid_radius + 1) ** 2
        dcap = min(cap, 2 * self.caps.max_tags)
        n_chunks = -(-b // chunk)
        bounds = [(i * b // n_chunks, (i + 1) * b // n_chunks) for i in range(n_chunks)]
        if (os.environ.get("AG_FILL_RAMP", "0") not in ("0", "")
                and n_chunks >= 2 and bounds[0][1] - bounds[0][0] >= 8):
            mid = (bounds[0][0] + bounds[0][1]) // 2
            bounds = [(bounds[0][0], mid), (mid, bounds[0][1])] + bounds[1:]
            n_chunks += 1
        dec = self._use_decimate(*hw)
        nms = self._turbo_nms(*hw) if dec else None

        if tl is not None:
            def _ev(label, fn, *a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                tl.append((label, t0, time.perf_counter()))
                return out
        else:
            def _ev(label, fn, *a, **kw):
                return fn(*a, **kw)

        # per chunk: (packed, luma8) on the device, which its decodes read,
        # and its saddle download in flight; held to the end of the call
        fronts: list[tuple | None] = [None] * n_chunks
        state: list[dict | None] = [None] * n_chunks

        # a host batch bound for the card is staged in pinned memory and
        # copied on a side stream; each upload is held to the end of the call
        side = (self._upload_stream(self.device) if put is None and not imgs.is_cuda
                and self.device.type == "cuda" else None)
        uploads: list = []

        def front(ci, lo, hi):
            # a host batch is uploaded here, inside the label
            if put is not None:
                frames = _ev(f"fe_stage c{ci}", put, imgs[lo:hi], lo)
            elif side is not None:
                uploads.append(_ev(f"fe_stage c{ci}", _HostUpload,
                                   imgs[lo:hi], self.device, side))
                frames = uploads[-1].tensor()
            else:
                frames = _ev(f"fe_stage c{ci}", imgs[lo:hi].to, self.device)
            return _ev(f"fe_launch c{ci}", frontend_packed,
                       frames, self.params, self.consts, self.caps, dec, nms)

        def ensure_fe(ci):
            if 0 <= ci < n_chunks and fronts[ci] is None:
                packed, luma8 = _ev(f"fe_dispatch c{ci}", front, ci, *bounds[ci])
                fronts[ci] = (packed, luma8, _HostCopy(packed))

        def chunk_state(ci):
            if state[ci] is None:
                ensure_fe(ci)
                pk = _ev(f"pack_read c{ci}", fronts[ci][2].read)  # (b, N+1, 4)
                _warn_counters(pk[:, -1, :3])
                pk = pk[:, :-1]
                state[ci] = {
                    "px": np.ascontiguousarray(pk[..., 0]),
                    "py": np.ascontiguousarray(pk[..., 1]),
                    "theta": np.ascontiguousarray(pk[..., 2]),
                    "alive": (pk[..., 3] > 0.5).astype(np.uint8),
                    # did the LAST pass decode any tag (and so release
                    # saddles)? pass p > 0 skips the frames where not
                    "changed": np.ones(pk.shape[0], bool),
                }
            return state[ci]

        def submit_search(ci, p):
            st = chunk_state(ci)
            alive = st["alive"]
            if p > 0 and not st["changed"].all():
                # a frame whose previous pass decoded nothing released no
                # saddles: its search input and result are unchanged, so
                # zeroing its alive mask skips it (exact)
                alive = alive * st["changed"][:, None].astype(np.uint8)
            st["changed"] = np.zeros(alive.shape[0], bool)
            # the worker gets numpy arrays only; st["alive"] is written by
            # apply_dec on this thread, and only after this search's result
            fut = _ev(
                f"search_submit c{ci} p{p}", pool.submit, native.find_board_batch,
                st["px"], st["py"], st["theta"], alive,
                spacing_ratio=self.params.tag_spacing_ratio,
                max_seeds=self.consts.max_seeds,
                early_exit_score=self.consts.early_exit_score,
                cap=cap,
            )
            return {"fut": fut, "quads": None, "dec": None, "done": False,
                    "final": p == n_passes - 1}

        def dispatch_job(ci, job):
            # main thread only: resolve the search and launch its decode
            if job["done"]:
                return
            quads, counts = _ev(f"search_wait c{ci}", job["fut"].result)
            job["done"] = True
            if not counts.any():
                # nothing found in the chunk: no decode, no read
                job["quads"] = quads[:, :1]
                return
            # bucket the decode capacity to the chunk's largest count
            mx = int(counts.max())
            dc = dcap
            for cand in (24, 48, 96):
                if mx <= cand < dcap:
                    dc = cand
                    break
            quads = np.ascontiguousarray(quads[:, :dc])
            packed, luma8, _ = fronts[ci]
            out = _ev(f"dec_dispatch c{ci}", self._decode, packed, luma8, quads, counts, hw)
            job["quads"] = quads
            # the final pass's decodes are read once, fused, by collect_tail
            job["dec"] = out if job["final"] else _HostCopy(out)

        def poll_dispatch():
            # launch the decodes of searches that finished meanwhile
            for cj, job in pending.items():
                if not job["done"] and job["fut"].done():
                    dispatch_job(cj, job)

        def apply_dec(ci, job, arr):
            _ev(f"assemble c{ci}", assemble, ci, job, arr)

        def assemble(ci, job, arr):
            valid = arr[..., 1] > 0.5
            fi, fj = np.nonzero(valid)
            if not fi.size:
                return
            lo = bounds[ci][0]
            st = state[ci]
            ids = arr[fi, fj, 0].astype(np.int64).tolist()
            cs = arr[fi, fj, 2:]
            cols = [cs[:, k].tolist() for k in range(8)]
            corners = [
                [(x0, y0), (x1, y1), (x2, y2), (x3, y3)]
                for x0, y0, x1, y1, x2, y2, x3, y3 in zip(*cols)
            ]
            # fi is sorted (row-major): frame i owns [starts[i], starts[i+1])
            starts = np.searchsorted(fi, np.arange(arr.shape[0] + 1)).tolist()
            for i in range(arr.shape[0]):
                s0, s1 = starts[i], starts[i + 1]
                if s0 != s1:
                    results[lo + i].update(zip(ids[s0:s1], corners[s0:s1]))
            # successfully decoded quads release their saddles
            # (src/detector.rs:517-536)
            st["alive"][np.repeat(fi, 4), job["quads"][fi, fj].reshape(-1)] = 0
            st["changed"][np.unique(fi)] = True

        def collect(ci, job):
            dispatch_job(ci, job)  # waits on the search if it still runs
            if job["dec"] is not None:
                apply_dec(ci, job, _ev(f"dec_read c{ci}", job["dec"].read))

        def collect_tail(jobs):
            # the final pass feeds no further search: its decodes are
            # concatenated on their device and read once (once a device,
            # where the chunks lie on several)
            for ci, job in jobs:
                dispatch_job(ci, job)
            by_dev: dict = {}
            for ci, job in jobs:
                if job["dec"] is not None:
                    by_dev.setdefault(job["dec"].device, []).append((ci, job))
            for live in by_dev.values():
                if len(live) == 1:
                    ci, job = live[0]
                    apply_dec(ci, job, _ev(f"dec_read c{ci}", _to_numpy, job["dec"]))
                    continue
                flat = torch.cat([j["dec"].reshape(-1, j["dec"].shape[-1]) for _, j in live])
                big = _ev("dec_read tail-fused", _to_numpy, flat)
                off = 0
                for ci, job in live:
                    b_, d_, w_ = job["dec"].shape
                    apply_dec(ci, job, big[off:off + b_ * d_].reshape(b_, d_, w_))
                    off += b_ * d_

        pending: dict[int, dict] = {}  # ci -> its last submitted search
        async_env = os.environ.get("AG_SEARCH_ASYNC", "")
        if async_env == "1" or (async_env != "0" and (os.cpu_count() or 1) > 1):
            pool = ThreadPoolExecutor(max_workers=1)
        else:
            pool = _InlineExecutor()
        ensure_fe(0)
        ensure_fe(1)
        try:
            for wave in range(n_chunks + n_passes - 1):
                for p in range(n_passes):
                    # poll first, so decodes of finished searches dispatch
                    # on edge waves too
                    poll_dispatch()
                    ci = wave - p
                    if not 0 <= ci < n_chunks:
                        continue
                    if p > 0:
                        collect(ci, pending[ci])
                    pending[ci] = submit_search(ci, p)
                # front-end lookahead at the END of the wave, after the
                # wave's decodes entered the device queue, so a decode read
                # does not wait behind a whole front-end
                poll_dispatch()
                ensure_fe(wave + 2)
            collect_tail([(ci, pending[ci]) for ci in range(n_chunks)])
        finally:
            pool.shutdown(wait=True)
        return results

    def _decode(self, packed, luma8, quads: np.ndarray, counts: np.ndarray, hw):
        """Decode the searched quads of a chunk on the device, one upload
        of quads | count (as aprilgrid_tpu/detector.py:555-559 packs them)
        and one ``decode_packed`` call; returns (B, dc, 10) f32 rows [id,
        valid, corners x8]. On the card the upload goes from pinned
        memory, so it does not block the host: a pageable copy would wait
        for the device's queue to drain."""
        c = self.consts
        qarr = torch.from_numpy(pack_qarr(quads, counts))
        if packed.is_cuda:
            qarr = qarr.pin_memory().to(packed.device, non_blocking=True)
        return decode_packed(
            packed, luma8, qarr, hw, quads.shape[1],
            self.spec, c.decode_margin, c.valid_brightness_threshold,
            c.max_invalid_bit, c.min_contrast,
        )


class _InlineExecutor:
    """Executor-shaped shim that runs the callable at submit time on the
    calling thread (``AG_SEARCH_ASYNC=0``: the search without the
    background worker)."""

    class _Done:
        def __init__(self, value):
            self._value = value

        def result(self):
            return self._value

        def done(self):
            return True

    def submit(self, fn, *args, **kwargs):
        return self._Done(fn(*args, **kwargs))

    def shutdown(self, wait=True):
        pass


class _HostCopy:
    """A device-to-host copy of ``t`` started without blocking the host
    (the counterpart of the JAX package's ``_copy_to_host_async``): the
    device tensor, its pinned host destination and the event recorded
    after the copy, all held until ``read``, which finds the bytes already
    there. For a CPU tensor there is nothing to copy."""

    __slots__ = ("src", "host", "event")

    def __init__(self, t: torch.Tensor):
        self.src = t
        self.host, self.event = t, None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))

    def read(self) -> np.ndarray:
        """The copied array; waits on the copy's event first."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _HostUpload:
    """A host batch's upload to the card started without blocking the host
    (the counterpart of an asynchronous device put): the batch is
    materialised once, straight into a pinned staging buffer (a broadcast
    or strided numpy view included; a ``copy_``, which runs on PyTorch's
    intra-op threads), then copied on ``stream``, a side
    stream, with an event recorded after the copy. ``tensor`` hands the
    device tensor to the device's current stream.

    Stream hazards are silent (a missing wait gives wrong tags only under
    load), so the order is fixed here: the device tensor is allocated on the
    side stream; the consumer stream waits on the copy's event before any
    kernel reads it; ``record_stream(consumer)`` keeps the caching
    allocator from handing its memory back to the side stream while the
    consumer still reads it; the pinned source is held with this object
    until the copy has passed. No step waits for the card. uint16 goes
    through the int16 view (few CUDA kernels take uint16). A CUDA tensor
    is handed on as it is; for a CPU device the upload is
    ``torch.from_numpy`` and nothing else."""

    __slots__ = ("dev", "host", "event")

    def __init__(self, arr, device: torch.device, stream=None):
        self.host = self.event = None
        if device.type != "cuda" or (isinstance(arr, torch.Tensor) and arr.is_cuda):
            self.dev = _as_tensor(arr)
            return
        src = arr if isinstance(arr, torch.Tensor) else _numpy_view(np.asarray(arr))
        dtype = src.dtype
        store = torch.int16 if dtype == torch.uint16 else dtype
        self.host = torch.empty(src.shape, dtype=store, pin_memory=True)
        self.host.copy_(src.view(store))   # one pass, on the intra-op threads
        with torch.cuda.stream(stream):
            dev = torch.empty(src.shape, dtype=store, device=device)
            dev.copy_(self.host, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(stream)
        self.dev = dev.view(dtype)

    def tensor(self) -> torch.Tensor:
        """The device tensor, ordered after the copy on its device's current
        stream."""
        if self.event is not None:
            consumer = torch.cuda.current_stream(self.dev.device)
            consumer.wait_event(self.event)
            self.dev.record_stream(consumer)
        return self.dev


def _numpy_view(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a``'s memory, strides and all (a broadcast view
    keeps its zero strides): it is only read. Negative strides, which
    tensors do not take, are copied out first."""
    if any(st < 0 for st in a.strides):
        a = np.ascontiguousarray(a)
    return from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def pack_qarr(quads: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The search's (B, dc, 4) quads and (B,) counts as one (B, dc*4 + 1)
    int32 array, quads | count, the decode's one upload."""
    return np.concatenate(
        [quads.reshape(len(counts), -1), counts[:, None]], axis=1
    ).astype(np.int32)


def _as_tensor(imgs) -> torch.Tensor:
    if isinstance(imgs, torch.Tensor):
        return imgs
    return from_numpy(np.ascontiguousarray(imgs))


def _unpack_result(res: DetectResult) -> dict[int, list[tuple[float, float]]]:
    """One frame's fixed-capacity result (numpy) as {tag_id: 4 corners}."""
    out: dict[int, list[tuple[float, float]]] = {}
    for i in np.flatnonzero(res.valid):
        out[int(res.ids[i])] = [
            (float(res.corners[i, j, 0]), float(res.corners[i, j, 1]))
            for j in range(4)
        ]
    return out


def _unpack_batch(res: DetectResult) -> list[dict[int, list[tuple[float, float]]]]:
    """A batch's result (numpy, leading (B,) axis): the capacity warnings,
    then one dict per frame."""
    _warn_flags(res.flags)
    return [
        _unpack_result(DetectResult(res.ids[i], res.corners[i], res.valid[i], None))
        for i in range(res.ids.shape[0])
    ]


def _default_chunk(h: int, w: int) -> int:
    """Frames per chunk for an (h, w) frame: 32 at 1080p, scaled at a
    constant pixel budget and rounded down to a power of two in [16, 64]
    (the JAX package's choice; 4K gets 16, small frames 64). The turbo
    mode uses the same sizes: the JAX package's 3/2 turbo factor, a TPU
    measurement, was not faster on the H100 at batch 128 (PERF.md)."""
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


def _warn_flags(flags: np.ndarray) -> None:
    """Surface the xla mode's DetectResult flags ((B, 2): [saddle slots
    full, kNN-pool prunes]) as warnings. The prune counter is not warned
    on: small nonzero counts occur on normal scenes (degenerate candidate
    quads extrapolate unreachable targets, see
    ops/board.py::propose_expansions); it stays in the flags for audits."""
    if (flags[:, 0] > 0).any():
        warnings.warn(
            "saddle capacity (max_saddles) filled on at least one frame; "
            "excess saddles were truncated — raise Capacities.max_saddles",
            RuntimeWarning,
            stacklevel=3,
        )
