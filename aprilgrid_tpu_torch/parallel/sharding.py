"""Row sharding of one large frame's saddle front-end over several devices.

The port's counterpart of the JAX package's ``parallel/sharding.py``
row-sharded front-ends. There, each function is one program over a device
mesh (a halo exchange between neighbouring shards, a global minimum, a
gather, a sum). Here one process drives each shard's device in turn: the
halo exchange is a ``copy_`` between the shards' devices, the global
minimum a ``min`` over the shards in shard order, the gather a
``torch.cat`` in shard order and the sum a sum over the shards in shard
order. No ``torch.distributed`` is needed.

A mesh may name one device several times; its shards then run one after
another on that device (the tests use ``[torch.device("cpu")] * n``, a
card with one GPU ``[torch.device("cuda", 0)] * n``).

* ``frontend_rows_sharded``: blur and Hessian response, bit for bit the
  single device's;
* ``saddle_frontend_rows_sharded``: the whole front-end in plain PyTorch
  ops (blur, response, clustering, ROCHADE, gates), no kernel;
* ``saddle_frontend_rows_sharded_kernels`` (the counterpart of
  ``saddle_frontend_rows_sharded_pallas``): the exact path's kernels per
  shard, ``front_kernel`` and ``cluster_rochade_raw`` in their row-sharding
  mode;
* ``saddle_frontend_rows_sharded_kernels_turbo`` (the counterpart of
  ``saddle_frontend_rows_sharded_pallas_turbo``): the turbo path's kernels
  per shard, ``front_kernel_decimate`` and ``cluster_rochade_raw(luma_f32)``
  in their row-sharding mode, then the full-resolution re-refine by
  ``sparse_refine_raw``, each shard refining the candidates in its band.

The last two give the single device's saddles slot for slot
(``pipeline.saddle_frontend_batch``, and ``decimated_frontend_batch`` with
the drain extraction), with one bound by design: the claim context.

**The claim context.** A shard sees its band and 48 rows of context above
and below it (half rows in the turbo path) and claims the blobs whose root,
their topmost pixel, lies in its band. The JAX package takes 48 rows as
"the largest blob, fully visible", which rests on its cluster kernel's
blob-size cap: it drops a blob taller than its member-scan window in the
single-device run as well. The port's cluster kernel labels globally and
has no cap, so a blob taller than the context stays whole on one device
but can be cut at a window's edge when sharded: its piece inside the
window may have another root or another centroid. So the sharded
front-ends equal the single device on every frame whose response blobs
(below the threshold) are at most 48 rows tall (exact path) or at most 45
half rows tall (turbo path, whose window also ends in 4 half rows that
blur the window's own replicated edges). ``tests/test_torch_sharding.py``
shows both sides of the bound on a synthetic tall blob. A saddle blob of a
real board is a few rows tall (the golden scenes' tallest: 29 rows).
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..kernels.cluster import cluster_rochade_raw, saddles_from_candidates
from ..kernels.frontend import (
    front_kernel,
    front_kernel_decimate,
    padded_shape,
)
from ..kernels.refine import sparse_refine_raw
from ..ops.cluster import component_centroids_bounded, label_components
from ..ops.frontend import gaussian_blur, gaussian_kernel, hessian_response
from ..ops.rochade import Saddles, filter_and_compact, rochade_refine

CTX = 48        # claim context, rows (exact path) or half rows (turbo path)
HALO = CTX + 8  # exact path: raw rows exchanged, context + blur/pad rows
HALO_TURBO = 2 * CTX + 8   # turbo path: full-resolution rows exchanged


class Mesh:
    """A named grid of devices: ``devices`` an ndarray of ``torch.device``
    whose axes are ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device array needs as many axis names")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def along(self, axis: str) -> list[torch.device]:
        """The devices of ``axis``, in order (at the first index of every
        other axis: the sharded functions replicate over those)."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(arr.reshape(arr.shape[0], -1)[:, 0])


def make_mesh(axis_sizes: dict[str, int], devices=None) -> Mesh:
    """A named device mesh, e.g. ``make_mesh({"sp": 4})``. ``devices``
    defaults to every visible CUDA device; it may name a device more than
    once."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices (e.g. [torch.device('cpu')] * n)"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = math.prod(axis_sizes.values())
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(arr.reshape(tuple(axis_sizes.values())), tuple(axis_sizes.keys()))


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``, by a ``copy_`` into a tensor there."""
    if t.device == dev:
        return t
    if t.dtype == torch.uint16:   # through the int16 view, as the layout ops
        return _to(t.view(torch.int16), dev).view(torch.uint16)
    out = torch.empty(t.shape, dtype=t.dtype, device=dev)
    out.copy_(t)
    return out


def detect_batch_sharded(detector, imgs, mesh: Mesh, axis: str = "data"
                         ) -> list[dict[int, list[tuple[float, float]]]]:
    """Data-parallel ``detect_batch``: the frames split evenly over the
    devices of ``axis``, shard i's frames on ``mesh.along(axis)[i]``.
    Returns ``detector.detect_batch(imgs)``'s dicts, bit for bit, one per
    frame in batch order.

    The hybrid runtime runs one chunk per shard: a put hook
    (``TagDetector._detect_hybrid(put=...)``) places each chunk's frames on
    its shard's device, where its front-end runs; its saddle download, its
    decode's upload and the decode follow its ``packed`` tensor there. The
    board search runs on the host over every shard's saddles. Every
    frame's threshold, search and decode are the frame's own, so sharding
    changes the schedule only. One chunk a shard can move the decode's
    capacity step (24/48/96 quad slots, from a chunk's largest count)
    away from the single device's; the decoded rows stay the same.

    In the xla mode each shard's frames run the whole on-device detect
    (``pipeline.detect_pipeline_batch``) on the shard's device, one host
    thread a shard (the search reads its loop conditions on the host), and
    the results come back in batch order. A frame's result does not depend
    on the frames beside it, so they equal ``detect_batch``'s.

    ``B % n_shards != 0`` raises ``ValueError``."""
    from ..detector import DetectResult, _as_tensor, _unpack_batch

    imgs = _as_tensor(imgs)
    devs = mesh.along(axis)
    b = int(imgs.shape[0])
    if b % len(devs):
        raise ValueError(f"a batch of {b} frames does not split over {len(devs)} "
                         f"devices of axis {axis!r}")
    per = b // len(devs)

    def put(frames: torch.Tensor, lo: int) -> torch.Tensor:
        return _to(frames, devs[lo // per])

    if detector.mode == "hybrid":
        return detector._detect_hybrid(imgs, chunk=per, put=put)
    if b == 0 or detector.params.max_num_of_boards == 0:
        return [{} for _ in range(b)]
    with ThreadPoolExecutor(max_workers=len(devs)) as pool:
        parts = list(pool.map(
            lambda i: detector._detect_xla(put(imgs[i * per:(i + 1) * per], i * per)),
            range(len(devs))))
    return _unpack_batch(DetectResult(*(np.concatenate(f) for f in zip(*parts))))


def _halo_exchange_rows(bands: list[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """Each shard's band with ``halo`` rows of its neighbours above and
    below, on its own device; the global top and bottom edges replicate
    their own border rows (the clamped borders of the reference blur,
    src/image_util.rs:144-183)."""
    n = len(bands)
    out = []
    for i, x in enumerate(bands):
        top = (x[:1].expand(halo, *x.shape[1:]) if i == 0
               else _to(bands[i - 1][-halo:], x.device))
        bot = (x[-1:].expand(halo, *x.shape[1:]) if i == n - 1
               else _to(bands[i + 1][:halo], x.device))
        out.append(torch.cat([top, x, bot]))
    return out


def _bands(frame, devs: list[torch.device], min_rows: int, name: str):
    """(H, W) frame -> its n row bands, each on its shard's device."""
    frame = torch.as_tensor(frame)
    n = len(devs)
    h = frame.shape[0]
    if frame.ndim != 2 or h % n:
        raise ValueError(f"{name}: a (H, W) frame with H divisible by {n} shards "
                         f"(got {tuple(frame.shape)})")
    hs = h // n
    if hs < min_rows:
        raise ValueError(f"{name}: per-shard band ({hs} rows) must cover the halo "
                         f"({min_rows}); use fewer shards")
    return [_to(frame[i * hs : (i + 1) * hs], d) for i, d in enumerate(devs)], hs


def _global_min(values: list[torch.Tensor], devs: list[torch.device]) -> list[torch.Tensor]:
    """The minimum of every shard's values, as a min over the shards in
    shard order on the first device, copied back to each shard's device."""
    m = torch.stack([_to(v.amin(), devs[0]) for v in values]).amin()
    return [_to(m, d) for d in devs]


def _gated(s: Saddles, params, consts, caps) -> Saddles:
    return filter_and_compact(s, caps.max_saddles, consts.saddle_k_ratio,
                              params.min_saddle_angle, params.max_saddle_angle)


def _unbatch(s: Saddles) -> Saddles:
    return Saddles(*(t[0] for t in s))


def frontend_rows_sharded(mesh: Mesh, sigma: float = 1.5, axis: str = "sp"):
    """Row-sharded blur + Hessian response. Returns ``luma (H, W) f32 ->
    (blur, resp)`` on the first shard's device, H divisible by the shard
    count; bit for bit ``gaussian_blur`` and ``hessian_response`` of the
    whole plane: the halo supplies the cross-shard stencil rows and the
    global borders stay clamp-replicated."""
    devs = mesh.along(axis)
    radius = (len(gaussian_kernel(sigma)) - 1) // 2
    halo = radius + 1   # the blur needs `radius` rows, the Hessian one more

    def run(luma):
        bands, hs = _bands(luma, devs, halo, "frontend_rows_sharded")
        n = len(devs)
        blurs, resps = [], []
        for i, ext in enumerate(_halo_exchange_rows(bands, halo)):
            blur = gaussian_blur(ext, sigma)
            resp = hessian_response(blur[halo - 1 : halo + hs + 1])[1:-1]
            # the reference leaves the image's top and bottom rows 0
            if i == 0:
                resp[0] = 0.0
            if i == n - 1:
                resp[-1] = 0.0
            blurs.append(_to(blur[halo : halo + hs], devs[0]))
            resps.append(_to(resp, devs[0]))
        return torch.cat(blurs), torch.cat(resps)

    return run


def saddle_frontend_rows_sharded(mesh: Mesh, params, consts, caps, axis: str = "sp",
                                 blob_halo: int = 64):
    """Row-sharded full saddle front-end in plain PyTorch ops (blur,
    response, clustering, ROCHADE, gates; no kernel). Each shard takes its
    band and ``blob_halo`` rows on each side, claims the blobs whose root
    lies in its band and refines them; the candidates are gathered in shard
    order (= scan order) and gated together, so k >= max_k/10 sees the
    global maximum (src/detector.rs:436-444). Returns ``luma (H, W) f32 ->
    Saddles`` on the first shard's device, the single device's
    ``pipeline._frontend_tail`` slot for slot while every blob is at most
    ``blob_halo`` rows tall. H divisible by the shard count, bands of at
    least ``blob_halo`` + 4 rows."""
    devs = mesh.along(axis)
    radius = (len(gaussian_kernel(consts.blur_sigma)) - 1) // 2
    hl = blob_halo + radius + 1   # luma halo: blob window + blur + Hessian

    def run(luma):
        bands, hs = _bands(luma, devs, hl, "saddle_frontend_rows_sharded")
        h, w = hs * len(devs), bands[0].shape[1]
        win = []
        for i, ext in enumerate(_halo_exchange_rows(bands, hl)):
            # window row L is global row r0 - blob_halo + L
            blur = gaussian_blur(ext, consts.blur_sigma)[radius : -radius]
            resp = hessian_response(blur)[1:-1]
            blur = blur[1:-1]
            g = i * hs - blob_halo + torch.arange(resp.shape[0], device=resp.device)[:, None]
            c = torch.arange(w, device=resp.device)[None, :]
            live = (g > 0) & (g < h - 1) & (c > 0) & (c < w - 1)
            win.append((blur, torch.where(live, resp, torch.zeros_like(resp))))
        # threshold = ratio * the global response minimum (src/detector.rs:414-418)
        thr = _global_min([r[blob_halo : blob_halo + hs] for _, r in win], devs)
        parts = []
        for i, (blur, resp) in enumerate(win):
            mask = (resp < thr[i] * consts.response_threshold_ratio)[None]
            lab = label_components(mask, caps.label_prop_rounds)
            cents = component_centroids_bounded(mask, lab, caps.max_clusters,
                                                caps.max_masked, (blob_halo, blob_halo + hs))
            s = rochade_refine(blur, cents.centers[0], cents.valid[0],
                               consts.rochade_half_patch, consts.rochade_move_threshold,
                               global_bounds=(h, i * hs - blob_halo))
            parts.append(Saddles(*(_to(t, devs[0]) for t in s)))
        gathered = Saddles(*(torch.cat(t)[None] for t in zip(*parts)))
        return _unbatch(_gated(gathered, params, consts, caps))

    return run


def _pad_columns(band: torch.Tensor, wp: int) -> torch.Tensor:
    """A band's columns edge-padded to ``wp`` (the pad_raw layout)."""
    if band.shape[1] == wp:
        return band
    return torch.cat([band, band[:, -1:].expand(band.shape[0], wp - band.shape[1])], 1)


def _window(ext: torch.Tensor, local_h: int) -> torch.Tensor:
    """A shard's rows -> (1, Hp+16, Wp) in the pad_raw layout of a
    ``local_h``-row window: rows past the exchanged ones edge-filled (they
    reach only responses the gates and the claims leave out)."""
    need = padded_shape(local_h, 1)[0] + 16
    if ext.shape[0] < need:
        ext = torch.cat([ext, ext[-1:].expand(need - ext.shape[0], ext.shape[1])])
    return ext[:need][None].contiguous()


def _claims(fields: torch.Tensor, w: int, hs: int, row0: int) -> torch.Tensor:
    """A window's candidate rows (capf, 8) with the claim applied: a row
    stays valid when its root row (from its label) lies in the window's
    band, rows [CTX, CTX + hs) of the window (the window starts at frame row
    ``row0``), and its label becomes the frame's scan-order index."""
    lab = fields[:, 7].to(torch.int64) - 1
    root_row = torch.div(lab, w, rounding_mode="floor")
    keep = (fields[:, 6] > 0.5) & (root_row >= CTX) & (root_row < CTX + hs)
    glab = (lab + row0 * w).to(torch.float32)
    zero = torch.zeros_like(glab)
    return torch.cat([fields[:, :6], torch.where(keep, zero + 1.0, zero)[:, None],
                      torch.where(keep, glab + 1.0, zero)[:, None]], 1)


def _check_raw_frame(frame, name: str) -> None:
    dtype = frame.dtype if isinstance(frame, torch.Tensor) else torch.as_tensor(frame).dtype
    if dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"{name}: one channel, u8 or u16 (got {dtype})")


def _shard_windows(bands: list[torch.Tensor], hs: int, turbo: bool):
    """Each shard's kernel input: (window (1, Hp+16, Wp) in the pad_raw
    layout — for the turbo path the decimate input, whose edge shards
    alternate the frame's edge rows —, row offset (1,) int32 — half rows
    for the turbo path —, the exchanged rows, which the turbo re-refine
    reads); and the window's true rows."""
    n = len(bands)
    # rows are laid out through the int16 view of u16 frames: not every
    # uint16 operation runs on the card
    kind = bands[0].dtype
    bands = [b.view(torch.int16) if kind == torch.uint16 else b for b in bands]
    wp = padded_shape(1, bands[0].shape[1])[1]
    padded = [_pad_columns(b, wp) for b in bands]
    halo = HALO_TURBO if turbo else HALO
    local_h = hs + (4 if turbo else 2) * CTX
    out = []
    for i, ext in enumerate(_halo_exchange_rows(padded, halo)):
        ext = _window(ext, local_h)[0]
        win, ro = ext, i * hs - CTX
        if turbo:
            win = _alternate_edge_rows(ext, padded[i], halo, i == 0, i == n - 1)
            ro = i * hs // 2 - CTX
        roff = torch.full((1,), ro, dtype=torch.int32, device=ext.device)
        out.append((win[None].contiguous().view(kind), roff, ext.view(kind)))
    return out, local_h


def row_windows(frame, n: int, turbo: bool = False, device=None):
    """The windows the row-sharded kernel front-ends give their kernels
    for an (H, W) u8/u16 frame cut into ``n`` bands, as one batch on
    ``device`` (default: the frame's): (windows (n, Hp+16, Wp), row
    offsets (n,) int32, the windows' true rows, the frame's rows); for the
    turbo path the windows are the decimate inputs and the offsets and the
    frame's rows count half rows."""
    frame = torch.as_tensor(frame)
    dev = frame.device if device is None else torch.device(device)
    bands, hs = _bands(frame, [dev] * n, HALO_TURBO if turbo else HALO, "row_windows")
    wins, local_h = _shard_windows(bands, hs, turbo)
    h = hs * n // 2 if turbo else hs * n
    return (torch.cat([w for w, _, _ in wins]), torch.cat([r for _, r, _ in wins]),
            local_h, h)


def saddle_frontend_rows_sharded_kernels(mesh: Mesh, params, consts, caps,
                                         axis: str = "sp"):
    """Row-sharded exact saddle front-end on the port's kernels (the
    counterpart of ``saddle_frontend_rows_sharded_pallas``).

    Each shard gets its raw band plus a 56-row halo, lays out a window of
    its band and 48 rows of claim context on each side in the pad_raw
    layout and runs ``front_kernel`` and ``cluster_rochade_raw`` in their
    row-sharding mode (global border and bounds gates, y in frame rows).
    The threshold is the ratio times the minimum of every shard's tile
    minima; a shard keeps the candidates whose root lies in its band, with
    their labels made the frame's scan-order index, and the candidates are
    gathered in shard order, sorted by label and gated together. Returns
    ``raw (H, W) u8/u16 -> Saddles`` on the first shard's device:
    ``pipeline.saddle_frontend_batch``'s saddles slot for slot within the
    claim context (module head). H divisible by the shard count, bands of
    at least 56 rows, H*W < 2^24 (f32-exact labels)."""
    devs = mesh.along(axis)
    name = "saddle_frontend_rows_sharded_kernels"
    kw = dict(sigma=consts.blur_sigma, hp2=2 * consts.rochade_half_patch,
              move_thr=consts.rochade_move_threshold)

    def run(raw):
        _check_raw_frame(raw, name)
        bands, hs = _bands(raw, devs, HALO, name)
        h, wt = hs * len(devs), bands[0].shape[1]
        if h * wt >= 2**24:
            raise ValueError(f"{name}: {h}x{wt} scan-order labels exceed f32's exact range")
        u16 = bands[0].dtype == torch.uint16
        wins, local_h = _shard_windows(bands, hs, turbo=False)
        tmins = [front_kernel(raw_loc, consts.blur_sigma, (local_h, wt), 1, u16,
                              row_off=roff, global_h=h)[1]
                 for raw_loc, roff, _ in wins]
        thr = _global_min(tmins, devs)
        parts = []
        for i, (raw_loc, roff, _) in enumerate(wins):
            t = (thr[i] * consts.response_threshold_ratio).reshape(1)
            fields, _ = cluster_rochade_raw(raw_loc, t, local_h, wt, 1, u16, row_off=roff,
                                            global_h=h, **kw)
            parts.append(_to(_claims(fields[0], wt, hs, i * hs - CTX), devs[0]))
        saddles = saddles_from_candidates(torch.cat(parts)[None])
        return _unbatch(_gated(saddles, params, consts, caps))

    return run


def _alternate_edge_rows(ext: torch.Tensor, band: torch.Tensor, halo: int,
                         first: bool, last: bool) -> torch.Tensor:
    """The decimate input of an edge shard: the exchanged rows beyond the
    frame's top (bottom) edge are the frame's two edge rows in turn, so
    every 2x2 mean there is the edge half row — the single device's half
    plane replicates its own edge half row, which the clamp-replicated
    full rows would not give."""
    hs = band.shape[0]
    top, bot = ext[:halo], ext[halo + hs :]
    if first:
        k = halo - torch.arange(halo, device=band.device)   # row -k of the frame
        top = torch.where((k % 2 == 1)[:, None], band[1:2], band[0:1])
    if last:
        j = torch.arange(bot.shape[0], device=band.device)
        bot = torch.where((j % 2 == 1)[:, None], band[hs - 1 : hs], band[hs - 2 : hs - 1])
    return torch.cat([top, band, bot])


def saddle_frontend_rows_sharded_kernels_turbo(mesh: Mesh, params, consts, caps,
                                               axis: str = "sp"):
    """Row-sharded turbo saddle front-end on the port's kernels (the
    counterpart of ``saddle_frontend_rows_sharded_pallas_turbo``):
    half-resolution detection per shard, then the full-resolution re-refine
    sharded by ownership.

    Each shard gets its raw band plus a 104-row halo (48 half rows of claim
    context and 8 rows of support), decimates a window of it with
    ``front_kernel_decimate`` and clusters the half plane with
    ``cluster_rochade_raw(luma_f32=True)``, both in their row-sharding mode
    in half rows. The threshold, the claims and the gather are the exact
    path's, at half resolution; the gathered half-resolution saddles are
    gated together. Each shard then re-refines the survivors whose
    full-resolution centre lies in its band with ``sparse_refine_raw``, in
    the frame's coordinates (so that every rounding is the single device's:
    the shard's rows lie at their own rows of an uninitialised frame-height
    buffer, of which the kernel reads only rows next to the shard's
    centres); each slot has one owner, so the sum over the shards in shard
    order is exact (taken here as the owner's value, which also keeps a
    -0.0). The refined set is gated again.

    Returns ``raw (H, W) u8/u16 -> Saddles`` on the first shard's device:
    ``pipeline.decimated_frontend_batch(..., nms=False)``'s saddles slot
    for slot within the claim context (module head). The JAX function's
    cluster call adds its blob pre-filter and 160-row window, which the
    port's turbo path has neither of (``kernels/cluster.py``). H divisible
    by the shard count into bands of at least 104 rows, a multiple of 8;
    (H/2)*(W/2) < 2^24."""
    devs = mesh.along(axis)
    name = "saddle_frontend_rows_sharded_kernels_turbo"
    kw = dict(sigma=consts.blur_sigma, hp2=2 * consts.rochade_half_patch,
              move_thr=consts.rochade_move_threshold)

    def run(raw):
        _check_raw_frame(raw, name)
        bands, hs = _bands(raw, devs, HALO_TURBO, name)
        if hs % 8:
            raise ValueError(f"{name}: per-shard bands must be 8-row multiples (got {hs})")
        n = len(devs)
        h, wt = hs * n, bands[0].shape[1]
        hh, wh = h // 2, wt // 2
        if hh * wh >= 2**24:
            raise ValueError(f"{name}: {hh}x{wh} half-resolution labels exceed f32's exact range")
        u16 = bands[0].dtype == torch.uint16
        wp = padded_shape(1, wt)[1]
        shards, local_h = _shard_windows(bands, hs, turbo=True)
        wins, tmins = [], []
        for half_in, roff, ext in shards:
            _, half_p, tmin = front_kernel_decimate(half_in, consts.blur_sigma, (local_h, wt),
                                                    1, u16, row_off=roff, global_h=hh)
            wins.append((ext, half_p, roff))
            tmins.append(tmin)
        thr = _global_min(tmins, devs)
        parts = []
        for i, (_, half_p, roff) in enumerate(wins):
            t = (thr[i] * consts.response_threshold_ratio).reshape(1)
            fields, _ = cluster_rochade_raw(half_p, t, local_h // 2, wh, 1, False,
                                            luma_f32=True, row_off=roff, global_h=hh, **kw)
            parts.append(_to(_claims(fields[0], wh, hs // 2, i * hs // 2 - CTX), devs[0]))
        half_s = _gated(saddles_from_candidates(torch.cat(parts)[None]), params, consts, caps)

        # the full-resolution re-refine, by band ownership
        pf = half_s.p[0] * 2.0 + 0.5   # half pixel (x, y) sits at (2x + 0.5, 2y + 0.5)
        h_pad = padded_shape(h, 1)[0]
        acc = [torch.zeros_like(pf)] + [torch.zeros_like(pf[:, 0]) for _ in range(4)]
        for i, (ext, _, _) in enumerate(wins):
            dev = devs[i]
            r0 = i * hs
            owned = _to(half_s.valid[0] & (pf[:, 1] >= r0) & (pf[:, 1] < r0 + hs), dev)
            frame = torch.empty((h_pad + 16, wp), dtype=ext.dtype, device=dev)
            lo, hi = max(r0 - HALO_TURBO, 0), min(r0 + hs + HALO_TURBO, h)
            rows = ext[lo - (r0 - HALO_TURBO) : hi - (r0 - HALO_TURBO)]
            if u16:
                frame.view(torch.int16)[8 + lo : 8 + hi] = rows.view(torch.int16)
            else:
                frame[8 + lo : 8 + hi] = rows
            ref = sparse_refine_raw(frame[None], _to(pf, dev)[None], owned[None], h, wt,
                                    1, u16, **kw)
            vf = _to(ref.valid[0] & owned, devs[0])
            vals = [ref.p[0], ref.k[0], ref.theta[0], ref.phi[0], vf.to(torch.float32)]
            acc = [torch.where(vf[:, None] if a.ndim == 2 else vf, _to(v, devs[0]), a)
                   for a, v in zip(acc, vals)]
        refined = Saddles(p=acc[0][None], k=acc[1][None], theta=acc[2][None],
                          phi=acc[3][None], valid=(acc[4] > 0.5)[None])
        return _unbatch(_gated(refined, params, consts, caps))

    return run
