#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths — ``TagDetector(device="cuda").detect_batch``, the
exact hybrid detector, its turbo mode (``decimate=True``, both extraction
variants) and the plane path (frames beyond the fused kernels' label
domain, ``refined_saddle_points``), the xla mode (``mode="xla"``, the whole
detect with the board search on the card), the entry points that feed it
(``detect_stream``, ``to_detector_input``, ``detect_batch_sharded``,
``MultiCameraDetector``, ``PipelineParallelDetector``) and the surfaces
around it (``viz``, ``live``, the chart generator of ``boards``, the
profiling utilities, the runnable ``examples`` and the 4K rig of the
bench) — on the bundled
golden images at full resolution, after building every kernel from
``aprilgrid_tpu_torch/csrc`` and holding each against its plain PyTorch
version on the card.

Phases (a failing phase raises, so the script exits non-zero):

1. card and build: the card's name and power limit, the native search and
   the CUDA library built from source, build seconds;
2. kernels vs plain versions on CUDA tensors at main-path shapes
   (every golden image at batch 32, the end-to-end chunk: EuRoC u8 gray,
   TUM_VI u16 gray, iphone and two_boards RGB; the standalone hamming
   scan at 32 frames x 96 quads x 4 rotations; the decode of a pass,
   ``decode_packed``, bit for bit on every pass the facade decodes on the
   four images at batch 32 and on synthetic slot sets of three families:
   padding, count 0 and count = dcap, corners outside the frame and NaN,
   a code planted under each rotation, dcap 24 and 192) with their times; the turbo path's
   kernels (decimating front kernel, the cluster kernel's f32-luma mode,
   NMS extraction, sparse refine) on iphone and two_boards at batch 32
   and on EuRoC and TUM_VI at batch 8, the NMS tie-break on a plane
   with planted equal responses, the NMS kernel on synthetic planes (a
   fit at every pixel, none, blobs across tile corners and the margin, two
   shapes that are no multiple of its tile, one ending 2 pixels past its
   last tile and strip; at m0 and m8, on the plane and on a copy one
   element off alignment) and the refine kernel on slot
   sets no frame produces (every slot valid, none, valid slots that are
   no prefix, centres on the rounding's ties, negative and outside the
   image) on u8, u16 and RGB frames; the front kernel in both modes and
   the decimating front kernel on synthetic u8, u16 and RGB noise with
   saturated values, of shapes that are no tile multiple, at batch 1 and 3
   (the decimating one also on a raw array one element off alignment);
   the plane path's kernels
   (``fused_frontend`` cropped and padded, ``gray_kernel``, the front
   kernel's ``emit_blur`` mode, the blur-fed ``cluster_rochade``) on every
   image at batch 32; both cluster entries on synthetic masks no
   photograph produces (spiral, comb, checkerboard of single pixels, one
   blob over the whole interior, empty, more accepted roots than rows,
   noise), a different mask in each frame of one batch; then the device
   time of each launch of the three cluster entries, of
   ``nms_extract_raw`` and of ``sparse_refine_raw`` on two_boards
   (torch.profiler) with what ptxas reported for their kernels, and for
   the last two the PyTorch operations their wrappers enqueue and the
   spread of the whole call's time; the decode of each pass on two_boards
   (``phase_decode_split``: host ms, one upload, one kernel and one
   download asserted, the device's idle gap before the kernel) with
   probes of ``decode_packed`` and ``hamming_scan``;
3. end to end: ``detect_batch`` at batch 32 on EuRoC, TUM_VI, iphone and
   two_boards — golden tag counts on every frame, ID sets and corners
   against the port's own CPU run, frames/s timed with CUDA events, one
   ``decode_packed`` launch per pass with quads and no ``hamming_scan``; then
   the turbo mode on iphone and two_boards for the NMS and the drain
   variant, held the same way, and ``decimate="auto"`` on EuRoC against
   the exact result; the front-end's share of a chunk's time; then the
   hybrid runtime (``phase_runtime``) at batch 128, four chunks of a
   1080p batch interleaving two_boards, iphone and blank frames, exact and
   both turbo variants: its dispatches under
   ``torch.cuda.set_sync_debug_mode("error")``, every frame against the
   CPU run of its image, the results bit-equal across schedules (the
   search inline and on its worker, ``chunk=batch``, ``AG_FILL_RAMP=1``),
   the timeline's per-label sums, frames/s as median and spread of 5, the
   device-busy share of one call;
4. the split kernel chain at batch 32 on the four images (``gray_kernel ->
   fused_frontend -> cluster_rochade`` and ``front_kernel(emit_blur=True)
   -> cluster_rochade``), bit-equal to the fused chain;
5. the plane path: ``planes_frontend_batch`` at batch 32 on iphone and
   two_boards, exact and turbo, against its CPU run; ``detect_batch`` on
   4096 x 4096 frames (outside the label domain) holding two_boards — 72
   tags on every frame, equal to the CPU run, through ``fused_frontend``
   and not through the cluster kernel; one 16-frame chunk of 4100 x 4100
   frames with its peak device memory; ``refined_saddle_points`` with
   its time per call;
6. a line with the cluster entries' per-launch split, then one JSON line
   with each kernel's launches in phases 3-5 and 7-11 (counted per path:
   zeroed before it, read after it), its error against the plain version,
   its time, the plain version's time and its bound (and, for phase 7's
   rows, its device ms by torch.profiler); the ``hamming_scan`` row counts
   and times ``decode_packed``, which carries the scan on the hybrid path,
   and the ``hamming_scan[standalone]`` row the standalone scan's launches
   (the xla path's), timed on the rows that path gave it, with its device
   ms from calls queued behind a busy kernel (CUDA events);
7. (printed before 6) the NMS kernel's peak merge at every m in 0-8 bit-equal
   to its plain version on the four images' half planes at batch 32, with
   the sweeps each tile ran (a histogram of the kernel's flags) at m4 and
   m8, and the merge launch alone on the synthetic merge planes
   (``merge_synthetic_planes``: keys that cross a tile edge or corner by
   exactly the halo, rings, the plane's edges, chains whose fixed point
   comes at sweep 8) bit-equal to the plain merge at m1-m8; what ptxas
   reported for the merge's launches and the device split of m0/m4/m8,
   then ``detect_batch`` in the turbo NMS mode
   with ``AG_NMS_MERGE=8`` on the 1080p images against the CPU run (the
   merge's path); each kernel's row-sharding mode (``row_off``,
   ``global_h``) bit-equal to its plain version on the windows the
   row-sharded front-ends cut from each image (RGB as its u8 luma) and
   from the 4K frame of ``tools/bench_4k.py`` (u8 and x257 u16), timed on
   one shard's window; the row-sharded front-ends on that frame with all
   shards on this card (exact at 2 and 4 shards, turbo at 2 and 3 with the
   drain, at 2 with the NMS at m0 and m8), slot for slot bit-equal to the
   single-device front-end (their path), and their ms a frame;
8. (printed before 6) ingest and multi-device: ``detect_stream`` over four
   numpy batches each of two_boards (RGB), EuRoC (u8) and TUM_VI (u16) at
   batch 32, blank frames at other places in each batch, with the search
   on its worker and inline, every batch bit-equal to ``detect_batch``;
   the upload's enqueue (pinned staging, the side-stream copy, the
   consumer's wait) under ``torch.cuda.set_sync_debug_mode("error")``;
   ``to_detector_input`` on CUDA CHW tensors, which stay on the card;
   ``detect_batch_sharded`` (exact, turbo NMS and drain) on ``[cuda:0] * 2``
   and ``* 4``, ``MultiCameraDetector`` on a ``camera`` mesh of ``[cuda:0]
   * 2`` and ``PipelineParallelDetector`` on ``[cuda:0, cuda:0]``, each
   bit-equal to ``detect_batch`` (and on ``[cuda:0, cuda:1]`` where a
   second card is visible, else a line says it was not run); their ms
   beside ``detect_batch``'s on the same b32 batch, as a record;
9. (printed before 6) the xla mode: ``detect_batch`` at batch 16 on the
   four golden images — the golden count on every frame, ID sets equal to
   the hybrid's on the same batch with corners within 1e-4 px, the first
   frame equal to the port's CPU xla run; ``detect`` (one image, the plane
   path) on two_boards; ``decimate=True`` on iphone and two_boards against
   the hybrid turbo's drain variant (1e-3 px); ``detect_batch_sharded`` on
   ``[cuda:0] * 2`` bit-equal to ``detect_batch``; the standalone
   ``hamming_scan`` on the rows the path gave it, bit-equal to its plain
   version. Records, with no target: frames/s (median and spread of 5, CUDA
   events) beside the hybrid's on the same batch, the device ms of the
   front-end, the search and the decode, the host's reads of the search's
   loop conditions and all synchronizing calls a batch (sync-debug
   "warn"), the device-busy share and the peak device memory;
10. (printed before 6) the overlay, live-stream and chart surfaces, through
   the port alone: the charts of every family (``boards.generator.
   render_png`` at 2 px/mm, 1600 x 1600: t16h5 4x4, t25h7 and t25h9 5x5,
   t36h11 and t36h11b1 (one-bit border) 6x6, t36h11 2x2 from ID 10)
   through ``detect_batch`` exact and turbo at batch 8 and the xla mode at
   batch 2, every frame equal to the CPU run of its mode (IDs, corners
   within 1e-3 px), exact with every ID, frames/s; the demo path
   (``examples/demo.py``) on the four golden images as PIL hands them over
   (read-only arrays; the non-writable warning is an error): ``detect``,
   ``refined_saddle_points`` and ``decode_positions_px``, golden counts,
   ``viz.dump_overlay`` equal to ``render_overlay`` of the CPU results
   outside the boxes of elements that differ, ``write_timeline_html``
   over the four, its embedded counts; ``live.LiveStream`` on 127.0.0.1
   serving each frame's results (``/latest.jpg`` decodes to the frame's
   size, ``/state.json`` holds the card's IDs, a ``/stream.mjpg`` chunk is
   the last frame); ``profiling.detect_stage_report`` and
   ``profiling.trace`` (CUDA kernel events) on two_boards at batch 32;
   the per-frame ms of detect, saddles, render, PNG write and publish;
11. (printed before 6) the runnable examples and the 4K rig, as a user
   runs them (``phase_examples``): ``examples.demo`` in-process on the
   four golden images, exact, ``--turbo`` and ``--mode xla`` — golden
   counts, the exact run equal to the same example's CPU run (IDs;
   corners, decode points and saddles within 1e-3 px, orientations within
   1e-3 deg), turbo and xla with the exact run's IDs and corners within
   0.1 px, each frame's ``detect_ms``; one ``python3 -m
   aprilgrid_tpu_torch.examples.demo`` subprocess; ``examples.develop``
   on two_boards against its CPU run; ``examples.live`` for one loop on a
   free port; the 4K rig of ``bench --4k`` (4 cameras x 8 steps of
   two_boards on a 3840 x 2160 canvas, exact and turbo ``"auto"``, 2
   reps): 72 tags on every frame, parity with the CPU run of one frame,
   frames/s.

The last line is ``{"ok": true, "device": {...}}``. Run from the
repository root: ``python3 chip_smoke.py`` (``--kernels-only`` stops after
phase 2, for a first check of new kernels; ``--cluster-only`` runs phase 2
on two_boards alone, for work on the cluster kernels; ``--turbo-only`` runs
the turbo path's kernel checks, the NMS and refine synthetic cases and their
per-launch split, for work on those two kernels; ``--front-only`` runs the
front kernel's synthetic check and ``phase_front_split``, for work on the
front kernel; ``--decimate-only`` runs the decimating front kernel's
synthetic check and ``phase_decimate_split``, for work on that kernel;
``--decode-only`` runs the decode kernels' checks and
``phase_decode_split``, for work on the decode; ``--runtime-only`` runs
``phase_runtime``, for work on the facade's runtime; ``--sharded-only``
runs phase 7, for work on the merge and the row sharding; ``--ingest-only``
runs phase 8, for work on streaming and the multi-device detectors;
``--xla-only`` runs phase 9, for work on the xla mode; ``--viz-only`` runs
phase 10, for work on the surfaces; ``--examples-only`` runs phase 11, for
work on the examples and the 4K rig; ``--split-only`` runs
``phase_launch_split``, the per-launch split of the NMS at m0 and m8 and of
the kernels that share its tile passes, for comparing a change with its
parent in one call: copy the script into an unpacked parent and run both).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import sys
import time
import urllib.request

import numpy as np

from aprilgrid_tpu_torch.utils.images import DATA, read_png

GOLDEN = {"EuRoC": 36, "TUM_VI": 36, "iphone": 66, "two_boards": 72}
TURBO = ("iphone", "two_boards")   # the turbo mode's frames: >= 2 MP
# per fitted candidate: 25 x 25 cone taps + 5 x 5 x 5 + 5 x 5 fit taps, x2
# (multiply + add), plus ~30 for the solve and the gates
FIT_OPS = 2 * (625 + 125 + 25) + 30
# per pixel of a blurred plane: 2 x 7-tap blur (28), Hessian (13), min or
# compare (1)
STENCIL_OPS = 42.0

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor)
# operations/s; the bound of a kernel is the larger of its two times.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def _ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _bound_ms(nbytes: float, f32_ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES * 1e3, f32_ops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_build() -> str:
    from aprilgrid_tpu_torch import native
    from aprilgrid_tpu_torch.bench import card_name
    from aprilgrid_tpu_torch.kernels import _lib

    card = card_name()
    print(card, flush=True)
    t0 = time.perf_counter()
    native.build()
    t1 = time.perf_counter()
    _lib.lib()
    t2 = time.perf_counter()
    print(f"build: native search {t1 - t0:.1f} s, CUDA kernels {t2 - t1:.1f} s",
          flush=True)
    return card


def phase_kernels(card: str, batch: int, names=tuple(GOLDEN)) -> dict:
    """Each kernel against its plain version on the same CUDA tensors, on
    every golden image (``names``) at the main path's chunk size; the turbo
    path's kernels at that size on its own frames (``TURBO``) and at a
    quarter of it on the other raw modes."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.cluster import (
        cluster_rochade_raw,
        cluster_rochade_raw_plain,
        sort_candidates,
    )
    from aprilgrid_tpu_torch.kernels.frontend import (
        front_kernel,
        front_kernel_plain,
        pad_raw,
        raw_luma,
    )
    from aprilgrid_tpu_torch.ops.cluster import label_components
    from aprilgrid_tpu_torch.ops.frontend import gaussian_blur, hessian_response

    dev = torch.device("cuda")
    sigma = CONSTANTS.blur_sigma
    rec: dict = {}
    for name in names:
        img = torch.from_numpy(read_png(DATA / f"{name}.png")).to(dev)
        frames = img[None].expand(batch, *img.shape).contiguous()
        raw_p, h, w, ch, u16 = pad_raw(frames)
        args = (raw_p, sigma, (h, w), ch, u16)

        l8, tmin = front_kernel(*args)
        pl8, ptmin = front_kernel_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(l8, pl8) and torch.equal(tmin, ptmin)):
            raise AssertionError(
                f"front_kernel {name}: luma8 diff "
                f"{(l8.int() - pl8.int()).abs().max().item()}, tile-min diff "
                f"{(tmin - ptmin).abs().max().item()}"
            )
        front_err = (tmin - ptmin).abs().max().item()

        thr = tmin.amin(-1) * CONSTANTS.response_threshold_ratio
        cargs = (raw_p, thr, h, w, ch, u16, sigma)
        f, c = cluster_rochade_raw(*cargs)
        pf, pc = cluster_rochade_raw_plain(*cargs)
        torch.cuda.synchronize()
        if not torch.equal(c, pc):
            raise AssertionError(f"cluster {name}: counts {c.tolist()} vs {pc.tolist()}")
        (sf, _), (spf, _) = sort_candidates(f), sort_candidates(pf)
        if not (torch.equal(sf[..., 6:8], spf[..., 6:8])):
            raise AssertionError(f"cluster {name}: labels/ok differ")
        cl_err = (sf[..., [0, 1, 3, 4, 5]] - spf[..., [0, 1, 3, 4, 5]]).abs().max().item()
        if cl_err > 1e-4:
            raise AssertionError(f"cluster {name}: x/y/c3/c4/c5 differ by {cl_err}")
        print(f"kernels {name} {tuple(img.shape)} b{batch}: front luma8+tile-min "
              f"bit-equal (max |diff| {front_err}); cluster counts equal "
              f"({int(c[0, 0].item())} accepted/frame), max |diff| {cl_err}",
              flush=True)

        # work actually done by this run: the pixels of the padded planes
        # and the components whose fit ran (counted with the plain blocks)
        lf, _ = raw_luma(raw_p[:1, 8 : 8 + h, : w * ch], ch, u16)
        resp = hessian_response(gaussian_blur(lf, sigma))[0]
        rr = torch.arange(h, device=dev)[:, None]
        cc = torch.arange(w, device=dev)[None, :]
        mask = (rr > 0) & (rr < h - 1) & (cc > 0) & (cc < w - 1) & (resp < thr[0])
        lab = label_components(mask)
        roots = int((mask & (lab == torch.arange(h * w, device=dev).reshape(h, w))).sum())
        hp, wp = raw_p.shape[1] - 16, raw_p.shape[2] // ch
        px = batch * hp * wp
        dense_ops = (5.0 + STENCIL_OPS) * px   # luma (<= 5) + the stencil
        raw_bytes = raw_p.numel() * raw_p.element_size()
        rec[name] = {
            "front": dict(
                err=front_err, ms=_ms(lambda: front_kernel(*args), 20),
                plain_ms=_ms(lambda: front_kernel_plain(*args), 2),
                bound=_bound_ms(raw_bytes + px + tmin.numel() * 4, dense_ops),
            ),
            "cluster": dict(
                err=cl_err, ms=_ms(lambda: cluster_rochade_raw(*cargs), 10),
                plain_ms=_ms(lambda: cluster_rochade_raw_plain(*cargs), 1),
                bound=_bound_ms(
                    raw_bytes + thr.numel() * 4 + f.numel() * 4 + c.numel() * 4,
                    dense_ops + batch * roots * FIT_OPS,
                ),
            ),
        }
        turbo_kernels(name, frames if name in TURBO else frames[: batch // 4], rec)
        plane_kernels(name, frames, thr, roots, rec)
    nms_tie_break_check()
    nms_synthetic_check()
    refine_synthetic_check()
    cluster_synthetic_check()
    cluster_raw_synthetic_check()
    front_synthetic_check()
    front_decimate_synthetic_check()

    rec.update(decode_checks(batch))
    timed = [(f"{n}.{k}", r) for n in names
             for k, r in rec[n].items()] + [("hamming", rec["hamming"])]
    _print_times(card, timed)
    return rec


def _print_times(card: str, timed) -> None:
    for key, r in timed:
        print(f"time {key}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]}) [{card}]",
              flush=True)


def turbo_kernels(name: str, frames, rec: dict) -> None:
    """The turbo path's kernels against their plain versions on one image's
    frames (already on the card), chained as the path chains them."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.cluster import (
        cluster_rochade_raw,
        cluster_rochade_raw_plain,
        sort_candidates,
    )
    from aprilgrid_tpu_torch.kernels.frontend import (
        front_kernel_decimate,
        front_kernel_decimate_plain,
        pad_raw,
    )
    from aprilgrid_tpu_torch.kernels.nms import nms_extract_raw, nms_extract_raw_plain
    from aprilgrid_tpu_torch.kernels.refine import (
        sparse_refine_raw,
        sparse_refine_raw_plain,
    )
    from aprilgrid_tpu_torch.ops.cluster import label_components
    from aprilgrid_tpu_torch.ops.frontend import gaussian_blur, hessian_response
    from aprilgrid_tpu_torch.ops.rochade import fit_taps

    dev = frames.device
    sigma = CONSTANTS.blur_sigma
    batch = frames.shape[0]
    raw_p, h, w, ch, u16 = pad_raw(frames)
    hh, wh = h // 2, w // 2
    args = (raw_p, sigma, (h, w), ch, u16)

    l8, half_p, tmin = front_kernel_decimate(*args)
    pl8, phalf, ptmin = front_kernel_decimate_plain(*args)
    torch.cuda.synchronize()
    fd_err = max((half_p - phalf).abs().max().item(), (tmin - ptmin).abs().max().item())
    if not (torch.equal(l8, pl8) and torch.equal(half_p, phalf) and torch.equal(tmin, ptmin)):
        raise AssertionError(
            f"front_kernel_decimate {name}: luma8 diff "
            f"{(l8.int() - pl8.int()).abs().max().item()}, half plane / tile-min diff {fd_err}"
        )

    thr = tmin.amin(-1) * CONSTANTS.response_threshold_ratio
    cargs = (half_p, thr, hh, wh, 1, False, sigma, 4, 1.0, True)
    f, c = cluster_rochade_raw(*cargs)
    pf, pc = cluster_rochade_raw_plain(*cargs)
    torch.cuda.synchronize()
    (sf, _), (spf, _) = sort_candidates(f), sort_candidates(pf)
    cl_err = (sf[..., :6] - spf[..., :6]).abs().max().item()
    if not (torch.equal(c, pc) and torch.equal(sf[..., 6:8], spf[..., 6:8])) or cl_err > 0:
        raise AssertionError(
            f"cluster[luma_f32] {name}: counts {c[0].tolist()} vs {pc[0].tolist()}, "
            f"record diff {cl_err}"
        )

    nargs = (half_p, thr, hh, wh, sigma, 4, 1.0)
    cells = nms_extract_raw(*nargs)
    pcells = nms_extract_raw_plain(*nargs)
    torch.cuda.synchronize()
    nms_err = (cells - pcells).abs().max().item()
    if not torch.equal(cells, pcells):
        raise AssertionError(
            f"nms_extract_raw {name}: {int((cells[:, 5] > 0.5).sum())} vs "
            f"{int((pcells[:, 5] > 0.5).sum())} peaks, max |diff| {nms_err}"
        )

    chain = turbo_chain(frames)   # the survivors of these cells, as the path gates them
    rargs = chain["rargs"]
    centers, valid = rargs[1:3]
    rs = sparse_refine_raw(*rargs)
    prs = sparse_refine_raw_plain(*rargs)
    torch.cuda.synchronize()
    rf_err = max((getattr(rs, k) - getattr(prs, k))[valid].abs().max().item()
                 for k in ("p", "k", "theta", "phi"))
    if not torch.equal(rs.valid, prs.valid) or rf_err > 0:
        first = []
        for k in ("p", "k", "theta", "phi"):
            d = getattr(rs, k) != getattr(prs, k)
            d = (d.any(-1) if d.ndim == 3 else d) & valid
            if d.any():
                i = tuple(d.nonzero()[0].tolist())
                first.append(f"{k}: {int(d.sum())} slots, first {i}: kernel "
                             f"{getattr(rs, k)[i].tolist()!r}, plain {getattr(prs, k)[i].tolist()!r}")
        raise AssertionError(
            f"sparse_refine_raw {name}: valid {int(rs.valid.sum())} vs "
            f"{int(prs.valid.sum())}, max |diff| over processed slots {rf_err}; "
            + "; ".join(first)
        )
    print(f"kernels {name} {tuple(frames.shape[1:])} b{batch} turbo: front_decimate, "
          f"cluster[luma_f32] ({int(c[0, 0].item())} accepted/frame), nms "
          f"({chain['peaks']} peaks/frame), refine ({int(valid[0].sum())} slots, "
          f"{int(rs.valid[0].sum())} accepted/frame) bit-equal to their plain versions",
          flush=True)

    # work this run's data needs (frame 0; the frames are copies)
    blur = gaussian_blur(half_p[:1, 8 : 8 + hh, :wh], sigma)
    resp = hessian_response(blur)[0]
    rr = torch.arange(hh, device=dev)[:, None]
    cc = torch.arange(wh, device=dev)[None, :]
    mask = (rr > 0) & (rr < hh - 1) & (cc > 0) & (cc < wh - 1) & (resp < thr[0])
    lab = label_components(mask)
    roots = int((mask & (lab == torch.arange(hh * wh, device=dev).reshape(hh, wh))).sum())
    fitted, fit_tiles = chain["fits"], chain["tiles_with_fits"]
    slots = int(valid.sum())                     # refine slots, whole batch
    print(f"work {name} b{batch} turbo: {fitted} fits/frame in nms_extract_raw "
          f"({100 * fitted / (hh * wh):.2f} % of the half plane) in {fit_tiles} tiles of "
          f"64 x 64, {roots} roots/frame, {slots} refine slots in the batch of "
          f"{valid.numel()}", flush=True)
    # the record gate in its tile form: the cone taps at every pixel of a tile
    # that holds a fit; per fit the vertical taps on five columns, the
    # horizontal taps and the closed form (~30); x2: multiply + add
    cone, fits = fit_taps(2)
    tile_ops = 2.0 * len(cone)
    row_ops = 2.0 * sum(5 * len(vt) + len(ht) for _, vt, ht in fits) + 30.0
    hpx = batch * (half_p.shape[1] - 16) * half_p.shape[2]
    px = batch * (raw_p.shape[1] - 16) * (raw_p.shape[2] // ch)
    nbytes = lambda *ts: float(sum(t.numel() * t.element_size() for t in ts))  # noqa: E731
    nms_ops = STENCIL_OPS * hpx + batch * (fit_tiles * 4096 * tile_ops
                                           + fitted * (row_ops + 98))
    print(f"bound {name} b{batch} nms_extract_raw: bytes "
          f"{nbytes(half_p, thr, cells) / PEAK_BYTES * 1e3:.4f} ms, operations of the "
          f"tile form {nms_ops / PEAK_F32 * 1e3:.4f} ms", flush=True)
    rec[name].update({
        "front_decimate": dict(
            err=fd_err, ms=_ms(lambda: front_kernel_decimate(*args), 20),
            plain_ms=_ms(lambda: front_kernel_decimate_plain(*args), 2),
            # per pixel: both lumas (<= 10) and its share of the mean (1)
            bound=_bound_ms(nbytes(raw_p, l8, half_p, tmin), 11.0 * px + STENCIL_OPS * hpx),
        ),
        "cluster_f32": dict(
            err=cl_err, ms=_ms(lambda: cluster_rochade_raw(*cargs), 10),
            plain_ms=_ms(lambda: cluster_rochade_raw_plain(*cargs), 1),
            bound=_bound_ms(nbytes(half_p, thr, f, c),
                            STENCIL_OPS * hpx + batch * roots * FIT_OPS),
        ),
        "nms": dict(
            err=nms_err, ms=_ms(lambda: nms_extract_raw(*nargs), 10),
            plain_ms=_ms(lambda: nms_extract_raw_plain(*nargs), 1),
            # the stencil, the tile form of the gate, 49 compares per pass of
            # the peak window at each fitted pixel
            bound=_bound_ms(nbytes(half_p, thr, cells), nms_ops),
        ),
        "refine": dict(
            err=rf_err, ms=_ms(lambda: sparse_refine_raw(*rargs), 20),
            plain_ms=_ms(lambda: sparse_refine_raw_plain(*rargs), 2),
            # per slot: a 15 x 15 raw patch read, luma (5 per pixel), the two
            # blur passes (135 + 81 outputs x 14) and the fit; 32 bytes out
            bound=_bound_ms(
                slots * 225.0 * ch * raw_p.element_size() + nbytes(centers, valid)
                + batch * centers.shape[1] * 32.0,
                slots * (225 * 5 + 216 * 14 + FIT_OPS),
            ),
        ),
    })


def plane_kernels(name: str, frames, thr, roots: int, rec: dict) -> None:
    """The plane path's kernels against their plain versions on one image's
    frames (already on the card): ``fused_frontend`` (cropped and padded
    forms), ``gray_kernel``, ``front_kernel(emit_blur=True)`` and the
    blur-fed ``cluster_rochade`` (``thr``: the frames' thresholds, ``roots``:
    the components per frame whose fit runs). All must be bit-equal."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.cluster import (
        cluster_rochade,
        cluster_rochade_plain,
        sort_candidates,
    )
    from aprilgrid_tpu_torch.kernels.frontend import (
        front_kernel,
        front_kernel_plain,
        fused_frontend,
        fused_frontend_plain,
        gray_kernel,
        gray_kernel_plain,
        pad_raw,
    )
    from aprilgrid_tpu_torch.ops.gray import to_luma_batch

    sigma = CONSTANTS.blur_sigma
    batch, h, w = frames.shape[:3]

    def diff(a, b):
        return (a.float() - b.float()).abs().max().item()

    def hold(what, got, want):
        torch.cuda.synchronize()
        err = max(diff(g, p) for g, p in zip(got, want))
        if not all(g.shape == p.shape and torch.equal(g, p) for g, p in zip(got, want)):
            raise AssertionError(f"{what} {name}: differs from its plain version, "
                                 f"max |diff| {err}")
        return err

    luma, _ = to_luma_batch(frames)
    luma = luma.contiguous()
    fu_err = hold("fused_frontend", fused_frontend(luma, sigma),
                  fused_frontend_plain(luma, sigma))
    fu_err = max(fu_err, hold(
        "fused_frontend[crop=False]", fused_frontend(luma, sigma, crop=False),
        fused_frontend_plain(luma, sigma, crop=False)))

    gr = gray_kernel(frames)
    gr_err = hold("gray_kernel", gr, gray_kernel_plain(frames))
    blur_p, tmin = fused_frontend(gr[0], sigma, crop=False, true_shape=(h, w),
                                  emit_resp=False)
    fu_err = max(fu_err, hold(
        "fused_frontend[true_shape]", (blur_p, tmin),
        fused_frontend_plain(gr[0], sigma, False, (h, w), False)))

    raw_p, _, _, ch, u16 = pad_raw(frames)
    args = (raw_p, sigma, (h, w), ch, u16, True)
    eb = front_kernel(*args)
    eb_err = hold("front_kernel[emit_blur]", eb, front_kernel_plain(*args))
    if not torch.equal(eb[0], blur_p):
        raise AssertionError(f"{name}: the front kernel's blur plane differs from "
                             f"fused_frontend's by {diff(eb[0], blur_p)}")

    f, c = cluster_rochade(blur_p, thr, h, w)
    pf, pc = cluster_rochade_plain(blur_p, thr, h, w)
    cl_err = hold("cluster_rochade", (c, *sort_candidates(f)), (pc, *sort_candidates(pf)))
    print(f"kernels {name} {tuple(frames.shape[1:])} b{batch} planes: fused_frontend "
          f"(cropped, padded, pre-padded), gray_kernel, front_kernel[emit_blur], "
          f"cluster_rochade ({int(c[0, 0].item())} accepted/frame) bit-equal to "
          "their plain versions", flush=True)

    px = batch * blur_p.shape[1] * blur_p.shape[2]
    nbytes = lambda *ts: float(sum(t.numel() * t.element_size() for t in ts))  # noqa: E731
    blur, resp = fused_frontend(luma, sigma)
    rec[name].update({
        "fused": dict(
            err=fu_err, ms=_ms(lambda: fused_frontend(luma, sigma), 20),
            plain_ms=_ms(lambda: fused_frontend_plain(luma, sigma), 2),
            bound=_bound_ms(nbytes(luma, blur, resp), STENCIL_OPS * px),
        ),
        "gray": dict(
            err=gr_err, ms=_ms(lambda: gray_kernel(frames), 20),
            plain_ms=_ms(lambda: gray_kernel_plain(frames), 2),
            bound=_bound_ms(nbytes(frames, *gr), 10.0 * px),   # both lumas <= 10
        ),
        "front_emit_blur": dict(
            err=eb_err, ms=_ms(lambda: front_kernel(*args), 20),
            plain_ms=_ms(lambda: front_kernel_plain(*args), 2),
            bound=_bound_ms(nbytes(raw_p, *eb), (5.0 + STENCIL_OPS) * px),
        ),
        "cluster_blur": dict(
            err=cl_err, ms=_ms(lambda: cluster_rochade(blur_p, thr, h, w), 10),
            plain_ms=_ms(lambda: cluster_rochade_plain(blur_p, thr, h, w), 1),
            # Hessian + compare per pixel, a fit per component
            bound=_bound_ms(nbytes(blur_p, thr, f, c), 14.0 * px + batch * roots * FIT_OPS),
        ),
    })


def synthetic_blur_planes(h: int = 250, w: int = 380, seed: int = 0):
    """Blur planes whose response masks no photograph produces, from
    ``seed`` with numpy alone: ``(names, planes (B, h, w) f32, thr (B,)
    f32)``, the mask of frame i being ``hessian_response(planes[i]) <
    thr[i]`` inside the one-pixel border.

    ``r * c`` has response exactly -1; set into 3-pixel strokes on a zero
    plane it masks each stroke and a pixel either side of it, never the
    middle of a gap of 4 or more: a rectangular *spiral* and a *comb* (a
    spine with teeth), long components that cross every 64x64 tile
    border. ``((-1)^c - (-1)^r) / 2`` has response -4 (-1)^(r + c): a
    *checkerboard* of single-pixel components. ``r * c`` everywhere is one
    blob over the *whole* interior; zeros give an *empty* mask; ``sin *
    sin`` of period 16 has a true saddle every 8 pixels, more accepted
    roots than a frame's 1024 rows (*lattice*); *noise* is a dense random
    mask of irregular blobs."""
    rng = np.random.default_rng(seed)
    r = np.arange(h, dtype=np.float32)[:, None]
    c = np.arange(w, dtype=np.float32)[None, :]
    saddle = r * c

    def paint(on, y, x):
        on[y - 1 : y + 2, x - 1 : x + 2] = True

    spiral = np.zeros((h, w), bool)
    pitch = int(rng.integers(8, 11))
    y, x = 5 + int(rng.integers(0, 3)), 5 + int(rng.integers(0, 3))
    run = [w - 2 * x, h - 2 * y]            # next horizontal, vertical run
    step = ((0, 1), (1, 0), (0, -1), (-1, 0))
    turn = 0
    while run[turn % 2] > pitch:
        dy, dx = step[turn % 4]
        for _ in range(run[turn % 2]):
            paint(spiral, y, x)
            y, x = y + dy, x + dx
        if turn >= 1:
            run[turn % 2] -= pitch
        turn += 1

    comb = np.zeros((h, w), bool)
    comb[4:7, 4 : w - 4] = True
    for x in range(5, w - 5, int(rng.integers(7, 10))):
        comb[4 : h - 4 - int(rng.integers(0, 40)), x - 1 : x + 2] = True

    checker = (np.where(c % 2 == 0, 1.0, -1.0) - np.where(r % 2 == 0, 1.0, -1.0)) / 2
    lattice = np.sin(np.pi * r / 8) * np.sin(np.pi * c / 8)
    noise = rng.standard_normal((h, w))

    def resp(v):
        v = v.astype(np.float32)
        lxx = v[1:-1, :-2] - 2 * v[1:-1, 1:-1] + v[1:-1, 2:]
        lyy = v[:-2, 1:-1] - 2 * v[1:-1, 1:-1] + v[2:, 1:-1]
        lxy = (v[:-2, 2:] - v[:-2, :-2] + v[2:, :-2] - v[2:, 2:]) * 0.25
        return lxx * lyy - lxy * lxy

    frames = {
        "spiral": (np.where(spiral, saddle, 0), -0.5),
        "comb": (np.where(comb, saddle, 0), -0.5),
        "checkerboard": (checker + 0 * saddle, -2.0),
        "whole": (saddle, -0.5),
        "empty": (0 * saddle, -1.0),
        "lattice": (lattice, 0.5 * float(resp(lattice).min())),
        "noise": (noise, float(np.quantile(resp(noise), 0.3))),
    }
    planes = np.stack([p for p, _ in frames.values()]).astype(np.float32)
    thr = np.array([t for _, t in frames.values()], np.float32)
    return tuple(frames), planes, thr


def synthetic_luma_thresholds(names, half_p, thr, h: int, w: int, **other):
    """Thresholds for the synthetic planes taken as luma planes (``half_p``:
    their ``pad_half`` form on the card): an entry that blurs them first
    thresholds the blurred planes at a share of each frame's own minimum
    response, as the pipeline does (whole and empty keep ``thr``); ``other``
    replaces a frame's share."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.frontend import _response_tile_min

    shares = {"spiral": 0.05, "comb": 0.05, "checkerboard": 0.5, "lattice": 0.5,
              "noise": 0.3, **other}
    share = torch.tensor([shares.get(n, 0.0) for n in names], device="cuda")
    rthr = _response_tile_min(half_p, CONSTANTS.blur_sigma, (h, w)).amin(-1) * share
    return torch.where(share == 0.0, thr, rthr)


def _held_candidates(label: str, names, f, c, pf, pc, blur, thr) -> list:
    """A cluster entry's (fields, counts) against its plain version's on
    the same frames (``blur``: the plain blur planes the masks come from,
    ``thr`` their thresholds): counts equal and sorted fields bit-equal; in
    a frame whose accepted roots overflow the 1024 rows the kernel's rows
    are 1024 different rows of the plain version's uncut list. Returns the
    accepted roots of each frame before the cut."""
    import torch

    from aprilgrid_tpu_torch.kernels.cluster import (
        _CAPF,
        candidate_rows_plain,
        sort_candidates,
    )

    if not torch.equal(c, pc):
        raise AssertionError(f"{label}: counts {c[:, 0].tolist()} vs {pc[:, 0].tolist()}")
    (sf, _), (spf, _) = sort_candidates(f), sort_candidates(pf)
    accepted = []
    for i, name in enumerate(names):
        n = int(c[i, 0])
        every = candidate_rows_plain(blur[i], thr[i])
        if every.shape[0] <= _CAPF:
            same = torch.equal(sf[i], spf[i])
        else:
            # any 1024 of the accepted roots: each row is the plain row of
            # its label, no label twice
            at = torch.searchsorted(every[:, 7].contiguous(), sf[i, :, 7].contiguous())
            at = at.clamp(max=every.shape[0] - 1)
            same = (n == _CAPF and torch.equal(every[at], sf[i])
                    and bool((sf[i, 1:, 7] > sf[i, :-1, 7]).all()))
        if not same:
            raise AssertionError(f"{label} {name}: fields differ from the plain version "
                                 f"({n} rows of {every.shape[0]} accepted)")
        accepted.append(every.shape[0])
    return accepted


def cluster_synthetic_check() -> None:
    """Both cluster entries against their plain versions on the synthetic
    planes, one batch with a different mask per frame: ``cluster_rochade``
    on the planes as blur planes, ``cluster_rochade_raw(luma_f32=True)`` on
    them as luma planes (it blurs them first, so its masks are the
    smoothed shapes). Counts equal and sorted fields bit-equal; in a frame
    whose accepted roots overflow the 1024 rows the kernel's rows are 1024
    different rows of the plain version's uncut list."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.cluster import (
        _CAPF,
        cluster_rochade,
        cluster_rochade_plain,
        cluster_rochade_raw,
        cluster_rochade_raw_plain,
    )
    from aprilgrid_tpu_torch.kernels.frontend import pad_half
    from aprilgrid_tpu_torch.ops.cluster import label_components
    from aprilgrid_tpu_torch.ops.frontend import gaussian_blur, hessian_response

    sigma = CONSTANTS.blur_sigma
    names, planes, thr = synthetic_blur_planes()
    planes, thr = torch.from_numpy(planes).cuda(), torch.from_numpy(thr).cuda()
    b, h, w = planes.shape
    hp, wp = -(-h // 64) * 64, -(-w // 128) * 128
    blur_p = torch.nn.functional.pad(planes, (0, wp - w, 0, hp - h))
    half_p = pad_half(planes)
    rthr = synthetic_luma_thresholds(names, half_p, thr, h, w)
    runs = (
        ("cluster_rochade", planes, thr,
         cluster_rochade(blur_p, thr, h, w), cluster_rochade_plain(blur_p, thr, h, w)),
        ("cluster_rochade_raw[luma_f32]", gaussian_blur(planes, sigma), rthr,
         cluster_rochade_raw(half_p, rthr, h, w, luma_f32=True),
         cluster_rochade_raw_plain(half_p, rthr, h, w, luma_f32=True)),
    )
    torch.cuda.synchronize()
    rr = torch.arange(h, device="cuda")[:, None]
    cc = torch.arange(w, device="cuda")[None, :]
    inner = (rr > 0) & (rr < h - 1) & (cc > 0) & (cc < w - 1)
    index = torch.arange(h * w, device="cuda").reshape(h, w)
    for entry, blur, t, (f, c), (pf, pc) in runs:
        every = _held_candidates(f"{entry} synthetic", names, f, c, pf, pc, blur, t)
        mask = inner & (hessian_response(blur) < t[:, None, None])
        roots = (mask & (label_components(mask) == index)).sum((1, 2)).tolist()
        if max(every) <= _CAPF:
            raise AssertionError(f"{entry} synthetic: no frame overflows {_CAPF} rows")
        said = [f"{name} {int(mask[i].sum())} masked/{roots[i]} roots/{every[i]} accepted"
                for i, name in enumerate(names)]
        print(f"kernels {entry} synthetic {h}x{w} b{b}: counts equal, sorted fields "
              f"bit-equal (overflowing frames: rows of the uncut plain list); "
              + ", ".join(said), flush=True)


def cluster_raw_synthetic_check() -> None:
    """``cluster_rochade_raw`` against its plain version on synthetic raw
    frames (``synthetic_raw_frames``) of every raw mode and every shape of
    ``FRONT_SHAPES`` at batch 1 and 3, once per raw mode on a raw array one
    element off alignment, and in its ``luma_f32`` mode on the half planes
    of those frames (``front_kernel_decimate``'s; the first shape's also
    one element off alignment): counts equal and sorted fields bit-equal.
    Launch (a)'s four staging modes, its border blocks and its per-element
    quads all run here. The thresholds are the paths': the ratio times the
    frame's minimum response."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.cluster import (
        cluster_rochade_raw,
        cluster_rochade_raw_plain,
        raw_blur_plain,
    )
    from aprilgrid_tpu_torch.kernels.frontend import front_kernel, front_kernel_decimate, pad_raw

    sigma, ratio = CONSTANTS.blur_sigma, CONSTANTS.response_threshold_ratio
    n, accepted = 0, 0
    for mode in ("u8", "u16", "rgb"):
        for h, w in FRONT_SHAPES:
            for batch in (1, 3):
                frames = torch.from_numpy(
                    synthetic_raw_frames(mode, h, w, batch, seed=200 + n)).cuda()
                raw_p, _, _, ch, u16 = pad_raw(frames)
                thr = front_kernel(raw_p, sigma, (h, w), ch, u16)[1].amin(-1) * ratio
                _, half_p, hmin = front_kernel_decimate(raw_p, sigma, (h, w), ch, u16)
                hthr = hmin.amin(-1) * ratio
                runs = [("raw", raw_p, thr, (h, w, ch, u16), False),
                        ("luma_f32", half_p, hthr, (h // 2, w // 2, 1, False), True)]
                if (h, w) == FRONT_SHAPES[0] and batch == 3:
                    runs += [(f"{k} misaligned", _misaligned(a), t, shape, lf)
                             for k, a, t, shape, lf in runs]
                for label, a, t, shape, lf in runs:
                    f, c = cluster_rochade_raw(a, t, *shape, sigma, luma_f32=lf)
                    pf, pc = cluster_rochade_raw_plain(a, t, *shape, sigma, luma_f32=lf)
                    torch.cuda.synchronize()
                    blur = raw_blur_plain(a, *shape, sigma, lf)
                    names = [f"{mode} {h}x{w} b{batch} {label} frame {i}" for i in range(batch)]
                    accepted += sum(_held_candidates("cluster_rochade_raw synthetic", names,
                                                     f, c, pf, pc, blur, t))
                    n += 1
    print(f"kernels cluster_rochade_raw synthetic: u8/u16/rgb x {FRONT_SHAPES} x b1/b3, "
          f"raw and luma_f32 + a misaligned pointer per mode ({n} runs, {accepted} "
          "accepted roots): counts equal, sorted fields bit-equal", flush=True)


def _print_ptxas(source: str) -> list[dict]:
    """What ptxas reported for the kernels of ``csrc/<source>``, one line
    each; returns the records."""
    from aprilgrid_tpu_torch.kernels import _lib

    res = _lib.kernel_resources(source)
    for r in res:
        print(f"ptxas {source} {r['kernel']}: {r['registers']} registers, "
              f"{r['stack_bytes']} B stack frame, spills {r['spill_store_bytes']}/"
              f"{r['spill_load_bytes']} B (stores/loads), {r['smem_bytes']} B smem",
              flush=True)
    return res


def _profile_split(calls: dict, iters: int = 10) -> dict:
    """torch.profiler's device time of each entry of ``calls`` (name ->
    function), mean over ``iters`` calls after one warm-up: per entry the ms
    of each of this library's kernels by name, and under ``"at::"`` the
    summed ms and the count per call of every other device operation the
    call enqueues (PyTorch's own kernels, fills and copies). A session whose
    trace holds no device event of this library is taken again, up to three
    sessions: the profiler has once returned a session without device events
    (an NVIDIA H100 80GB HBM3 run of the whole smoke, where every other
    session had them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    split = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            own, other_ms, other_n = {}, 0.0, 0
            for ev in prof.key_averages():
                if "CUDA" not in str(getattr(ev, "device_type", "")):
                    continue   # a host-side operator: its kernels are listed themselves
                mine = re.search(r"(\w+_kernel(?:<\w+>)?)\(", ev.key)
                if mine and "at::" not in ev.key:
                    own[mine.group(1)] = ev.device_time_total / ev.count / 1e3
                else:
                    other_ms += ev.device_time_total / iters / 1e3
                    other_n += ev.count
            if own:
                break
            print(f"profile split {name}: a session without device events, taken again",
                  flush=True)
        if not own or min(own.values()) <= 0.0:
            raise AssertionError(f"{name}: the profiler shows no device time: {own}")
        split[name] = dict(own)
        if other_n:
            split[name]["at::"] = {"ms": other_ms, "per_call": other_n / iters}
    return split


def phase_cluster_split(card: str, batch: int) -> dict:
    """Device ms of each launch of the three cluster entries on two_boards
    at ``batch``: torch.profiler's device time by kernel name, mean of 10
    calls; prints what ptxas reported for the kernels of ``cluster.cu``."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.cluster import cluster_rochade, cluster_rochade_raw
    from aprilgrid_tpu_torch.kernels.frontend import (
        front_kernel,
        front_kernel_decimate,
        pad_raw,
    )

    sigma, ratio = CONSTANTS.blur_sigma, CONSTANTS.response_threshold_ratio
    _print_ptxas("cluster.cu")
    img = torch.from_numpy(read_png(DATA / "two_boards.png")).cuda()
    frames = img[None].expand(batch, *img.shape).contiguous()
    raw_p, h, w, ch, u16 = pad_raw(frames)
    blur_p, _, tmin = front_kernel(raw_p, sigma, (h, w), ch, u16, emit_blur=True)
    thr = tmin.amin(-1) * ratio
    _, half_p, hmin = front_kernel_decimate(raw_p, sigma, (h, w), ch, u16)
    hthr = hmin.amin(-1) * ratio
    split = _profile_split({
        "cluster_rochade_raw": lambda: cluster_rochade_raw(raw_p, thr, h, w, ch, u16, sigma),
        "cluster_rochade_raw[luma_f32]": lambda: cluster_rochade_raw(
            half_p, hthr, h // 2, w // 2, 1, False, sigma, 4, 1.0, True),
        "cluster_rochade": lambda: cluster_rochade(blur_p, thr, h, w),
    })
    # the wrappers' own fills are not launches of the entries
    return {k: {n: ms for n, ms in v.items() if n != "at::"} for k, v in split.items()}


def turbo_chain(frames) -> dict:
    """The turbo path's kernel chain on ``frames`` (on the card) up to the
    inputs of its last kernel: the arguments of ``nms_extract_raw`` and of
    ``sparse_refine_raw`` as the path builds them, and what the data asks
    of them (frame 0; the smoke's frames are copies)."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
    from aprilgrid_tpu_torch.kernels.cluster import _CAPF, saddles_from_candidates
    from aprilgrid_tpu_torch.kernels.frontend import front_kernel_decimate, pad_raw
    from aprilgrid_tpu_torch.kernels.nms import cells_to_fields, nms_extract_raw
    from aprilgrid_tpu_torch.ops.frontend import gaussian_blur, hessian_response
    from aprilgrid_tpu_torch.ops.rochade import filter_and_compact

    sigma = CONSTANTS.blur_sigma
    raw_p, h, w, ch, u16 = pad_raw(frames)
    hh, wh = h // 2, w // 2
    _, half_p, tmin = front_kernel_decimate(raw_p, sigma, (h, w), ch, u16)
    thr = tmin.amin(-1) * CONSTANTS.response_threshold_ratio
    nargs = (half_p, thr, hh, wh, sigma, 4, 1.0)
    cells = nms_extract_raw(*nargs)
    fields, n_peaks = cells_to_fields(cells, _CAPF)
    half_s = filter_and_compact(
        saddles_from_candidates(fields), DEFAULT_CAPACITIES.max_saddles,
        CONSTANTS.saddle_k_ratio, DEFAULT_PARAMS.min_saddle_angle,
        DEFAULT_PARAMS.max_saddle_angle,
    )
    centers, valid = half_s.p * 2.0 + 0.5, half_s.valid
    rargs = (raw_p, centers, valid, h, w, ch, u16, sigma, 4, 1.0)
    resp = hessian_response(gaussian_blur(half_p[:1, 8 : 8 + hh, :wh], sigma))[0]
    fit = torch.zeros_like(resp, dtype=torch.bool)
    fit[4:-4, 4:-4] = resp[4:-4, 4:-4] < thr[0]    # masked inside the margin: a fit each
    hp, wp = half_p.shape[1] - 16, half_p.shape[2]
    tiles = torch.nn.functional.pad(fit, (0, wp - wh, 0, hp - hh))
    tiles = tiles.reshape(hp // 64, 64, wp // 64, 64).any(3).any(1)
    return dict(
        nargs=nargs, rargs=rargs, fits=int(fit.sum()), pixels=hp * wp,
        tiles_with_fits=int(tiles.sum()), tiles=tiles.numel(),
        peaks=int(n_peaks[0]), slots=int(valid[0].sum()), slot_rows=valid.shape[1],
    )


def phase_turbo_split(card: str, batch: int) -> dict:
    """``nms_extract_raw`` and ``sparse_refine_raw`` on two_boards at
    ``batch``, fed as the turbo path feeds them: device ms of each launch
    (torch.profiler, mean of 10 calls), the summed device ms and the count
    per call of the PyTorch operations each wrapper enqueues around its
    launches, the event time of the whole call three times over (the
    spread between calls of the same code), what the data asks (fits,
    64 x 64 tiles that hold one, peaks, refine slots per frame) and what
    ptxas reported for the kernels of ``nms.cu`` and ``refine.cu``."""
    import torch

    from aprilgrid_tpu_torch.kernels.nms import nms_extract_raw
    from aprilgrid_tpu_torch.kernels.refine import sparse_refine_raw

    res = _print_ptxas("nms.cu") + _print_ptxas("refine.cu")
    img = torch.from_numpy(read_png(DATA / "two_boards.png")).cuda()
    ch = turbo_chain(img[None].expand(batch, *img.shape).contiguous())
    calls = {
        "nms_extract_raw": lambda: nms_extract_raw(*ch["nargs"]),
        "sparse_refine_raw": lambda: sparse_refine_raw(*ch["rargs"]),
    }
    split = _profile_split(calls)
    for name, fn in calls.items():
        split[name]["event_ms"] = [_ms(fn, 20) for _ in range(3)]
    split["data"] = {k: v for k, v in ch.items() if k not in ("nargs", "rargs")}
    split["ptxas"] = res
    print(f"turbo split two_boards b{batch}, device ms per launch [{card}]: "
          f"{json.dumps(split)}", flush=True)
    return split


def phase_launch_split(card: str, batch: int) -> dict:
    """Device ms of each launch of ``nms_extract_raw`` at m0 and m8 and of
    the kernels that run the tile passes of ``csrc/tile.cuh`` with it (the
    front kernel, the decimating front kernel, the cluster kernel's raw and
    f32-luma entries) on two_boards at ``batch``, fed as their paths feed
    them: torch.profiler, mean of 10 calls, the wrappers' own PyTorch
    operations left out; the event ms of the NMS at m0 and m8; what ptxas
    reported for the kernels of ``nms.cu``, ``cluster.cu`` and
    ``frontend.cu``. Copied into a parent's tree and run there too, it
    compares two versions of these kernels within one call."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.cluster import cluster_rochade_raw
    from aprilgrid_tpu_torch.kernels.frontend import front_kernel, front_kernel_decimate, pad_raw
    from aprilgrid_tpu_torch.kernels.nms import nms_extract_raw

    sigma, ratio = CONSTANTS.blur_sigma, CONSTANTS.response_threshold_ratio
    for source in ("nms.cu", "cluster.cu", "frontend.cu"):
        _print_ptxas(source)
    img = torch.from_numpy(read_png(DATA / "two_boards.png")).cuda()
    frames = img[None].expand(batch, *img.shape).contiguous()
    nargs = turbo_chain(frames)["nargs"]
    half_p, hthr, hh, wh = nargs[:4]
    raw_p, h, w, ch, u16 = pad_raw(frames)
    thr = front_kernel(raw_p, sigma, (h, w), ch, u16)[1].amin(-1) * ratio
    calls = {
        "nms_extract_raw": lambda: nms_extract_raw(*nargs),
        "nms_extract_raw[m8]": lambda: nms_extract_raw(*nargs, merge=8),
        "front_kernel": lambda: front_kernel(raw_p, sigma, (h, w), ch, u16),
        "front_kernel_decimate": lambda: front_kernel_decimate(raw_p, sigma, (h, w), ch, u16),
        "cluster_rochade_raw": lambda: cluster_rochade_raw(raw_p, thr, h, w, ch, u16, sigma),
        "cluster_rochade_raw[luma_f32]": lambda: cluster_rochade_raw(
            half_p, hthr, hh, wh, 1, False, sigma, 4, 1.0, True),
    }
    split = {k: {n: ms for n, ms in v.items() if n != "at::"}
             for k, v in _profile_split(calls).items()}
    for name in ("nms_extract_raw", "nms_extract_raw[m8]"):
        split[name]["event_ms"] = _ms(calls[name], 20)
    print(f"launch split two_boards b{batch}, device ms per launch [{card}]: "
          f"{json.dumps(split)}", flush=True)
    return split


# (h, w) of the front kernel's synthetic frames: widths that are no
# multiple of its 64-column strip or of the 128-column padding, heights
# that are no multiple of its 64-row tile but one, a frame narrower than
# one strip
FRONT_SHAPES = ((100, 200), (64, 130), (37, 50), (129, 257))


def synthetic_raw_frames(mode: str, h: int, w: int, batch: int, seed: int = 0):
    """(batch, h, w[, 3]) raw frames of one of the front kernel's raw modes
    ("u8", "u16", "rgb") from ``seed``: uniform noise over the whole range,
    a tenth of the pixels at the top value (255 or 65535), a twentieth at 0
    and a saturated square in the top-left corner."""
    rng = np.random.default_rng(seed)
    top = 65535 if mode == "u16" else 255
    shape = (batch, h, w, 3) if mode == "rgb" else (batch, h, w)
    img = rng.integers(0, top + 1, shape)
    img[rng.random(shape) < 0.1] = top
    img[rng.random(shape) < 0.05] = 0
    img[:, : h // 3, : w // 3] = top
    return img.astype(np.uint16 if mode == "u16" else np.uint8)


def front_synthetic_check() -> None:
    """``front_kernel`` in both modes against its plain version on
    synthetic frames (``synthetic_raw_frames``) of every raw mode and of
    every shape of ``FRONT_SHAPES``, at batch 1 and 3: bit-equal."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.frontend import front_kernel, front_kernel_plain, pad_raw

    n = 0
    for mode in ("u8", "u16", "rgb"):
        for h, w in FRONT_SHAPES:
            for batch in (1, 3):
                frames = torch.from_numpy(
                    synthetic_raw_frames(mode, h, w, batch, seed=n)).cuda()
                raw_p, _, _, ch, u16 = pad_raw(frames)
                for emit_blur in (False, True):
                    args = (raw_p, CONSTANTS.blur_sigma, (h, w), ch, u16, emit_blur)
                    got, want = front_kernel(*args), front_kernel_plain(*args)
                    torch.cuda.synchronize()
                    if not all(g.shape == p.shape and torch.equal(g, p)
                               for g, p in zip(got, want)):
                        err = max((g.float() - p.float()).abs().max().item()
                                  for g, p in zip(got, want))
                        raise AssertionError(
                            f"front_kernel synthetic {mode} {h}x{w} b{batch} "
                            f"emit_blur={emit_blur}: max |diff| {err}")
                n += 1
    print(f"kernels front_kernel synthetic: u8/u16/rgb x {FRONT_SHAPES} x b1/b3 x "
          f"both modes ({2 * n} runs), noise with saturated values: bit-equal",
          flush=True)


def front_op_counts() -> dict:
    """Per output pixel of ``ag_front_kernel``'s kernel, worked out from
    ``csrc/frontend.cu`` and ``csrc/stencil.cuh`` for a 64 x 64 block:
    global load instructions per raw mode, shared-memory load/store
    instructions (``shared``; u8 gray adds ``lut`` table loads), f32
    operations of the stencil and integer divide/modulo pairs.

    ``front_kernel`` (the first version, later also the decimating entry's
    second launch; since removed): luma8 straight from raw byte by byte; the 72 x
    72 f32 luma staged element by element (byte loads again); horizontal
    pass 72 x 66, 7 loads + 1 store each; vertical pass 66 x 66, the same;
    Hessian 9 loads.
    ``front_tile_kernel``: 72 x 18 quads staged from one 4-, 8- or 12-byte
    load each, luma8 from the same bytes; per row 4 horizontal groups of 16
    outputs (6 + 4 16-byte accesses) and a tail of 2 (2 + 1); 17 x 11
    vertical runs of 6 rows of a quad, 12 + 6; 256 Hessian runs of 4 rows,
    6 x 2."""
    px = 64.0 * 64.0
    stage, hor, ver = 72 * 72 / px, 72 * 66 / px, 66 * 66 / px
    quads = 72 * 18 / px
    return {
        "front_kernel": {
            "global_loads": {"u8": 1 + stage, "u16": 1 + stage, "rgb": 3 * (1 + stage)},
            "shared": stage + 8 * hor + 8 * ver + 9,
            "f32": 14 * hor + 14 * ver + 13 + 1,
            "int_divmod_pairs": 1 + stage + hor + ver + 1,
        },
        "front_tile_kernel": {
            "global_loads": {"u8": quads, "u16": quads, "rgb": 3 * quads},
            "shared": (72 * 18 + 72 * 4 * 10 + 72 * 3 + 17 * 11 * 18 + 256 * 12) / px,
            "lut": 4 * quads,
            "f32": (72 * 66 + 68 * 66) * 14 / px + 13 + 1,
            "int_divmod_pairs": (72 * 18 + 72 * 5 + 17 * 11) / px,
        },
    }


def phase_front_split(card: str, batch: int) -> dict:
    """``front_kernel`` in both modes on the four golden images at
    ``batch``, as the exact path and the split chain feed it: bit-equal to
    the plain version first, then the device ms of each launch
    (torch.profiler, mean of 10 calls; the wrapper's ``strip_min.amin(-1)``
    under ``at::``), the event ms of the whole call three times over, the
    bytes bound, and what ptxas reported for the kernels of
    ``frontend.cu``; the per-pixel instruction counts of
    ``front_op_counts`` beside them."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.frontend import front_kernel, front_kernel_plain, pad_raw

    res = _print_ptxas("frontend.cu")
    split: dict = {}
    for name in GOLDEN:
        img = torch.from_numpy(read_png(DATA / f"{name}.png")).cuda()
        raw_p, h, w, ch, u16 = pad_raw(img[None].expand(batch, *img.shape).contiguous())
        calls = {}
        for emit_blur in (False, True):
            args = (raw_p, CONSTANTS.blur_sigma, (h, w), ch, u16, emit_blur)
            got, want = front_kernel(*args), front_kernel_plain(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, p) for g, p in zip(got, want)):
                raise AssertionError(f"front_kernel {name} emit_blur={emit_blur}: "
                                     "differs from its plain version")
            key = f"{name}[emit_blur]" if emit_blur else name
            calls[key] = lambda args=args: front_kernel(*args)
            out_bytes = sum(t.numel() * t.element_size() for t in got)
            split[key] = {"bound_ms": _bound_ms(
                raw_p.numel() * raw_p.element_size() + out_bytes,
                (5.0 + STENCIL_OPS) * got[-1].shape[0] * (raw_p.shape[1] - 16)
                * (raw_p.shape[2] // ch))}
        for key, times in _profile_split(calls).items():
            split[key].update(times)
            split[key]["event_ms"] = [_ms(calls[key], 20) for _ in range(3)]
    split["per_pixel"] = front_op_counts()
    split["ptxas"] = res
    print(f"front split b{batch}, bit-equal both modes, device ms per launch "
          f"[{card}]: {json.dumps(split)}", flush=True)
    return split


def _misaligned(t):
    """A contiguous copy of ``t`` whose data pointer lies one element past
    an aligned address: the kernels' vector loads may not be used on it."""
    import torch

    src = t.view(torch.int16) if t.dtype == torch.uint16 else t   # u16 copies via int16
    buf = src.new_empty(src.numel() + 1)
    out = buf[1:].view(src.shape)
    out.copy_(src)
    return out.view(t.dtype)


def front_decimate_synthetic_check() -> None:
    """``front_kernel_decimate`` against its plain version (``torch.equal``
    on luma8, the half plane and the tile minima) on synthetic frames
    (``synthetic_raw_frames``) of every raw mode and every shape of
    ``FRONT_SHAPES`` — (129, 257) has a luma8 grid taller and wider than
    twice the half plane's, (37, 50) an odd height whose last raw row
    belongs to no half row — at batch 1 and 3, and once per raw mode on a
    raw array whose data pointer is one element off alignment."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.frontend import (
        front_kernel_decimate,
        front_kernel_decimate_plain,
        pad_raw,
    )

    n = 0
    for mode in ("u8", "u16", "rgb"):
        for h, w in FRONT_SHAPES:
            for batch in (1, 3):
                frames = torch.from_numpy(
                    synthetic_raw_frames(mode, h, w, batch, seed=100 + n)).cuda()
                raw_p, _, _, ch, u16 = pad_raw(frames)
                runs = [("aligned", raw_p)]
                if (h, w) == FRONT_SHAPES[0] and batch == 3:
                    runs.append(("misaligned", _misaligned(raw_p)))
                for label, raw in runs:
                    args = (raw, CONSTANTS.blur_sigma, (h, w), ch, u16)
                    got = front_kernel_decimate(*args)
                    want = front_kernel_decimate_plain(*args)
                    torch.cuda.synchronize()
                    if not all(g.shape == p.shape and torch.equal(g, p)
                               for g, p in zip(got, want)):
                        err = [(g.float() - p.float()).abs().max().item()
                               for g, p in zip(got, want)]
                        raise AssertionError(
                            f"front_kernel_decimate synthetic {mode} {h}x{w} b{batch} "
                            f"{label}: max |diff| luma8/half/tile-min {err}")
                    n += 1
    print(f"kernels front_kernel_decimate synthetic: u8/u16/rgb x {FRONT_SHAPES} x "
          f"b1/b3 + a misaligned raw pointer per mode ({n} runs), noise with "
          "saturated values: bit-equal", flush=True)


def decimate_op_counts() -> dict:
    """Per half-resolution output pixel (four raw pixels) of
    ``ag_front_kernel_decimate``, worked out from ``csrc/frontend.cu`` and
    ``csrc/stencil.cuh`` as ``front_op_counts`` does: global load
    instructions per raw mode, shared-memory accesses, f32 operations of
    the stencil, IEEE divides per raw mode and integer divide/modulo pairs.

    The first design, two launches: ``decimate_kernel``, one thread per
    half slot, reads each raw pixel twice byte by byte (luma8 and the f32
    luma, an IEEE divide per u8/u16 element for the f32 luma and per u16
    element for luma8) and writes the f32 half plane; then
    ``front_kernel`` in MODE_F32 reads the half plane back (72 x 72 f32
    loads a block, element by element) and runs ``front_kernel``'s
    stencil. ``front_decimate_kernel``, one launch: 72 x 18 half quads
    staged from two rows of 8 raw pixels each (two 8- or 16-byte loads,
    RGB six 8-byte loads; u8 gray: 16 table loads; u16: the divide as a
    product and one FMA correction, 3 f32 operations a raw pixel; RGB: 3 a
    raw pixel), the mean in registers (4 f32 operations a half pixel), the
    64 x 16 own quads stored to the half plane (16 bytes) and luma8 (2 x 8
    bytes); then ``front_tile_kernel``'s passes. ``i2f``: integer-to-float
    conversions. The luma8 tail (rows at and beyond 2 * (h // 2), quads
    that reach w // 2) is left out: it touches the last half tile or strip
    only."""
    px = 64.0 * 64.0
    stage, hor, ver = 72 * 72 / px, 72 * 66 / px, 66 * 66 / px
    first = front_op_counts()["front_kernel"]
    tile = front_op_counts()["front_tile_kernel"]
    quads, own = 72 * 18 / px, 64 * 16 / px
    return {
        "front_decimate_kernel": {
            "global_loads": {"u8": 2 * quads, "u16": 2 * quads, "rgb": 6 * quads},
            "global_stores": 3 * own,
            "shared": tile["shared"],
            "lut": {"u8": 16 * quads, "u16": 0, "rgb": 0},
            "f32": {"u8": tile["f32"] + 16 * quads,
                    "u16": tile["f32"] + 16 * quads + 3 * 16 * quads,
                    "rgb": tile["f32"] + 16 * quads + 3 * 16 * quads},
            "i2f": {"u8": 0, "u16": 16 * quads, "rgb": 3 * 16 * quads},
            "ieee_divides": {"u8": 256 / px, "u16": 0, "rgb": 0},
            "int_divmod_pairs": (72 * 18 + 72 * 5 + 17 * 11) / px,
        },
        "decimate_kernel": {
            "global_loads": {"u8": 8, "u16": 8, "rgb": 24},
            "global_stores": 3,
            "ieee_divides": {"u8": 4, "u16": 8, "rgb": 0},
            "f32": {"u8": 3, "u16": 3, "rgb": 3 + 12},
        },
        "front_kernel[MODE_F32]": {
            "global_loads": stage,
            "shared": first["shared"],
            "f32": first["f32"],
            "int_divmod_pairs": stage + hor + ver + 1,
        },
    }


def phase_decimate_split(card: str, batch: int) -> dict:
    """``front_kernel_decimate`` on the four golden images at ``batch``:
    bit-equal to the plain version first, then the device ms of each launch
    (torch.profiler, mean of 10 calls; the wrapper's ``strip_min.amin(-1)``
    under ``at::``), the event ms of the whole call three times over, the
    bound, what ptxas reported for the kernels of ``frontend.cu`` and the
    per-pixel counts of ``decimate_op_counts``."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.frontend import (
        front_kernel_decimate,
        front_kernel_decimate_plain,
        pad_raw,
    )

    res = _print_ptxas("frontend.cu")
    split: dict = {}
    calls = {}
    for name in GOLDEN:
        img = torch.from_numpy(read_png(DATA / f"{name}.png")).cuda()
        raw_p, h, w, ch, u16 = pad_raw(img[None].expand(batch, *img.shape).contiguous())
        args = (raw_p, CONSTANTS.blur_sigma, (h, w), ch, u16)
        got, want = front_kernel_decimate(*args), front_kernel_decimate_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(g, p) for g, p in zip(got, want)):
            raise AssertionError(f"front_kernel_decimate {name}: differs from its plain version")
        calls[name] = lambda args=args: front_kernel_decimate(*args)
        l8, half_p, tmin = got
        px = batch * (raw_p.shape[1] - 16) * (raw_p.shape[2] // ch)
        hpx = batch * (half_p.shape[1] - 16) * half_p.shape[2]
        split[name] = {"bound_ms": _bound_ms(
            sum(t.numel() * t.element_size() for t in (raw_p, l8, half_p, tmin)),
            11.0 * px + STENCIL_OPS * hpx)}
    for name, times in _profile_split(calls).items():
        split[name].update(times)
        split[name]["event_ms"] = [_ms(calls[name], 20) for _ in range(3)]
    split["per_pixel"] = decimate_op_counts()
    split["ptxas"] = res
    print(f"decimate split b{batch}, bit-equal, device ms per launch [{card}]: "
          f"{json.dumps(split)}", flush=True)
    return split


# per bit of a decoded slot: the two affine sums (8), the two roundings
# and clamps (10), the bounds (2), min, max, threshold and invalid test (4)
DECODE_BIT_OPS = 24.0
# per slot: the affine's 6 x 8 products and sums, the corner gate
DECODE_SLOT_OPS = 96.0 + 24.0


def decode_slot_sets(family: str = "t36h11", seed: int = 0) -> list:
    """Inputs of ``decode_packed`` that no photograph gives, as numpy
    arrays ``(name, packed, luma8, qarr, (h, w), dcap)``: a 150 x 190 frame
    in a 160 x 256 noise plane, 120 random saddles a frame (some beyond the
    true frame inside the padding, every seventh on a rounding tie x.5) and
    four squares a frame painted with a code of the family under each of
    the four rotations. At dcap 24: frame 0 holds the four squares and 8
    random quads, the rest -1 padding; frame 1 is full (count = dcap);
    frame 2 has count 0 over real quads; frame 3 has corners outside the
    frame (negative, in the padding, 1e6 away, NaN). At dcap 192: random
    quads, counts 150 and 192. Noise bits tie in the scan all the time."""
    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.detector import pack_qarr
    from aprilgrid_tpu_torch.families import get_family
    from aprilgrid_tpu_torch.ops.decode import _rot_perms, decode_positions_px

    spec = get_family(family)
    nb = spec.edge * spec.edge
    src = nb - 1 - _rot_perms(spec.edge)      # position feeding bit i of rotation r
    rng = np.random.default_rng(seed)
    h, w, hp, wp, n = 150, 190, 160, 256, 120

    def frames(bsz):
        luma8 = rng.integers(0, 256, (bsz, hp, wp)).astype(np.uint8)
        pts = rng.uniform((-3.0, -3.0), (w + 6.0, h + 6.0), (bsz, n, 2))
        pts[:, ::7] = np.floor(pts[:, ::7]) + 0.5
        packed = np.zeros((bsz, n + 1, 4), np.float32)
        packed[:, :n, :2] = pts
        packed[:, :n, 3] = 1.0
        packed[:, n, :3] = (0.0, 0.0, 5.0)           # a counters row
        return packed, luma8

    def random_quads(count):
        return rng.integers(0, n - 16, (count, 4))

    packed, luma8 = frames(4)
    squares = np.zeros((4, 4, 4), np.int64)          # frame, rotation, corner row
    for f in range(4):
        for r, (x0, y0) in enumerate(((10, 10), (110, 10), (10, 90), (110, 90))):
            side = 40.0
            corners = np.array([(x0, y0), (x0, y0 + side), (x0 + side, y0 + side),
                                (x0 + side, y0)], np.float32) + rng.uniform(0, 1, 2)
            code = int(spec.codes[rng.integers(spec.num_codes)])
            msb = np.zeros(nb, np.int64)
            msb[src[r]] = (code >> np.arange(nb)) & 1
            pos = decode_positions_px(corners, spec, CONSTANTS.decode_margin, w, h)
            at = np.copysign(np.floor(np.abs(pos) + 0.5), pos).astype(np.int64)
            luma8[f, at[:, 1], at[:, 0]] = 255 * msb
            rows = n - 16 + 4 * r + np.arange(4)
            packed[f, rows, :2] = corners
            squares[f, r] = rows
    dcap = 24
    quads = np.full((4, dcap, 4), -1, np.int64)
    counts = np.array([12, dcap, 0, 10])
    quads[0, :4] = squares[0]
    quads[0, 4:12] = random_quads(8)
    quads[1, :4] = squares[1]
    quads[1, 4:] = random_quads(dcap - 4)
    quads[2, :4] = squares[2]
    quads[2, 4:16] = random_quads(12)
    quads[3, :10] = random_quads(10)
    quads[3, 4:8] = squares[3]
    far = np.array([(-3.2, 7.0), (w + 0.4, 20.0), (1e6, 5.0), (30.0, -1e6),
                    (np.nan, 40.0), (50.0, hp - 1.0), (wp - 1.0, h - 0.5)], np.float32)
    packed[3, :len(far), :2] = far
    quads[3, :4] = [[0, 10, 11, 12], [1, 13, 14, 15], [2, 3, 16, 17], [4, 5, 6, 18]]
    sets = [("dcap24", packed, luma8, quads, counts, dcap)]
    packed, luma8 = frames(2)
    sets.append(("dcap192", packed, luma8, random_quads(2 * 192).reshape(2, 192, 4),
                 np.array([150, 192]), 192))
    return [(f"{family} {name}", packed, luma8, pack_qarr(quads, counts), (h, w), dc)
            for name, packed, luma8, quads, counts, dc in sets]


def _bits_equal(a, b) -> bool:
    """Bit for bit (NaN and -0 included) equality of two f32 tensors."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def decode_checks(batch: int) -> dict:
    """The decode kernels against their plain versions on CUDA tensors:
    ``hamming_scan`` on ``batch`` frames x 384 random rows vs t36h11 with
    planted exact hits and ties; ``decode_packed`` bit for bit on the
    quads | count of every pass the facade decodes on the four golden
    images at ``batch`` (its own search on the card) and on
    ``decode_slot_sets`` of t36h11, t16h5 and t25h9; returns their
    records (error, times, bound; the decode's at two_boards's first
    pass)."""
    import torch

    from aprilgrid_tpu_torch import TagDetector
    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.detector import pack_qarr
    from aprilgrid_tpu_torch.families import get_family
    from aprilgrid_tpu_torch.kernels.decode import (
        decode_packed,
        decode_packed_plain,
        hamming_scan,
        hamming_scan_plain,
    )

    dev = torch.device("cuda")
    spec = get_family("t36h11")
    codes = spec.code_bits_tensor(dev)
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 2, (batch, 4 * 96, codes.shape[1])).astype(np.float32)
    cb = spec.code_bits.astype(np.float32)
    rows[0, 0] = cb[17]          # exact hits, and ties broken by index
    rows[1, 1] = cb[0]
    rows[2, 2:6] = cb[5]
    rots = torch.from_numpy(rows).to(dev)
    m, i = hamming_scan(rots, codes)
    pm, pi = hamming_scan_plain(rots, codes)
    torch.cuda.synchronize()
    if not (torch.equal(m, pm) and torch.equal(i, pi)):
        raise AssertionError("hamming_scan differs from its plain version")
    print(f"kernels hamming_scan {batch}x384x36 vs t36h11: exact", flush=True)
    n_rows, n_codes, nb = rots.shape[0] * rots.shape[1], codes.shape[0], codes.shape[1]
    rec = {"hamming": dict(
        err=0.0, ms=_ms(lambda: hamming_scan(rots, codes), 50),
        plain_ms=_ms(lambda: hamming_scan_plain(rots, codes), 5),
        # 4-byte reads of rows and table, 8-byte writes; XOR + popcount +
        # compare per (row, code), counted at the f32 rate
        bound=_bound_ms(4.0 * (n_rows + n_codes) * nb + 8.0 * n_rows,
                        3.0 * n_rows * n_codes),
    )}

    c = CONSTANTS
    gates = (c.decode_margin, c.valid_brightness_threshold, c.max_invalid_bit,
             c.min_contrast)
    det = TagDetector("t36h11", device="cuda")
    passes = []

    def grab(packed, luma8, quads, counts, hw, _orig=det._decode):
        passes.append((packed, luma8, torch.from_numpy(pack_qarr(quads, counts)).to(dev),
                       hw, quads.shape[1]))
        return _orig(packed, luma8, quads, counts, hw)

    det._decode = grab
    said = []
    for name in GOLDEN:
        first = len(passes)
        det.detect_batch(np.stack([read_png(DATA / f"{name}.png")] * batch))
        for packed, luma8, qarr, hw, dc in passes[first:]:
            got = decode_packed(packed, luma8, qarr, hw, dc, spec, *gates)
            want = decode_packed_plain(packed, luma8, qarr, hw, dc, spec, *gates)
            torch.cuda.synchronize()
            if not _bits_equal(got, want):
                raise AssertionError(f"decode_packed {name} (dcap {dc}): differs from "
                                     "its plain version")
            said.append(f"{name} dcap {dc} {int(got[..., 1].sum())} tags")
        if name == "two_boards":
            args = passes[first] + (spec, *gates)
    print(f"kernels decode_packed on {len(passes)} passes of the facade at b{batch}: "
          f"bit-equal to the plain version; " + ", ".join(said), flush=True)
    said = []
    for family in ("t36h11", "t16h5", "t25h9"):
        fspec = get_family(family)
        for name, packed, luma8, qarr, hw, dc in decode_slot_sets(family):
            t = [torch.from_numpy(a).to(dev) for a in (packed, luma8, qarr)]
            got = decode_packed(*t, hw, dc, fspec, *gates)
            want = decode_packed_plain(*t, hw, dc, fspec, *gates)
            torch.cuda.synchronize()
            if not _bits_equal(got, want):
                raise AssertionError(f"decode_packed synthetic {name}: differs from its "
                                     "plain version")
            said.append(f"{name} {int(got[..., 1].sum())} tags")
    print("kernels decode_packed synthetic slot sets: bit-equal to the plain version; "
          + ", ".join(said), flush=True)

    packed, luma8, qarr, _, dc = args[:5]
    slots = qarr.shape[0] * dc
    rec["decode"] = dict(
        err=0.0, ms=_ms(lambda: decode_packed(*args), 50),
        plain_ms=_ms(lambda: decode_packed_plain(*args), 5),
        # qarr, the four gathered corners (8 B each), the sampled bytes and
        # the table read once, the rows written once; 3 operations per
        # (slot, rotation, code) and the per-bit and per-slot work
        bound=_bound_ms(qarr.numel() * 4 + slots * (4 * 8 + nb + 40) + n_codes * 8,
                        slots * (12.0 * n_codes + DECODE_BIT_OPS * nb + DECODE_SLOT_OPS)),
        slots=slots,
    )
    return rec


def _device_events(prof, annotation: str) -> list:
    """The device operations of a torch.profiler session, by start (the
    device track's copy of the ``annotation`` ranges left out)."""
    return sorted((ev for ev in prof.events()
                   if "CUDA" in str(getattr(ev, "device_type", ""))
                   and ev.name != annotation
                   and not getattr(ev, "is_user_annotation", False)),
                  key=lambda ev: ev.time_range.start)


def phase_decode_split(card: str, batch: int) -> dict:
    """The decode of each board pass (the facade's ``_decode``, its
    download included) on two_boards at ``batch``, exact and turbo NMS:
    per call the host wall ms (host clock, a run without the profiler),
    then in one torch.profiler session the device kernels, memcpys and
    memsets it issues, the device's busy ms inside it and its idle gap
    before the scan (the end of the previous device operation to the
    start of the kernel that scans the code table). Then 10 launches
    each, their mean device ms: of ``decode_packed`` on the exact path's
    first pass in full, with a table of one code, on one slot and on one
    slot with one code (the launch floor); of ``hamming_scan`` on the
    rows of the smoke's scan (``batch`` frames x 384 rows vs t36h11) in
    full, of one row, of one code and of one row and one code. What ptxas
    reported for the kernels of ``decode.cu``."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from aprilgrid_tpu_torch import TagDetector
    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.detector import pack_qarr
    from aprilgrid_tpu_torch.families import get_family
    from aprilgrid_tpu_torch.kernels.decode import decode_packed, hamming_scan

    res = _print_ptxas("decode.cu")
    img = read_png(DATA / "two_boards.png")
    frames = np.stack([img] * batch)
    os.environ["AG_TURBO_NMS"] = "1"
    dets = {"exact": TagDetector("t36h11", device="cuda"),
            "turbo-nms": TagDetector("t36h11", device="cuda", decimate=True)}
    walls: dict = {}
    first: dict = {}
    for label, det in dets.items():
        def timed(*a, _orig=det._decode, _label=label):
            first.setdefault(_label, a)                # the path's first pass
            t0 = time.perf_counter()
            with record_function("ag_decode"):
                out = _orig(*a).cpu()
            walls.setdefault(_label, []).append((time.perf_counter() - t0) * 1e3)
            return out
        det._decode = timed
        det.detect_batch(frames)                       # warm-up
    walls.clear()
    for det in dets.values():
        det.detect_batch(frames)
    host_ms = {k: list(v) for k, v in walls.items()}
    walls.clear()
    codes = get_family("t36h11").code_bits_tensor(torch.device("cuda"))
    rng = np.random.default_rng(3)
    rots = torch.from_numpy(rng.integers(0, 2, (batch, 4 * 96, codes.shape[1]))
                            .astype(np.float32)).cuda()
    shapes = {
        "full": (rots, codes), "one_row": (rots[:1, :1].contiguous(), codes),
        "one_code": (rots, codes[:1].contiguous()),
        "floor": (rots[:1, :1].contiguous(), codes[:1].contiguous()),
    }
    spec = get_family("t36h11")
    one = dataclasses.replace(spec, codes=spec.codes[:1], code_bits=spec.code_bits[:1])
    packed, luma8, quads, counts, hw = first["exact"]
    dc = quads.shape[1]
    qarr = torch.from_numpy(pack_qarr(quads, counts)).cuda()
    q1 = torch.cat([qarr[:1, :4], torch.ones_like(qarr[:1, :1])], 1)
    c = CONSTANTS
    gates = (c.decode_margin, c.valid_brightness_threshold, c.max_invalid_bit, c.min_contrast)
    dshapes = {
        "full": (packed, luma8, qarr, hw, dc, spec),
        "one_code": (packed, luma8, qarr, hw, dc, one),
        "one_slot": (packed[:1], luma8[:1], q1, hw, 1, spec),
        "floor": (packed[:1], luma8[:1], q1, hw, 1, one),
    }
    for a in shapes.values():
        hamming_scan(*a)
    for a in dshapes.values():
        decode_packed(*a, *gates)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for det in dets.values():
            det.detect_batch(frames)
        torch.cuda.synchronize()
        for a in shapes.values():
            for _ in range(10):
                hamming_scan(*a)
            torch.cuda.synchronize()
        for a in dshapes.values():
            for _ in range(10):
                decode_packed(*a, *gates)
            torch.cuda.synchronize()
    del os.environ["AG_TURBO_NMS"]
    dev = _device_events(prof, "ag_decode")
    wins = sorted((ev.time_range for ev in prof.events() if ev.name == "ag_decode"
                   and "CPU" in str(getattr(ev, "device_type", ""))),
                  key=lambda tr: tr.start)
    labels = [k for k, v in walls.items() for _ in v]
    if [k for k, v in host_ms.items() for _ in v] != labels or len(wins) != len(labels):
        raise AssertionError(f"decode split: {len(wins)} traced calls, {host_ms}, {walls}")
    # a call's runtime calls (launches, copies) are those in its range on
    # the host's clock; its device operations those whose runtime call (the
    # same correlation id) lies in that range, as the device clock is
    # aligned to the host's only so far; an operation without one counts
    # where it starts, within 0.1 ms of the range (the host search keeps
    # other device work milliseconds away)
    api = [ev for ev in prof.events() if ev.name.startswith(("cudaLaunchKernel",
                                                              "cuLaunchKernel",
                                                              "cudaMemcpy", "cudaMemset"))]
    runtime = {ev.id: ev.time_range.start for ev in api}
    launched = [runtime.get(ev.id) for ev in dev]

    def within(i, win):
        if launched[i] is not None:
            return win.start <= launched[i] <= win.end
        return win.start - 100 <= dev[i].time_range.start <= win.end + 100

    calls = []
    for label, ms, win in zip(labels, [m for v in host_ms.values() for m in v], wins):
        inside = [i for i in range(len(dev)) if within(i, win)]
        names = [dev[i].name for i in inside]
        issued = [ev.name for ev in api if win.start <= ev.time_range.start <= win.end]
        scan = [i for i in inside if re.search(r"hamming_scan_kernel|decode_packed_kernel",
                                                dev[i].name)]
        if not scan:
            raise AssertionError(f"decode split: no scan kernel in a {label} decode: "
                                 f"{names}, {launched.count(None)} of {len(dev)} device "
                                 "operations not linked")
        prev_end = max((ev.time_range.end for ev in dev[: scan[0]]), default=win.start)
        calls.append({
            "path": label, "host_ms": ms, "traced_host_ms": win.elapsed_us() / 1e3,
            "launch_calls": sum(n.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                                for n in issued),
            "copy_calls": sum(n.startswith(("cudaMemcpy", "cudaMemset")) for n in issued),
            "kernels": sum(not n.startswith(("Memcpy", "Memset")) for n in names),
            "memcpy_htod": sum(n.startswith("Memcpy HtoD") for n in names),
            "memcpy_dtoh": sum(n.startswith("Memcpy DtoH") for n in names),
            "memset": sum(n.startswith("Memset") for n in names),
            "busy_ms": sum(dev[i].time_range.elapsed_us() for i in inside) / 1e3,
            "unlinked": sum(launched[i] is None for i in inside),
            "gap_before_scan_ms": max(dev[scan[0]].time_range.start - prev_end, 0) / 1e3,
            "scan_ms": [dev[i].time_range.elapsed_us() / 1e3 for i in scan],
        })
    for cl in calls:
        if (cl["launch_calls"], cl["copy_calls"], cl["kernels"], cl["memcpy_htod"],
                cl["memcpy_dtoh"]) != (1, 2, 1, 1, 1):
            raise AssertionError(f"a pass's decode is not one upload, one kernel and one "
                                 f"download: {cl}")

    def probe(kernel, names):
        evs = [ev for ev in dev if kernel in ev.name][-10 * len(names):]
        ms = [ev.time_range.elapsed_us() / 1e3 for ev in evs]
        return {k: sum(ms[10 * i : 10 * i + 10]) / 10 for i, k in enumerate(names)}

    split = {
        "calls": calls,
        "first_pass": {"dcap": dc, "slots": int(qarr.shape[0] * dc),
                       "quads": int(counts.sum())},
        "decode_probe_device_ms": probe("decode_packed_kernel", dshapes),
        "decode_probe_event_ms": _ms(lambda: decode_packed(*dshapes["full"], *gates), 50),
        "hamming_probe_device_ms": probe("hamming_scan_kernel", shapes),
        "hamming_probe_event_ms": _ms(lambda: hamming_scan(rots, codes), 50),
        "ptxas": res,
    }
    print(f"decode split two_boards b{batch} [{card}]: {json.dumps(split)}", flush=True)
    return split


def nms_tie_break_check() -> None:
    """The NMS kernel on a plane with planted equal responses: a 3-pixel
    checkerboard maps onto itself under shifts by (3, +-3), so pixels 3
    apart tie exactly, in chains down the plane; the kernel must keep the
    plain version's peaks (the scan-first plateau pixel of each window)."""
    import torch

    from aprilgrid_tpu_torch.kernels.frontend import _response_tile_min, pad_half
    from aprilgrid_tpu_torch.kernels.nms import nms_extract_raw, nms_extract_raw_plain

    h, w = 96, 128
    r = torch.arange(h, device="cuda")[:, None]
    c = torch.arange(w, device="cuda")[None, :]
    plane = (((r // 3 + c // 3) % 2).to(torch.float32) * 0.6 + 0.2)[None]
    half_p = pad_half(plane)
    thr = _response_tile_min(half_p, 1.5, (h, w)).amin(-1) * 0.05
    cells = nms_extract_raw(half_p, thr, h, w)
    pcells = nms_extract_raw_plain(half_p, thr, h, w)
    torch.cuda.synchronize()
    n = int((cells[:, 5] > 0.5).sum())
    if not torch.equal(cells, pcells) or n != 20:
        raise AssertionError(
            f"nms tie-break: kernel {n} peaks, plain "
            f"{int((pcells[:, 5] > 0.5).sum())} (20 expected), max |diff| "
            f"{(cells - pcells).abs().max().item()}"
        )
    print("kernels nms_extract_raw tie-break plane 96x128: 20 peaks, = plain", flush=True)


def nms_synthetic_check() -> None:
    """``nms_extract_raw`` against its plain version on the synthetic
    planes taken as luma planes, a different mask in each frame of one
    batch, at a shape (250 x 380) that is no multiple of the 64 x 64 tile:
    a fit at every pixel inside the margin (whole), none (empty; the
    blur flattens the checkerboard to the same), long blobs and irregular
    ones that straddle tile corners and the 4-pixel margin (spiral, comb,
    noise), a true saddle every 8 pixels, on the tile corners too
    (lattice); and at 194 x 322, whose last tile and strip end 2 pixels
    past the plane, so that their rows and columns of the margin's far
    edge lie inside the tile. Each at m0 and m8 (the merge's launch (a)
    writes the relay bits), on the ``pad_half`` plane and on a copy one
    element off alignment (launch (a) stages it element by element). The
    cell grids must be bit-equal."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.frontend import pad_half
    from aprilgrid_tpu_torch.kernels.nms import nms_extract_raw, nms_extract_raw_plain
    from aprilgrid_tpu_torch.ops.frontend import gaussian_blur, hessian_response

    for h, w in ((250, 380), (194, 322)):
        names, planes, thr = synthetic_blur_planes(h, w)
        planes, thr = torch.from_numpy(planes).cuda(), torch.from_numpy(thr).cuda()
        b = planes.shape[0]
        half_p = pad_half(planes)
        # lower shares than the cluster check's: wide blobs, a fit at each pixel
        rthr = synthetic_luma_thresholds(names, half_p, thr, h, w, spiral=0.002,
                                         comb=0.002, noise=0.01)
        peaks = {}
        for merge in (0, 8):
            for label, plane in (("aligned", half_p), ("misaligned", _misaligned(half_p))):
                cells = nms_extract_raw(plane, rthr, h, w, merge=merge)
                pcells = nms_extract_raw_plain(plane, rthr, h, w, merge=merge)
                torch.cuda.synchronize()
                peaks[merge] = (cells[:, 5] > 0.5).sum((1, 2)).tolist()
                if not torch.equal(cells, pcells):
                    ppeaks = (pcells[:, 5] > 0.5).sum((1, 2)).tolist()
                    raise AssertionError(
                        f"nms_extract_raw synthetic {h}x{w} m{merge} {label}: peaks "
                        f"{dict(zip(names, peaks[merge]))} vs plain "
                        f"{dict(zip(names, ppeaks))}, max |diff| "
                        f"{(cells - pcells).abs().max().item()}")
        resp = hessian_response(gaussian_blur(planes, CONSTANTS.blur_sigma))
        fits = (resp < rthr[:, None, None])[:, 4:-4, 4:-4].sum((1, 2)).tolist()
        got = dict(zip(names, zip(fits, peaks[0], peaks[8])))
        if (got["whole"][0] != (h - 8) * (w - 8) or got["empty"] != (0, 0, 0)
                or min(got[n][1] for n in ("spiral", "comb", "lattice", "noise")) <= 0):
            raise AssertionError(f"nms_extract_raw synthetic {h}x{w}: (fits, peaks m0, "
                                 f"m8) {got}")
        print(f"kernels nms_extract_raw synthetic {h}x{w} b{b}: cell grids bit-equal at m0 "
              "and m8, aligned and misaligned; " + ", ".join(
                  f"{n} {f} fits/{p0} peaks m0/{p8} m8" for n, (f, p0, p8) in got.items()),
              flush=True)


def refine_slot_sets(c0: np.ndarray, v0: np.ndarray, h: int, w: int, seed: int = 0):
    """Four slot sets for one (h, w) frame from its survivors (``c0``
    (K, 2) f32 centres, ``v0`` (K,) bool), made from ``seed`` with numpy:
    ``(names, centers (4, K, 2) f32, valid (4, K) bool)``. *every*: all K
    slots valid, the survivors and centres spread over and 12 pixels
    around the image; *none*: the same centres, no slot valid;
    *interleaved*: survivors in the odd slots, the even slots invalid but
    holding centres, so the valid slots are no prefix; *halves*: centres
    on x.5 either side of the rounded survivors (the rounding's ties),
    negative, on both sides of the 4-pixel bound, and far outside."""
    rng = np.random.default_rng(seed)
    k = c0.shape[0]
    live = c0[v0]
    spread = np.stack([rng.uniform(-12, w + 12, k), rng.uniform(-12, h + 12, k)], 1)
    every = np.where(v0[:, None], c0, spread.astype(np.float32))
    n = min(len(live), k // 2)
    inter, vi = every.copy(), np.zeros(k, bool)
    inter[1 : 2 * n : 2] = live[:n]
    vi[1 : 2 * n : 2] = True
    base = np.floor(live[: k // 4] + 0.5)
    edge = [[-0.5, -0.5], [-1.5, 3.5], [-7.3, 20.0], [0.49, 0.5], [3.5, 3.5],
            [3.49, 4.0], [4.0, 3.5], [w - 4.5, h - 4.5], [w - 5.5, h - 5.5],
            [w - 5.0, h - 4.51], [w + 3.0, h + 100.0], [1e6, -1e6],
            [w - 1.0, h - 1.0], [w - 0.5, 10.0]]
    rows = np.concatenate([base + 0.5, base - 0.5, np.array(edge)])[:k]
    halves, vh = np.zeros_like(c0), np.arange(k) < len(rows)
    halves[: len(rows)] = rows
    centers = np.stack([every, every, inter, halves]).astype(np.float32)
    valid = np.stack([np.ones(k, bool), np.zeros(k, bool), vi, vh])
    return ("every", "none", "interleaved", "halves"), centers, valid


def refine_synthetic_check() -> None:
    """``sparse_refine_raw`` against its plain version on the slot sets of
    ``refine_slot_sets``, one set per frame of a 4-frame batch, on a u8
    gray (EuRoC), a u16 gray (TUM_VI) and an RGB (two_boards) image: the
    same ``valid``, and positions, k, theta and phi bit-equal on every
    slot that went in valid."""
    import torch

    from aprilgrid_tpu_torch.kernels.refine import (
        sparse_refine_raw,
        sparse_refine_raw_plain,
    )

    for name in ("EuRoC", "TUM_VI", "two_boards"):
        img = torch.from_numpy(read_png(DATA / f"{name}.png")).cuda()
        frames = img[None].expand(4, *img.shape).contiguous()
        rargs = turbo_chain(frames)["rargs"]
        raw_p, c0, v0, h, w = rargs[:5]
        sets, centers, valid = refine_slot_sets(c0[0].cpu().numpy(), v0[0].cpu().numpy(), h, w)
        centers, valid = torch.from_numpy(centers).cuda(), torch.from_numpy(valid).cuda()
        rs = sparse_refine_raw(raw_p, centers, valid, *rargs[3:])
        prs = sparse_refine_raw_plain(raw_p, centers, valid, *rargs[3:])
        torch.cuda.synchronize()
        said = []
        for i, s in enumerate(sets):
            v = valid[i]
            err = max(((getattr(rs, k)[i] - getattr(prs, k)[i])[v].abs().max().item()
                       for k in ("p", "k", "theta", "phi")), default=0.0) if v.any() else 0.0
            same = all(torch.equal(getattr(rs, k)[i][v], getattr(prs, k)[i][v])
                       for k in ("p", "k", "theta", "phi"))
            acc = int(rs.valid[i].sum())
            if not (torch.equal(rs.valid[i], prs.valid[i]) and same) or (acc > 0) == (s == "none"):
                raise AssertionError(
                    f"sparse_refine_raw synthetic {name} {s}: {acc} accepted vs "
                    f"{int(prs.valid[i].sum())} by the plain version, max |diff| {err}")
            said.append(f"{s} {int(v.sum())} valid/{acc} accepted")
        print(f"kernels sparse_refine_raw synthetic {name} {tuple(img.shape)} "
              f"{valid.shape[1]} slots: bit-equal to the plain version; " + ", ".join(said),
              flush=True)


def _held_run(det, name: str, img, ref: dict, batch: int, card: str, label: str,
              golden: int | None = None) -> None:
    """One measured ``detect_batch`` on ``batch`` copies of ``img``: golden
    count (``GOLDEN[name]`` unless given) on every frame, ID set equal to
    ``ref``'s, corners within 1e-3 px of it; prints the time."""
    import torch

    golden = GOLDEN[name] if golden is None else golden

    frames = np.stack([img] * batch)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    res = det.detect_batch(frames)
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1)
    err = 0.0
    for i, tags in enumerate(res):
        if len(tags) != golden:
            raise AssertionError(f"{label} {name} frame {i}: {len(tags)} tags, golden {golden}")
        if set(tags) != set(ref):
            raise AssertionError(f"{label} {name} frame {i}: ID set differs from the CPU run")
        err = max(err, max(
            float(np.abs(np.asarray(tags[t]) - np.asarray(ref[t])).max()) for t in tags
        ))
    if err > 1e-3:
        raise AssertionError(f"{label} {name}: corners {err} px from the CPU run")
    print(f"e2e {label} {name} {img.shape} b{batch}: {golden} tags on every frame, "
          f"= CPU run (max corner diff {err:.2e} px); {ms:.2f} ms, "
          f"{batch / ms * 1e3:.1f} frames/s [{card}]", flush=True)


@contextlib.contextmanager
def _decoded_passes():
    """Counts, in ``[n]``, the board passes whose search returns quads
    while the block runs: the facade decodes exactly those passes."""
    from aprilgrid_tpu_torch import native

    search, n = native.find_board_batch, [0]

    def counted(*a, **kw):
        quads, counts = search(*a, **kw)
        n[0] += bool(counts.any())
        return quads, counts

    native.find_board_batch = counted
    try:
        yield n
    finally:
        native.find_board_batch = search


def _one_decode_per_pass(label: str, passes: int) -> int:
    """The ``decode_packed`` launches of a path's held runs, one per pass
    with quads and no ``hamming_scan`` launch."""
    from aprilgrid_tpu_torch.kernels import LAUNCHES

    if passes <= 0 or LAUNCHES["decode_packed"] != passes or LAUNCHES["hamming_scan"]:
        raise AssertionError(
            f"{label}: {LAUNCHES['decode_packed']} decode_packed and "
            f"{LAUNCHES['hamming_scan']} hamming_scan launches for {passes} passes "
            "with quads (expected one decode_packed per pass, no hamming_scan)")
    return passes


def phase_end_to_end(card: str, batch: int) -> dict:
    """detect_batch on the golden images on the card, the exact path then
    the turbo path; returns each kernel's launch count in the measured
    runs of its own path (the counts are zeroed before a path and read
    after it)."""
    import torch

    from aprilgrid_tpu_torch import TagDetector
    from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
    from aprilgrid_tpu_torch.kernels import LAUNCHES, reset_launches
    from aprilgrid_tpu_torch.pipeline import frontend_packed

    imgs = {n: read_png(DATA / f"{n}.png") for n in GOLDEN}

    # -- exact path
    gpu = TagDetector("t36h11", device="cuda")
    cpu = TagDetector("t36h11", device="cpu")
    refs = {n: cpu.detect(img) for n, img in imgs.items()}
    for n, img in imgs.items():
        gpu.detect_batch(np.stack([img] * batch))  # warm-up (allocator, build)
    torch.cuda.synchronize()
    reset_launches()
    with _decoded_passes() as passes:
        for n, img in imgs.items():
            _held_run(gpu, n, img, refs[n], batch, card, "exact")
    launches = {k: LAUNCHES[k] for k in ("front_kernel", "cluster_rochade_raw")}
    launches["decode_packed"] = _one_decode_per_pass("exact path", passes[0])

    # -- turbo path, both extraction variants (AG_TURBO_NMS is the policy
    # knob the facade reads)
    tgpu = TagDetector("t36h11", device="cuda", decimate=True)
    tcpu = TagDetector("t36h11", device="cpu", decimate=True)
    trefs = {}
    for variant, label in (("1", "turbo-nms"), ("0", "turbo-drain")):
        os.environ["AG_TURBO_NMS"] = variant
        for n in TURBO:
            trefs[label, n] = tcpu.detect(imgs[n])
            tgpu.detect_batch(np.stack([imgs[n]] * batch))  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    with _decoded_passes() as passes:
        for variant, label in (("1", "turbo-nms"), ("0", "turbo-drain")):
            os.environ["AG_TURBO_NMS"] = variant
            for n in TURBO:
                _held_run(tgpu, n, imgs[n], trefs[label, n], batch, card, label)
    del os.environ["AG_TURBO_NMS"]
    for k in ("front_kernel_decimate", "cluster_rochade_raw[luma_f32]",
              "nms_extract_raw", "sparse_refine_raw"):
        launches[k] = LAUNCHES[k]
    turbo_decode = _one_decode_per_pass("turbo path", passes[0])

    # decimate="auto" leaves a frame under 2 MP to the exact path
    auto = TagDetector("t36h11", device="cuda", decimate="auto")
    if auto.detect(imgs["EuRoC"]) != gpu.detect(imgs["EuRoC"]):
        raise AssertionError('decimate="auto" on EuRoC differs from the exact path')
    print('e2e decimate="auto" on EuRoC (0.36 MP) = the exact path', flush=True)
    print(f"launches exact path {launches['front_kernel']}/"
          f"{launches['cluster_rochade_raw']}/{launches['decode_packed']} "
          f"(front/cluster/decode, one decode per pass with quads, no hamming_scan); "
          f"turbo path {launches['front_kernel_decimate']}/"
          f"{launches['nms_extract_raw']}/{launches['cluster_rochade_raw[luma_f32]']}/"
          f"{launches['sparse_refine_raw']}/{turbo_decode} "
          "(front_decimate/nms/cluster[luma_f32]/refine/decode)", flush=True)

    # the front-end's share of a chunk: device time of frontend_packed alone
    frames = torch.from_numpy(np.stack([imgs["two_boards"]] * batch)).cuda()
    for label, dec, nms in (("exact", False, None), ("turbo-nms", True, True),
                            ("turbo-drain", True, False)):
        ms = _ms(lambda: frontend_packed(frames, DEFAULT_PARAMS, CONSTANTS,
                                         DEFAULT_CAPACITIES, dec, nms), 5)
        print(f"front-end only {label} two_boards b{batch}: {ms:.3f} ms [{card}]",
              flush=True)
    return launches


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


RUNTIME_MODES = (("exact", False, None), ("turbo-nms", True, "1"),
                 ("turbo-drain", True, "0"))


def runtime_sync_check(card: str) -> None:
    """The runtime's dispatches on a warmed CUDA chunk must not make the
    host wait for the card (a wait kills the lookahead and leaves the
    results right): one exact and one turbo ``frontend_packed`` with the
    start of its saddle copy, one ``_decode`` and the tail's concat, each
    under ``torch.cuda.set_sync_debug_mode("error")``. Every site is tried
    before a failure is raised."""
    import torch

    from aprilgrid_tpu_torch import TagDetector, native
    from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
    from aprilgrid_tpu_torch.detector import _HostCopy
    from aprilgrid_tpu_torch.pipeline import frontend_packed

    img = read_png(DATA / "two_boards.png")
    frames = torch.from_numpy(np.stack([img] * 32)).cuda()
    hw = img.shape[:2]
    cfg = (DEFAULT_PARAMS, CONSTANTS, DEFAULT_CAPACITIES)
    cap = (2 * DEFAULT_CAPACITIES.grid_radius + 1) ** 2
    det = TagDetector("t36h11", device="cuda")
    synced = []

    def no_sync(what, fn):
        torch.cuda.synchronize()
        fn()  # warm: allocator, tables, pinned blocks
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        except RuntimeError as e:
            synced.append(f"{what}: {e}")
            return None
        finally:
            torch.cuda.set_sync_debug_mode(0)

    for label, dec, nms in (("exact", False, None), ("turbo-nms", True, True)):
        def dispatch(dec=dec, nms=nms):
            packed, luma8 = frontend_packed(frames, *cfg, dec, nms)
            return packed, luma8, _HostCopy(packed)
        out = no_sync(f"frontend_packed {label} + saddle copy", dispatch)
        if out is None:
            continue
        packed, luma8, copy = out
        pk = copy.read()[:, :-1]
        quads, counts = native.find_board_batch(
            np.ascontiguousarray(pk[..., 0]), np.ascontiguousarray(pk[..., 1]),
            np.ascontiguousarray(pk[..., 2]), (pk[..., 3] > 0.5).astype(np.uint8),
            spacing_ratio=DEFAULT_PARAMS.tag_spacing_ratio, max_seeds=CONSTANTS.max_seeds,
            early_exit_score=CONSTANTS.early_exit_score, cap=cap)
        quads = np.ascontiguousarray(quads[:, :96])
        dout = no_sync(f"_decode {label}",
                       lambda: det._decode(packed, luma8, quads, counts, hw))
        if dout is not None:
            no_sync(f"tail concat {label}",
                    lambda: torch.cat([dout.reshape(-1, 10), dout.reshape(-1, 10)]))
    if synced:
        raise AssertionError("host syncs inside the runtime's dispatches: "
                             + "; ".join(synced))
    print("runtime sync-debug two_boards b32: frontend_packed (exact, turbo-nms) with "
          "its saddle copy, _decode and the tail concat make the host wait for "
          f"nothing [{card}]", flush=True)


def phase_runtime(card: str, batch: int) -> dict:
    """The hybrid runtime at ``batch`` (several chunks, so its pipeline can
    show) on a 1080p batch interleaving two_boards, iphone and blank frames,
    exact and both turbo variants, on device-resident frames: every frame
    equal to the CPU run of its source image (golden counts, IDs, corners
    within 1e-3 px), one ``decode_packed`` launch per pass with quads; the
    results bit-equal across schedules (the search inline and on its
    worker, ``AG_SEARCH_ASYNC=0`` with ``chunk=batch``, ``AG_FILL_RAMP=1``);
    the timeline's per-label ms sums; frames/s as median and spread of 5
    calls; the device-busy share of one call. Returns the launches of the
    held runs."""
    import torch

    from aprilgrid_tpu_torch import TagDetector
    from aprilgrid_tpu_torch.bench import timeline_summary
    from aprilgrid_tpu_torch.kernels import LAUNCHES, reset_launches
    from aprilgrid_tpu_torch.utils.profiling import device_busy

    runtime_sync_check(card)
    imgs = {n: read_png(DATA / f"{n}.png") for n in TURBO}
    imgs["blank"] = np.full_like(imgs["two_boards"], 128)
    order = ("two_boards", "iphone", "blank")
    names = [order[i % len(order)] for i in range(batch)]
    golden = dict(GOLDEN, blank=0)
    frames = torch.from_numpy(np.stack([imgs[n] for n in names])).cuda()
    launches: dict = {}
    for label, dec, nms in RUNTIME_MODES:
        with _env(**({"AG_TURBO_NMS": nms} if nms else {})):
            cpu = TagDetector("t36h11", device="cpu", decimate=dec)
            refs = {n: cpu.detect(img) for n, img in imgs.items()}
            det = TagDetector("t36h11", device="cuda", decimate=dec)

            def call(chunk=None):
                out = det.detect_batch(frames, chunk=chunk)
                torch.cuda.synchronize()
                return out

            call()  # warm-up
            reset_launches()
            with _decoded_passes() as passes:
                res = call()
            for k in ("front_kernel", "cluster_rochade_raw", "front_kernel_decimate",
                      "cluster_rochade_raw[luma_f32]", "nms_extract_raw",
                      "sparse_refine_raw"):
                launches[k] = launches.get(k, 0) + LAUNCHES[k]
            launches["decode_packed"] = launches.get("decode_packed", 0) + \
                _one_decode_per_pass(f"runtime {label}", passes[0])
            err = 0.0
            for i, (n, tags) in enumerate(zip(names, res)):
                ref = refs[n]
                if len(tags) != golden[n] or set(tags) != set(ref):
                    raise AssertionError(f"runtime {label} frame {i} ({n}): {len(tags)} "
                                         f"tags, golden {golden[n]}, CPU run {len(ref)}")
                err = max([err] + [float(np.abs(np.asarray(tags[t]) - np.asarray(ref[t])).max())
                                   for t in tags])
            if err > 1e-3:
                raise AssertionError(f"runtime {label}: corners {err} px from the CPU run")
            schedules = (("AG_SEARCH_ASYNC=0", {"AG_SEARCH_ASYNC": "0"}, None),
                         ("AG_SEARCH_ASYNC=1", {"AG_SEARCH_ASYNC": "1"}, None),
                         ("AG_SEARCH_ASYNC=0, chunk=batch", {"AG_SEARCH_ASYNC": "0"}, batch),
                         ("AG_FILL_RAMP=1", {"AG_FILL_RAMP": "1"}, None))
            for what, env, chunk in schedules:
                with _env(**env):
                    if call(chunk) != res:
                        raise AssertionError(f"runtime {label}: {what} differs from the "
                                             "default schedule")
            with _env(AG_TIMELINE="1"):
                t0 = time.perf_counter()
                call()
                t1 = time.perf_counter()
            tl = timeline_summary(det.last_timeline, t0, t1)
            ms = []
            for _ in range(5):
                t0 = time.perf_counter()
                call()
                ms.append((time.perf_counter() - t0) * 1e3)
            fps = sorted(batch / m * 1e3 for m in ms)
            busy = device_busy(call)
        print(f"runtime {label} 1080p b{batch} (two_boards/iphone/blank): every frame = "
              f"the CPU run of its image (max corner diff {err:.2e} px), bit-equal across "
              f"{len(schedules)} schedules; frames/s median {fps[2]:.1f} (min {fps[0]:.1f}, "
              f"max {fps[-1]:.1f}); device busy {100 * busy['share']:.1f} % of "
              f"{busy['wall_ms']:.1f} ms [{card}]", flush=True)
        print(f"runtime {label} timeline [{card}]: {json.dumps(tl)}", flush=True)
    return launches


def phase_split_chain(card: str, batch: int) -> dict:
    """The JAX package's kernel-level chains, at full width on the card:
    ``gray_kernel -> fused_frontend(crop=False, emit_resp=False) ->
    threshold -> cluster_rochade`` and ``front_kernel(emit_blur=True) ->
    cluster_rochade`` must reproduce ``front_kernel ->
    cluster_rochade_raw`` bit for bit, and their gated saddles must be
    ``saddle_frontend_batch``'s. Returns the launches of this path."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
    from aprilgrid_tpu_torch.kernels import LAUNCHES, reset_launches
    from aprilgrid_tpu_torch.kernels.cluster import (
        cluster_rochade,
        cluster_rochade_raw,
        saddles_from_candidates,
        sort_candidates,
    )
    from aprilgrid_tpu_torch.kernels.frontend import (
        front_kernel,
        fused_frontend,
        gray_kernel,
        pad_raw,
    )
    from aprilgrid_tpu_torch.pipeline import _gated, saddle_frontend_batch

    sigma, ratio = CONSTANTS.blur_sigma, CONSTANTS.response_threshold_ratio
    cfg = (DEFAULT_PARAMS, CONSTANTS, DEFAULT_CAPACITIES)
    reset_launches()
    for name in GOLDEN:
        img = torch.from_numpy(read_png(DATA / f"{name}.png")).cuda()
        frames = img[None].expand(batch, *img.shape).contiguous()
        h, w = frames.shape[1:3]
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        luma_f, g8 = gray_kernel(frames)
        blur_p, tmin = fused_frontend(luma_f, sigma, crop=False, true_shape=(h, w),
                                      emit_resp=False)
        thr = tmin.amin(-1) * ratio
        f, c = cluster_rochade(blur_p, thr, h, w)
        saddles = _gated(saddles_from_candidates(f), *cfg)
        t1.record()

        raw_p, _, _, ch, u16 = pad_raw(frames)
        eb, e8, emin = front_kernel(raw_p, sigma, (h, w), ch, u16, emit_blur=True)
        ef, ec = cluster_rochade(eb, emin.amin(-1) * ratio, h, w)

        l8, rmin = front_kernel(raw_p, sigma, (h, w), ch, u16)
        rf, rc = cluster_rochade_raw(raw_p, rmin.amin(-1) * ratio, h, w, ch, u16, sigma)
        ref, rl8, _ = saddle_frontend_batch(frames, *cfg)
        torch.cuda.synchronize()
        (sf, _), (sef, _), (srf, _) = (sort_candidates(x) for x in (f, ef, rf))
        same = (
            torch.equal(g8, l8) and torch.equal(e8, l8) and torch.equal(rl8, l8)
            and torch.equal(tmin, rmin) and torch.equal(emin, rmin)
            and torch.equal(eb, blur_p) and torch.equal(c, rc) and torch.equal(ec, rc)
            and torch.equal(sf, srf) and torch.equal(sef, srf)
            and all(torch.equal(a, b) for a, b in zip(saddles, ref))
        )
        if not same:
            raise AssertionError(
                f"split chain {name}: differs from the fused chain (fields max |diff| "
                f"{(sf - srf).abs().max().item()} / {(sef - srf).abs().max().item()}, "
                f"counts {c[0].tolist()} / {ec[0].tolist()} vs {rc[0].tolist()})"
            )
        print(f"split chain {name} b{batch}: gray_kernel -> fused_frontend -> "
              f"cluster_rochade and front_kernel[emit_blur] -> cluster_rochade = "
              f"front_kernel -> cluster_rochade_raw bit for bit "
              f"({int(rc[0, 0].item())} candidates, {int(ref.valid[0].sum())} saddles/frame); "
              f"split front-end {t0.elapsed_time(t1):.3f} ms [{card}]", flush=True)
    return {k: LAUNCHES[k] for k in ("gray_kernel", "fused_frontend", "cluster_rochade",
                                     "front_kernel[emit_blur]")}


def _canvas(img: np.ndarray, side: int = 4096) -> np.ndarray:
    """``img`` set into a ``side`` x ``side`` mid-gray RGB frame; at 4096,
    h*w = 2^24 is the first size outside the fused kernels' label domain."""
    canvas = np.full((side, side, 3), 128, np.uint8)
    canvas[1500 : 1500 + img.shape[0], 1000 : 1000 + img.shape[1]] = img
    return canvas


def phase_plane_path(card: str, batch: int) -> dict:
    """The plane path at full width: ``planes_frontend_batch`` against its
    own CPU run, then through the facade on frames outside the label
    domain and through ``refined_saddle_points``. Returns the launches of
    ``fused_frontend`` and ``sparse_refine_raw`` on this path."""
    import warnings

    import torch

    from aprilgrid_tpu_torch import TagDetector
    from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
    from aprilgrid_tpu_torch.kernels import LAUNCHES, reset_launches
    from aprilgrid_tpu_torch.kernels.frontend import fused_frontend
    from aprilgrid_tpu_torch.ops.frontend import decimate2
    from aprilgrid_tpu_torch.ops.gray import to_luma_batch
    from aprilgrid_tpu_torch.pipeline import (
        frontend_packed,
        planes_frontend_batch,
        saddle_frontend_batch,
    )

    cfg = (DEFAULT_PARAMS, CONSTANTS, DEFAULT_CAPACITIES)
    imgs = {n: read_png(DATA / f"{n}.png") for n in TURBO}
    # launches of the held runs only: timing runs do not count
    launches = {"fused_frontend": 0, "sparse_refine_raw": 0}

    def count():
        for k in launches:
            launches[k] += LAUNCHES[k]
    for n, img in imgs.items():
        one = torch.from_numpy(img)[None]
        frames = one.cuda().expand(batch, *img.shape).contiguous()
        for dec in (False, True):
            label = "turbo" if dec else "exact"
            want, wl8, wcnt = planes_frontend_batch(one, *cfg, dec)   # the CPU run
            reset_launches()
            got, l8, cnt = planes_frontend_batch(frames, *cfg, dec)
            torch.cuda.synchronize()
            # the turbo tail re-refines through the refine kernel
            if LAUNCHES["fused_frontend"] != 1 or LAUNCHES["sparse_refine_raw"] != int(dec):
                raise AssertionError(
                    f"plane path {label} {n}: {LAUNCHES['fused_frontend']} fused_frontend "
                    f"and {LAUNCHES['sparse_refine_raw']} sparse_refine_raw launches "
                    f"(expected 1 and {int(dec)})")
            count()
            err = (got.p.cpu() - want.p).abs().max().item()
            if not (torch.equal(got.valid.cpu(), want.valid.expand(batch, -1))
                    and torch.equal(l8.cpu(), wl8.expand(batch, -1, -1))
                    and torch.equal(cnt.cpu(), wcnt.expand(batch, -1)) and err <= 1e-3):
                raise AssertionError(
                    f"plane path {label} {n}: {int(got.valid[0].sum())} saddles vs "
                    f"{int(want.valid[0].sum())} on the CPU, positions {err} px apart")
            ms = _ms(lambda: planes_frontend_batch(frames, *cfg, dec), 3)
            luma = to_luma_batch(frames)[0]
            luma = (decimate2(luma) if dec else luma).contiguous()
            fms = _ms(lambda: fused_frontend(luma, CONSTANTS.blur_sigma), 10)
            fused, _, _ = saddle_frontend_batch(frames, *cfg, decimate=dec, nms=False)
            if torch.equal(fused.valid, got.valid):
                gap = f"the same, within {(got.p - fused.p).abs().max().item():.2e} px"
            else:
                gap = f"{int(fused.valid[0].sum())}"
            print(f"plane path {label} {n} b{batch}: {int(got.valid[0].sum())} saddles/"
                  f"frame = CPU run (max position diff {err:.2e} px); {ms:.3f} ms, of "
                  f"which fused_frontend {fms:.4f} ms ({100 * fms / ms:.1f} %); the fused "
                  f"path finds {gap} [{card}]", flush=True)

    # through the facade: 4096 x 4096 frames are outside the label domain
    canvas = _canvas(imgs["two_boards"])
    gpu = TagDetector("t36h11", device="cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref = TagDetector("t36h11", device="cpu").detect(canvas)
        gpu.detect_batch(np.stack([canvas] * 4))  # warm-up
        reset_launches()
        _held_run(gpu, "two_boards on a 4096^2 canvas", canvas, ref, 4, card, "planes",
                  golden=GOLDEN["two_boards"])
    if not any("plane path" in str(w.message) for w in caught):
        raise AssertionError("the out-of-domain frames raised no plane-path warning")
    if LAUNCHES["fused_frontend"] <= 0 or LAUNCHES["cluster_rochade_raw"] != 0:
        raise AssertionError(
            f"out-of-domain detect_batch: fused_frontend launched "
            f"{LAUNCHES['fused_frontend']} times, cluster_rochade_raw "
            f"{LAUNCHES['cluster_rochade_raw']} (expected > 0 and 0)")
    count()

    # one whole chunk of the facade (16 frames at this size) of a frame
    # size that is no multiple of the kernels' 64 x 128 tiles, with the
    # device memory it peaks at
    canvas = _canvas(imgs["two_boards"], 4100)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = TagDetector("t36h11", device="cpu").detect(canvas)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        _held_run(gpu, "two_boards on a 4100^2 canvas", canvas, ref, 16, card, "planes",
                  golden=GOLDEN["two_boards"])
    if LAUNCHES["fused_frontend"] != 1 or LAUNCHES["cluster_rochade_raw"] != 0:
        raise AssertionError(
            f"4100^2 detect_batch: {LAUNCHES['fused_frontend']} fused_frontend launches, "
            f"{LAUNCHES['cluster_rochade_raw']} of cluster_rochade_raw (expected 1 and 0)")
    count()
    print(f"plane path 16 x 4100^2 (one chunk, {16 * 4100 * 4100} pixels): peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)

    reset_launches()
    two = imgs["two_boards"]
    pts = gpu.refined_saddle_points(two)
    cpts = TagDetector("t36h11", device="cpu").refined_saddle_points(two)
    err = max(abs(a - b) for s, t in zip(pts, cpts) for a, b in zip(s.p, t.p))
    if LAUNCHES["fused_frontend"] != 1 or len(pts) != len(cpts) or err > 1e-3:
        raise AssertionError(
            f"refined_saddle_points: {len(pts)} saddles vs {len(cpts)} on the CPU, "
            f"{err} px apart, {LAUNCHES['fused_frontend']} fused_frontend launches")
    count()

    def wall_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    # the call as a user makes it (host array in, records out), beside the
    # fused kernels' front-end on the same single frame, copies included
    ms = wall_ms(lambda: gpu.refined_saddle_points(two))
    fms = wall_ms(lambda: frontend_packed(torch.from_numpy(two)[None].cuda(), *cfg)[0].cpu())
    print(f"refined_saddle_points two_boards: {len(pts)} saddles = CPU run (max position "
          f"diff {err:.2e} px), 1 fused_frontend launch; {ms:.3f} ms per call (host "
          f"clock), the fused front-end on one frame {fms:.3f} ms [{card}]", flush=True)
    return launches


# -- phase 7: the peak merge and the row-sharding modes ---------------------

SHARDS_EXACT = (2, 4)   # shard counts of the sharded front-ends on the 4K frame
SHARDS_TURBO = (2, 3)


def frame_4k(u16: bool = False):
    """tools/bench_4k.py's 4K frame on the card: two_boards at the centre
    of a 2160 x 3840 grey (128) canvas, as the image crate's u8 luma, or
    that times 257 as u16 (the sharded front-ends take one channel)."""
    import torch

    from aprilgrid_tpu_torch.ops.gray import to_luma

    from aprilgrid_tpu_torch.bench import frame_4k as rig_frame

    l8 = to_luma(torch.from_numpy(rig_frame()).to("cuda"))[1].reshape(2160, 3840)
    return (l8.to(torch.int32) * 257).to(torch.int16).view(torch.uint16) if u16 else l8


def _gray(img):
    """A golden image on the card as one channel: RGB as the image crate's
    u8 luma, gray as it is."""
    import torch

    from aprilgrid_tpu_torch.ops.gray import to_luma

    t = torch.from_numpy(img).to("cuda")
    return to_luma(t)[1].reshape(img.shape[:2]) if img.ndim == 3 else t


def _fit_work(lf, thr: float, h: int, w: int, margin: int, peaks=None) -> dict:
    """What the data asks of the cluster and NMS kernels on frame 0 of an
    f32 luma plane in the padded layout (thr its threshold): components of
    the mask (roots), masked pixels inside the ``margin`` (a fit each), the
    64 x 64 tiles that hold one, and the pixels of those tiles together
    with the 8 pixels around them (the reach of an 8-sweep peak merge):
    a halo pixel counts once, and not where a neighbouring tile holds a
    fit itself. With frame 0's ``peaks`` (an (h, w) bool plane), also what
    the peak merge asks: the relay (mask) pixels within that reach, and
    the last sweep of eight that moves a key (``_moving_sweeps``)."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.ops.cluster import label_components
    from aprilgrid_tpu_torch.ops.frontend import gaussian_blur, hessian_response

    resp = hessian_response(gaussian_blur(lf[0, 8 : 8 + h, :w], CONSTANTS.blur_sigma))
    mask = torch.zeros_like(resp, dtype=torch.bool)
    mask[1:-1, 1:-1] = resp[1:-1, 1:-1] < thr
    lab = label_components(mask)
    roots = int((mask & (lab == torch.arange(h * w, device=lf.device).reshape(h, w))).sum())
    fit = torch.zeros_like(mask)
    fit[margin:-margin, margin:-margin] = mask[margin:-margin, margin:-margin]
    hp, wp = lf.shape[1] - 16, lf.shape[2]
    tiles = torch.nn.functional.pad(fit, (0, wp - w, 0, hp - h))
    tiles = tiles.reshape(hp // 64, 64, wp // 64, 64).any(3).any(1)
    tile_px = tiles.repeat_interleave(64, 0).repeat_interleave(64, 1).to(torch.float32)
    reach = torch.nn.functional.max_pool2d(tile_px[None, None], 17, 1, 8)[0, 0]
    work = dict(roots=roots, fits=int(fit.sum()), fit_tiles=int(tiles.sum()),
                merge_px=int((reach > 0).sum()))
    if peaks is not None:
        work.update(relay_reach=int((mask & (reach[:h, :w] > 0)).sum()),
                    merge_sweeps=_moving_sweeps(peaks, mask, 8))
    return work


def _moving_sweeps(peaks, relay, merge: int) -> int:
    """The last of ``merge`` sweeps that moves a key, in the plain merge's
    passes (``merge_peaks_plain``) on (h, w) bool planes; 0 if none."""
    import torch

    h, w = peaks.shape
    big = h * w
    key = torch.where(peaks, torch.arange(big, device=peaks.device).reshape(h, w), big)
    last = 0
    for sweep in range(1, merge + 1):
        old = key
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            nk = torch.full_like(key, big)
            nk[max(-dy, 0) : h - max(dy, 0), max(-dx, 0) : w - max(dx, 0)] = (
                key[max(dy, 0) : h - max(-dy, 0), max(dx, 0) : w - max(-dx, 0)])
            key = torch.where(relay & (nk < key), nk, key)
        if not torch.equal(key, old):
            last = sweep
    return last


def _device_ms(split: dict) -> float:
    """Device ms of one call from its ``_profile_split`` entry: its kernels,
    one launch each, and the PyTorch operations its wrapper enqueues."""
    return sum(v if k != "at::" else v["ms"] for k, v in split.items())


def _nms_ops(batch: int, hpx: int, fits: int, fit_tiles: int,
             merge_px: int = 0, merge_passes: int = 0) -> float:
    """Operations of ``nms_extract_raw`` for this run's data: the stencil,
    the tile form of the record gate at every pixel of a tile that holds a
    fit, per fit its rows of taps and the closed form plus 49 compares per
    pass of the peak window; with the merge, a compare and a select at
    each of ``merge_px`` pixels in each of ``merge_passes`` passes. The
    merge's row counts the relay pixels within 8 of a fit tile and the
    passes up to the last sweep that moves a key on frame 0 (counted
    before as every pixel within 8 of a fit tile, 32 passes at m8); then the bytes
    (half plane in, cell grid out) bind it at two_boards b32, as they bind
    the merge-free entry."""
    from aprilgrid_tpu_torch.ops.rochade import fit_taps

    cone, fits_t = fit_taps(2)
    tile_ops = 2.0 * len(cone)
    row_ops = 2.0 * sum(5 * len(vt) + len(ht) for _, vt, ht in fits_t) + 30.0
    merge_ops = merge_px * merge_passes * 2.0
    return STENCIL_OPS * hpx + batch * (fit_tiles * 4096 * tile_ops
                                        + fits * (row_ops + 98) + merge_ops)


# the synthetic merge planes: (h, w) = 3 x 4 tiles of 64
MERGE_PLANE = (192, 256)


def merge_synthetic_planes():
    """Relay masks and peaks (bool, (5, 192, 256)) built to break a merge
    that is only tile-local, one case a plane: ``names, peaks, relay``.
    Every peak is a relay pixel at least 4 pixels from the plane's edges,
    and two peaks are more than 3 pixels apart (Chebyshev), as the NMS
    leaves them.

    *reach8*: keys that travel exactly the halo's 8 pixels into a
    neighbouring tile — right along row 100 across column 64 (peaks 8
    apart at columns 56, 64, 72), down column 200 across row 128, and
    left-down through a filled rectangle from tile (0, 2) into (0, 1);
    *corner*: one-pixel staircases through the corners (64, 64) and
    (64, 128), 8 sweeps from a peak of one tile to a peak of the
    diagonally opposite one; *ring*: a two-pixel-thick square ring across
    column 64, where a key reaches pixels from two sides in one sweep,
    and a filled square whose one peak's key reaches its pixels from the
    left and from above; *edge*: blobs that touch the plane's four edges,
    two peaks in each; *fixed8*: lone chains whose last moving sweep is
    the 8th (9 pixels), the 7th (8 pixels) and beyond the 8th (11
    pixels), and a 5 x 5 square (4)."""
    h, w = MERGE_PLANE
    names = ("reach8", "corner", "ring", "edge", "fixed8")
    relay = np.zeros((len(names), h, w), bool)
    peaks = np.zeros_like(relay)

    def put(i, pts):
        for y, x in pts:
            peaks[i, y, x] = relay[i, y, x] = True

    relay[0, 100, 50:81] = True
    put(0, [(100, 56), (100, 64), (100, 72)])
    relay[0, 110:151, 200] = True
    put(0, [(120, 200), (128, 200)])
    relay[0, 20:29, 124:133] = True
    put(0, [(20, 132), (28, 124)])
    for i in range(9):
        relay[1, 60 + i, 60 + i] = relay[1, 60 + i, 61 + i] = True
        relay[1, 60 + i, 132 - i] = relay[1, 60 + i, 131 - i] = True
    put(1, [(60, 60), (68, 68), (60, 132), (68, 124)])
    relay[2, 96:104, 58:66] = True
    relay[2, 98:102, 60:64] = False
    put(2, [(96, 58), (96, 65), (103, 65)])
    relay[2, 30:40, 150:160] = True
    put(2, [(30, 150)])
    for sl in ((slice(0, 10), slice(0, 13)), (slice(182, 192), slice(240, 256)),
               (slice(0, 12), slice(200, 256)), (slice(150, 192), slice(0, 9))):
        relay[3][sl] = True
    put(3, [(4, 4), (4, 9), (187, 245), (187, 251), (5, 210), (5, 217), (160, 4),
            (168, 4)])
    relay[4, 90, 20:29] = True
    relay[4, 90, 150:158] = True
    relay[4, 30, 150:161] = True
    relay[4, 160:165, 20:25] = True
    put(4, [(90, 20), (90, 150), (30, 150), (160, 20)])
    ys, xs = np.nonzero(peaks.any(0))
    assert ys.min() >= 4 and xs.min() >= 4 and ys.max() < h - 4 and xs.max() < w - 4
    return names, peaks, relay


def _sweep_hist(flags) -> dict:
    """Tiles by the sweeps their merge ran (the kernel's flags after a
    merge; 0, a tile without a candidate, is left out)."""
    import torch

    n = torch.bincount(flags[flags > 0].flatten().to(torch.int64)).tolist()
    return {s: c for s, c in enumerate(n) if c}


def merge_checks(card: str, batch: int, rec: dict) -> None:
    """``nms_extract_raw`` at every m in 0-8 bit-equal to its plain version
    on the four goldens' half planes at ``batch``; the peaks a frame keeps
    at m0/m4/m8 and the sweeps frame 0's tiles ran at m4 and m8; then the
    synthetic merge planes (``merge_synthetic_check``); two_boards timed at
    m8 with the device split of m0/m4/m8 and what ptxas reported for the
    merge's launches."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels import _lib
    from aprilgrid_tpu_torch.kernels.frontend import front_kernel_decimate, pad_raw
    from aprilgrid_tpu_torch.kernels.nms import (
        MERGE_MAX,
        _launch,
        nms_extract_raw,
        nms_extract_raw_plain,
    )

    for r in _lib.kernel_resources("nms.cu"):
        if r["kernel"] in ("merge_kernel", "blur_resp_kernel<1>"):
            print(f"ptxas nms.cu {r['kernel']} (the merge's launches): {r['registers']} "
                  f"registers, {r['stack_bytes']} B stack frame, spills "
                  f"{r['spill_store_bytes']}/{r['spill_load_bytes']} B (stores/loads), "
                  f"{r['smem_bytes']} B smem", flush=True)
    sigma = CONSTANTS.blur_sigma
    for name in GOLDEN:
        img = torch.from_numpy(read_png(DATA / f"{name}.png")).to("cuda")
        frames = img[None].expand(batch, *img.shape).contiguous()
        raw_p, h, w, ch, u16 = pad_raw(frames)
        hh, wh = h // 2, w // 2
        _, half_p, tmin = front_kernel_decimate(raw_p, sigma, (h, w), ch, u16)
        thr = tmin.amin(-1) * CONSTANTS.response_threshold_ratio
        peaks, ran = {}, {}
        for m in range(MERGE_MAX + 1):
            nargs = (half_p, thr, hh, wh, sigma, 4, 1.0, m)
            cells = nms_extract_raw(*nargs)
            pcells = nms_extract_raw_plain(*nargs)
            torch.cuda.synchronize()
            if not torch.equal(cells, pcells):
                raise AssertionError(
                    f"nms_extract_raw merge={m} {name}: {int((cells[:, 5] > 0.5).sum())} vs "
                    f"{int((pcells[:, 5] > 0.5).sum())} peaks, max |diff| "
                    f"{(cells - pcells).abs().max().item()}")
            peaks[m] = int((cells[0, 5] > 0.5).sum())
            if m == 0:
                labels = cells[0, 5][cells[0, 5] > 0.5].to(torch.int64) - 1
            if m in (4, 8):
                ran[m] = _sweep_hist(_launch(half_p, thr, hh, wh, sigma, 4, 1.0, m, None,
                                             hh)[1][0])
        print(f"kernels nms_extract_raw[merge] {name} b{batch}: m0-m8 bit-equal to the "
              f"plain version; peaks/frame m0/m4/m8 {peaks[0]}/{peaks[4]}/{peaks[8]}; "
              f"frame 0's tiles by sweeps run: m4 {ran[4]}, m8 {ran[8]}", flush=True)
        if name == "two_boards":
            pk = torch.zeros((hh, wh), dtype=torch.bool, device="cuda")
            pk[labels // wh, labels % wh] = True
            work = _fit_work(half_p, float(thr[0]), hh, wh, 4, peaks=pk)
            hpx = batch * (half_p.shape[1] - 16) * half_p.shape[2]
            nbytes = sum(t.numel() * t.element_size() for t in (half_p, thr, cells))
            bound = _bound_ms(nbytes, _nms_ops(batch, hpx, work["fits"], work["fit_tiles"],
                                               work["relay_reach"], 4 * work["merge_sweeps"]))
            old = _bound_ms(nbytes, _nms_ops(batch, hpx, work["fits"], work["fit_tiles"],
                                             work["merge_px"], 32))
            split = _profile_split({f"m{m}": (lambda m=m: nms_extract_raw(
                half_p, thr, hh, wh, merge=m)) for m in (0, 4, 8)})
            print(f"split nms_extract_raw two_boards b{batch}, device ms per launch: "
                  f"{json.dumps(split)}", flush=True)
            rec["merge"] = dict(
                err=0.0, ms=_ms(lambda: nms_extract_raw(*nargs), 10),
                plain_ms=_ms(lambda: nms_extract_raw_plain(*nargs), 1), bound=bound,
                peaks=peaks, device_ms=_device_ms(split["m8"]),
            )
            print(f"time nms_extract_raw two_boards b{batch}: m0 "
                  f"{_ms(lambda: nms_extract_raw(half_p, thr, hh, wh), 10):.4f} ms, m4 "
                  f"{_ms(lambda: nms_extract_raw(half_p, thr, hh, wh, merge=4), 10):.4f} ms, "
                  f"m8 {rec['merge']['ms']:.4f} ms [{card}]; m8 bound {bound[0]:.4f} ms "
                  f"({bound[1]}: {work['relay_reach']} relay pixels within reach x 4 x "
                  f"{work['merge_sweeps']} moving sweeps a frame), the count of the merge's first form "
                  f"{old[0]:.4f} ms ({old[1]}: {work['merge_px']} pixels x 32 passes)",
                  flush=True)
    merge_synthetic_check(card)


def merge_synthetic_check(card: str) -> None:
    """The merge launch alone (``ag_nms_extract_raw`` without a half plane)
    on the synthetic merge planes on the card: candidates at their peaks
    only, a blurred noise plane for the fits, the relay mask as bits, the
    flag of each tile that holds a peak. At every m in 1-8 the cell grid
    equals the plain merge's bit for bit (``nms_peaks_plain`` gives the
    planes' peaks, ``merge_peaks_plain`` the survivors, ``fit_record`` at
    each their record; NaN where both are NaN), and at m8 the chains of
    *fixed8* end their tiles' sweeps where the CPU block model does
    (tests/test_torch_nms.py)."""
    import ctypes

    import torch

    from aprilgrid_tpu_torch.kernels import _lib
    from aprilgrid_tpu_torch.kernels._fit import fit_struct
    from aprilgrid_tpu_torch.kernels.nms import (
        _BIGF,
        MERGE_MAX,
        merge_peaks_plain,
        nms_peaks_plain,
    )
    from aprilgrid_tpu_torch.ops.frontend import gaussian_blur
    from aprilgrid_tpu_torch.ops.rochade import fit_record, gather_patches

    names, peaks, relay = merge_synthetic_planes()
    b, h, w = peaks.shape
    pk, rl = torch.from_numpy(peaks).cuda(), torch.from_numpy(relay).cuda()
    cand = torch.where(pk, -1.0, _BIGF).to(torch.float32)
    noise = np.random.default_rng(3).random((b, h, w), dtype=np.float32)
    blur = gaussian_blur(torch.from_numpy(noise).cuda(), 1.5).contiguous()
    bits = (rl.view(b, h, w // 32, 32).to(torch.int64)
            << torch.arange(32, device="cuda")).sum(-1)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).contiguous()
    tiles = pk.view(b, h // 64, 64, w // 64, 64).any(4).any(2).to(torch.int32)
    if not torch.equal(nms_peaks_plain(cand), pk):
        raise AssertionError("merge synthetic planes: the NMS does not keep their peaks")
    fit = fit_struct(2)
    left, ran = [], {}
    for m in range(1, MERGE_MAX + 1):
        flags = tiles.clone()
        cells = torch.zeros((b, 6, h // 4, w // 4), dtype=torch.float32, device="cuda")
        _lib.check(_lib.launch(
            "nms_extract_raw", cand, None, b, h, w, h, w, None, None,
            ctypes.addressof(fit), 1.0, 4, None, h, m, blur.data_ptr(), cand.data_ptr(),
            flags.data_ptr(), bits.data_ptr(), cells.data_ptr()), "merge synthetic")
        want = torch.zeros_like(cells)
        merged = merge_peaks_plain(pk, rl, m)
        for i in range(b):
            ys, xs = torch.nonzero(merged[i], as_tuple=True)
            x0, y0, c3, c4, c5, _ = fit_record(gather_patches(blur[i], xs, ys, 2), 2, 1.0)
            want[i, :5, ys // 4, xs // 4] = torch.stack(
                [xs.to(torch.float32) + x0, ys.to(torch.float32) + y0, c3, c4, c5])
            want[i, 5, ys // 4, xs // 4] = (ys * w + xs + 1).to(torch.float32)
        torch.cuda.synchronize()
        if not bool(((cells == want) | (cells.isnan() & want.isnan())).all()):
            raise AssertionError(
                f"merge synthetic m{m}: peaks {(cells[:, 5] > 0.5).sum((1, 2)).tolist()} vs "
                f"plain {(want[:, 5] > 0.5).sum((1, 2)).tolist()} ({names})")
        left.append((cells[:, 5] > 0.5).sum((1, 2)).tolist())
        ran[m] = {n: _sweep_hist(flags[i]) for i, n in enumerate(names)}
    fixed = flags[names.index("fixed8")]
    if {(int(t), int(u)): int(fixed[t, u]) for t, u in torch.nonzero(fixed)} != {
            (0, 2): 8, (1, 0): 8, (1, 2): 8, (2, 0): 5}:
        raise AssertionError(f"merge synthetic fixed8: tiles ran {fixed.tolist()} sweeps")
    print(f"kernels nms_extract_raw[merge] synthetic {h}x{w} ({', '.join(names)}): the "
          f"merge launch bit-equal to the plain merge at m1-m8; peaks a plane m1..m8 "
          f"{left}; tiles by sweeps run at m8 {ran[MERGE_MAX]} [{card}]", flush=True)


def _cluster_diff(f, c, pf, pc, label: str, tol: float) -> float:
    """The cluster kernel's rows against the plain version's after the
    label sort: counts, ok and labels equal, the rest within ``tol``."""
    import torch

    from aprilgrid_tpu_torch.kernels.cluster import sort_candidates

    (sf, _), (spf, _) = sort_candidates(f), sort_candidates(pf)
    err = (sf[..., :6] - spf[..., :6]).abs().max().item()
    if not (torch.equal(c, pc) and torch.equal(sf[..., 6:8], spf[..., 6:8])) or err > tol:
        raise AssertionError(f"{label}: counts {c[:, 0].tolist()} vs {pc[:, 0].tolist()}, "
                             f"record diff {err}")
    return err


def row_off_checks(name: str, frame, timed: bool = False) -> dict:
    """Each kernel's row-sharding mode against its plain version on the
    windows the sharded front-ends give it for ``frame`` (one channel, on
    the card) cut into two bands: front_kernel and cluster_rochade_raw on
    the exact path's windows, front_kernel_decimate,
    cluster_rochade_raw(luma_f32) and nms_extract_raw (m0 and m8) on the
    turbo path's. Returns the NMS mode's launches in those checks (its
    only caller: the sharded front-ends extract with the drain) and, with
    ``timed``, each mode on one shard's window (batch 1, as the front-ends
    call it): ms, plain ms, bound."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.kernels.cluster import (
        cluster_rochade_raw,
        cluster_rochade_raw_plain,
    )
    from aprilgrid_tpu_torch.kernels.frontend import (
        front_kernel,
        front_kernel_decimate,
        front_kernel_decimate_plain,
        front_kernel_plain,
        raw_luma,
    )
    from aprilgrid_tpu_torch.kernels import LAUNCHES
    from aprilgrid_tpu_torch.kernels.nms import nms_extract_raw, nms_extract_raw_plain
    from aprilgrid_tpu_torch.parallel.sharding import row_windows

    sigma, ratio = CONSTANTS.blur_sigma, CONSTANTS.response_threshold_ratio
    u16 = frame.dtype == torch.uint16
    w = frame.shape[1]
    rec = {}

    def held(fn, plain, same):
        out, pout = fn(), plain()
        torch.cuda.synchronize()
        return out, same(out, pout)

    def equal(label):
        def same(a, b):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{label} {name}: differs from the plain version")
            return 0.0
        return same

    wins, roff, lh, gh = row_windows(frame, 2)
    rows = dict(row_off=roff, global_h=gh)
    fargs = (wins, sigma, (lh, w), 1, u16)
    (_, tmin), _ = held(lambda: front_kernel(*fargs, **rows),
                        lambda: front_kernel_plain(*fargs, **rows), equal("front_kernel[row_off]"))
    thr = (tmin.amin() * ratio).expand(2).contiguous()
    cargs = (wins, thr, lh, w, 1, u16)
    _, cerr = held(lambda: cluster_rochade_raw(*cargs, **rows),
                   lambda: cluster_rochade_raw_plain(*cargs, **rows),
                   lambda a, b: _cluster_diff(*a, *b, f"cluster_rochade_raw[row_off] {name}",
                                              1e-4))
    twins, troff, tlh, tgh = row_windows(frame, 2, turbo=True)
    trows = dict(row_off=troff, global_h=tgh)
    dargs = (twins, sigma, (tlh, w), 1, u16)
    (_, half_p, htmin), _ = held(
        lambda: front_kernel_decimate(*dargs, **trows),
        lambda: front_kernel_decimate_plain(*dargs, **trows),
        equal("front_kernel_decimate[row_off]"))
    hthr = (htmin.amin() * ratio).expand(2).contiguous()
    hh, wh = tlh // 2, w // 2
    fargs32 = (half_p, hthr, hh, wh, 1, False, sigma, 4, 1.0, True)
    _, ferr = held(lambda: cluster_rochade_raw(*fargs32, **trows),
                   lambda: cluster_rochade_raw_plain(*fargs32, **trows),
                   lambda a, b: _cluster_diff(*a, *b,
                                              f"cluster_rochade_raw[luma_f32,row_off] {name}", 0.0))
    peaks, nms0 = [], LAUNCHES["nms_extract_raw[row_off]"]
    for m in (0, 8):
        nargs = (half_p, hthr, hh, wh, sigma, 4, 1.0, m)
        cells, _ = held(lambda: nms_extract_raw(*nargs, **trows),
                        lambda: nms_extract_raw_plain(*nargs, **trows),
                        lambda a, b: equal(f"nms_extract_raw[row_off] m{m}")((a,), (b,)))
        peaks.append(int((cells[:, 5] > 0.5).sum()))
    rec["nms_row_off_launches"] = LAUNCHES["nms_extract_raw[row_off]"] - nms0
    print(f"kernels row_off {name} {tuple(frame.shape)} {frame.dtype}, windows of 2 bands: "
          f"front, cluster (max |diff| {cerr}), front_decimate, cluster[luma_f32], nms m0/m8 "
          f"({peaks[0]}/{peaks[1]} peaks) bit-equal to their plain versions", flush=True)
    if not timed:
        return rec

    # one shard's window (shard 1), batch 1, as the front-ends call the kernels
    one = lambda t: t[1:2].contiguous()  # noqa: E731
    nbytes = lambda *ts: float(sum(t.numel() * t.element_size() for t in ts))  # noqa: E731
    r1, tr1 = dict(row_off=one(roff), global_h=gh), dict(row_off=one(troff), global_h=tgh)
    win, twin, hp1 = one(wins), one(twins), one(half_p)
    px = (win.shape[1] - 16) * win.shape[2]
    hpx = (hp1.shape[1] - 16) * hp1.shape[2]
    lf, _ = raw_luma(win, 1, u16)
    work = _fit_work(lf, float(thr[0]), lh, w, 2)
    hwork = _fit_work(hp1, float(hthr[0]), hh, wh, 4)
    dense = (5.0 + STENCIL_OPS) * px
    f1 = dict(a=(win, sigma, (lh, w), 1, u16), k=r1)
    c1 = dict(a=(win, thr[:1], lh, w, 1, u16), k=r1)
    d1 = dict(a=(twin, sigma, (tlh, w), 1, u16), k=tr1)
    g1 = dict(a=(hp1, hthr[:1], hh, wh, 1, False, sigma, 4, 1.0, True), k=tr1)
    n1 = dict(a=(hp1, hthr[:1], hh, wh, sigma, 4, 1.0, 0), k=tr1)
    cl_out = cluster_rochade_raw(*c1["a"], **c1["k"])
    g_out = cluster_rochade_raw(*g1["a"], **g1["k"])
    d_out = front_kernel_decimate(*d1["a"], **d1["k"])
    n_out = nms_extract_raw(*n1["a"], **n1["k"])
    table = {
        "front_row_off": (front_kernel, front_kernel_plain, f1, 0.0,
                          _bound_ms(nbytes(win) + px + 4.0 * px / 4096, dense)),
        "cluster_row_off": (cluster_rochade_raw, cluster_rochade_raw_plain, c1, cerr,
                            _bound_ms(nbytes(win, thr[:1], *cl_out),
                                      dense + work["roots"] * FIT_OPS)),
        "decimate_row_off": (front_kernel_decimate, front_kernel_decimate_plain, d1, 0.0,
                             _bound_ms(nbytes(twin, *d_out),
                                       11.0 * (twin.shape[1] - 16) * twin.shape[2]
                                       + STENCIL_OPS * hpx)),
        "cluster_f32_row_off": (cluster_rochade_raw, cluster_rochade_raw_plain, g1, ferr,
                                _bound_ms(nbytes(hp1, hthr[:1], *g_out),
                                          STENCIL_OPS * hpx + hwork["roots"] * FIT_OPS)),
        "nms_row_off": (nms_extract_raw, nms_extract_raw_plain, n1, 0.0,
                        _bound_ms(nbytes(hp1, hthr[:1], n_out),
                                  _nms_ops(1, hpx, hwork["fits"], hwork["fit_tiles"]))),
    }
    calls = {key: (lambda fn=fn, c=c: fn(*c["a"], **c["k"]))
             for key, (fn, _, c, _, _) in table.items()}
    split = _profile_split(calls)
    for key, (fn, plain, c, err, bound) in table.items():
        rec[key] = dict(err=err, ms=_ms(calls[key], 20),
                        plain_ms=_ms(lambda: plain(*c["a"], **c["k"]), 1), bound=bound,
                        device_ms=_device_ms(split[key]))
    print(f"split row_off modes, one shard's window of {name} (batch 1), device ms per "
          f"launch: {json.dumps(split)}", flush=True)
    return rec


def sharded_frontends(card: str) -> dict:
    """The row-sharded front-ends on the 4K frame, u8 and u16, with every
    shard on this card (``[cuda:0] * n``): the exact one at 2 and 4 shards,
    the turbo one at 2 and 3, each bit-equal, slot for slot, to the
    single-device front-end on the card. Returns the launches of the held
    runs (counted from 0 before them); then ms per call of each, and of the
    single-device front-end, as a record (one card shows no scaling)."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
    from aprilgrid_tpu_torch.kernels import LAUNCHES, reset_launches
    from aprilgrid_tpu_torch.ops.rochade import Saddles
    from aprilgrid_tpu_torch.parallel.sharding import (
        make_mesh,
        saddle_frontend_rows_sharded_kernels,
        saddle_frontend_rows_sharded_kernels_turbo,
    )
    from aprilgrid_tpu_torch.pipeline import decimated_frontend_batch, saddle_frontend_batch

    cfg = (DEFAULT_PARAMS, CONSTANTS, DEFAULT_CAPACITIES)
    dev = torch.device("cuda", 0)
    first = lambda s: Saddles(*(t[0] for t in s))  # noqa: E731
    single = lambda f: first(saddle_frontend_batch(f[None], *cfg)[0])  # noqa: E731
    tsingle = lambda f: first(  # noqa: E731
        decimated_frontend_batch(f[None], *cfg, nms=False)[0])
    runs = []   # (label, sharded fn, single-device fn, frame)
    for u16 in (False, True):
        frame = frame_4k(u16)
        kind = "u16" if u16 else "u8"
        for n in SHARDS_EXACT:
            mesh = make_mesh({"sp": n}, [dev] * n)
            runs.append((f"exact {kind} {n} shards",
                         saddle_frontend_rows_sharded_kernels(mesh, *cfg), single, frame))
        for n in SHARDS_TURBO:
            mesh = make_mesh({"sp": n}, [dev] * n)
            runs.append((f"turbo {kind} {n} shards",
                         saddle_frontend_rows_sharded_kernels_turbo(mesh, *cfg), tsingle, frame))
    refs = {}
    for label, fn, single, frame in runs:   # warm-up, references
        fn(frame)
        refs[label] = single(frame)
    torch.cuda.synchronize()
    reset_launches()
    for label, fn, single, frame in runs:
        got = fn(frame)
        want = refs[label]
        bad = [k for k in Saddles._fields if not torch.equal(getattr(got, k), getattr(want, k))]
        if bad or got.p.device.type != dev.type:
            raise AssertionError(f"sharded {label} 4K: {bad} differ from the single device")
        print(f"sharded {label} 4K: {int(got.valid.sum())} saddles, bit-equal to the "
              "single-device front-end slot for slot", flush=True)
    keys = ("front_kernel[row_off]", "cluster_rochade_raw[row_off]",
            "front_kernel_decimate[row_off]", "cluster_rochade_raw[luma_f32,row_off]",
            "sparse_refine_raw")
    launches = {k: LAUNCHES[k] for k in keys}
    print(f"launches sharded front-ends: {json.dumps(launches)}", flush=True)
    for label, fn, single, frame in runs:
        ms, sms = _ms(lambda: fn(frame), 3), _ms(lambda: single(frame), 3)
        print(f"time sharded {label} 4K: {ms:.3f} ms per frame, single device {sms:.3f} ms "
              f"(shards one after another on one card) [{card}]", flush=True)
    return launches


def merge_end_to_end(card: str, batch: int) -> dict:
    """``detect_batch`` in the turbo mode with the NMS extraction and
    ``AG_NMS_MERGE=8`` on iphone and two_boards at ``batch``, held against
    the port's CPU run under the same setting (golden counts, ID sets,
    corners). Returns the launches of ``nms_extract_raw[merge]`` in the
    held runs."""
    import torch

    from aprilgrid_tpu_torch import TagDetector
    from aprilgrid_tpu_torch.kernels import LAUNCHES, reset_launches

    imgs = {n: read_png(DATA / f"{n}.png") for n in TURBO}
    with _env(AG_TURBO_NMS="1", AG_NMS_MERGE="8"):
        gpu = TagDetector("t36h11", device="cuda", decimate=True)
        cpu = TagDetector("t36h11", device="cpu", decimate=True)
        refs = {n: cpu.detect(img) for n, img in imgs.items()}
        for img in imgs.values():
            gpu.detect_batch(np.stack([img] * batch))   # warm-up
        torch.cuda.synchronize()
        reset_launches()
        for n, img in imgs.items():
            _held_run(gpu, n, img, refs[n], batch, card, "turbo-nms-m8")
        launches = {"nms_extract_raw[merge]": LAUNCHES["nms_extract_raw[merge]"],
                    "nms_extract_raw": LAUNCHES["nms_extract_raw"]}
    if launches["nms_extract_raw"]:
        raise AssertionError("turbo-nms-m8: the merge-free NMS launch ran")
    return launches


def phase_sharded(card: str, batch: int) -> tuple[dict, dict]:
    """Phase 7: the peak merge (kernel checks, then its path end to end),
    the row-sharding modes on windows of every golden and of the 4K frame,
    and the sharded front-ends on the 4K frame. Returns (launches on the
    paths — the NMS row mode's from its checks on the turbo front-end's
    windows, as nothing else calls it —, records of the six modes)."""
    import torch

    rec: dict = {}
    merge_checks(card, batch, rec)
    held = [row_off_checks(name, _gray(read_png(DATA / f"{name}.png"))) for name in GOLDEN]
    held += [row_off_checks("4K", frame_4k(), timed=True),
             row_off_checks("4K", frame_4k(u16=True))]
    rec.update(held[-2])
    launches = merge_end_to_end(card, batch)
    launches.update(sharded_frontends(card))
    launches["nms_extract_raw[row_off]"] = sum(r["nms_row_off_launches"] for r in held)
    torch.cuda.synchronize()
    return launches, rec


def sharded_rows(launches: dict, rec: dict) -> list[dict]:
    """The kernels line's rows of phase 7."""
    csrc, jp = "aprilgrid_tpu_torch/csrc/", "aprilgrid_tpu/pallas/"
    rows = [
        ("nms_extract_raw[merge]", "nms.cu", "nms.py:211", "merge"),
        ("front_kernel[row_off]", "frontend.cu", "frontend.py:357", "front_row_off"),
        ("front_kernel_decimate[row_off]", "frontend.cu", "frontend.py:703",
         "decimate_row_off"),
        ("cluster_rochade_raw[row_off]", "cluster.cu", "cluster.py:933", "cluster_row_off"),
        ("cluster_rochade_raw[luma_f32,row_off]", "cluster.cu", "cluster.py:933",
         "cluster_f32_row_off"),
        ("nms_extract_raw[row_off]", "nms.cu", "nms.py:305", "nms_row_off"),
    ]
    out = []
    for name, src, replaces, key in rows:
        n, r = launches[name], rec[key]
        if n <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        out.append({
            "name": name, "route": "cuda", "source": csrc + src, "replaces": jp + replaces,
            "launches": n, "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": None,
            "device_ms": r["device_ms"],
        })
    return out


INGEST_KEYS = ("front_kernel", "cluster_rochade_raw", "decode_packed",
               "front_kernel_decimate", "cluster_rochade_raw[luma_f32]",
               "nms_extract_raw", "sparse_refine_raw")


def _ingest_batches(img, batch: int, n: int) -> list:
    """``n`` numpy batches of ``batch`` frames of ``img``, each with blank
    frames at other places (frame i of batch k blank iff (i + k) % 4 == 0),
    so a detect that read another batch's bytes would not give its tags."""
    blank = np.full_like(img, 128)
    return [np.stack([blank if (i + k) % 4 == 0 else img for i in range(batch)])
            for k in range(n)]


def _median_ms(fn, reps: int = 3) -> float:
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[len(ms) // 2]


def ingest_sync_check(card: str, batches) -> None:
    """The prefetch's enqueue (staging into pinned memory, the copy on the
    side stream, the consumer's wait) under
    ``torch.cuda.set_sync_debug_mode("error")``: it makes the host wait for
    nothing; the uploaded tensor equals the batch."""
    import torch

    from aprilgrid_tpu_torch.detector import _HostUpload

    dev = torch.device("cuda", 0)
    side = torch.cuda.Stream(dev)
    for arr in batches:
        _HostUpload(arr, dev, side).tensor()   # warm: pinned blocks, allocator
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t = _HostUpload(arr, dev, side).tensor()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if not torch.equal(t.view(torch.uint8).cpu(), torch.from_numpy(arr.view(np.uint8))):
            raise AssertionError(f"_HostUpload {arr.dtype} {arr.shape}: bytes differ")
    print(f"ingest sync-debug: the prefetch's enqueue of {len(batches)} batches "
          f"({', '.join(str(a.dtype) for a in batches)}) makes the host wait for "
          f"nothing; bytes equal [{card}]", flush=True)


def adapter_check(card: str) -> None:
    """``to_detector_input`` on CUDA CHW tensors (RGB u8, LA u16): the
    result stays on the card, equals the CPU adapter's, and
    ``detect_adapted`` on it gives the tags of ``detect``."""
    import torch

    from aprilgrid_tpu_torch import TagDetector
    from aprilgrid_tpu_torch.adapters import detect_adapted, to_detector_input

    img = read_png(DATA / "two_boards.png")
    chw = torch.from_numpy(img).cuda().permute(2, 0, 1)
    la16 = torch.from_numpy(np.stack([img[..., 0].astype(np.uint16) * 257] * 2))
    for x in (chw, la16.view(torch.int16).cuda().view(torch.uint16)):
        got = to_detector_input(x)
        want = to_detector_input(x.view(torch.int16).cpu().view(torch.uint16)
                                 if x.dtype == torch.uint16 else x.cpu())
        if got.device != x.device or not got.is_contiguous():
            raise AssertionError(f"to_detector_input {x.dtype}: on {got.device}")
        if not torch.equal(got.view(torch.uint8).cpu(), want.view(torch.uint8)):
            raise AssertionError(f"to_detector_input {x.dtype}: differs from the CPU's")
    det = TagDetector("t36h11", device="cuda")
    tags = detect_adapted(det, chw)
    if tags != det.detect(img) or len(tags) != GOLDEN["two_boards"]:
        raise AssertionError(f"detect_adapted on a CUDA CHW tensor: {len(tags)} tags")
    print(f"ingest to_detector_input: CUDA CHW RGB u8 and LA u16 stay on {chw.device}, "
          f"= the CPU adapter; detect_adapted {len(tags)} tags = detect [{card}]",
          flush=True)


def phase_ingest(card: str, batch: int) -> tuple[dict, dict]:
    """Phase 8, ingest and multi-device: ``detect_stream`` over 4 numpy
    batches of two_boards (RGB), EuRoC (u8) and TUM_VI (u16), with the
    search on its worker and inline (the detect slowed, so the side stream
    races ahead), every batch bit-equal to ``detect_batch``; the prefetch's
    enqueue under sync-debug "error"; ``to_detector_input`` on CUDA
    tensors; ``detect_batch_sharded`` (exact, turbo drain, turbo NMS) on
    ``[cuda:0] * 2`` and ``* 4``, ``MultiCameraDetector`` on a ``camera``
    mesh of ``[cuda:0] * 2`` and ``PipelineParallelDetector`` on ``[cuda:0,
    cuda:0]``, each bit-equal to ``detect_batch``; ``cuda:1`` where a second
    card is visible. Returns (the launches of the new entry points' held
    runs, counted from 0 before each and summed; ms records)."""
    import torch

    from aprilgrid_tpu_torch import TagDetector
    from aprilgrid_tpu_torch.kernels import LAUNCHES, reset_launches
    from aprilgrid_tpu_torch.parallel.pipeline_parallel import PipelineParallelDetector
    from aprilgrid_tpu_torch.parallel.sharding import detect_batch_sharded, make_mesh
    from aprilgrid_tpu_torch.parallel.streaming import MultiCameraDetector, detect_stream

    launches = dict.fromkeys(INGEST_KEYS, 0)

    def held(fn):
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for k in INGEST_KEYS:
            launches[k] += LAUNCHES[k]
        return out

    t_phase = time.perf_counter()
    det = TagDetector("t36h11", device="cuda")
    streams = {n: _ingest_batches(read_png(DATA / f"{n}.png"), batch, 4)
               for n in ("two_boards", "EuRoC", "TUM_VI")}
    ingest_sync_check(card, [b[0] for b in streams.values()])
    for name, batches in streams.items():
        refs = [det.detect_batch(b) for b in batches]
        for what, env in (("search on its worker", "1"), ("search inline", "0")):
            with _env(AG_SEARCH_ASYNC=env):
                got = held(lambda: list(detect_stream(det, iter(batches), prefetch=2)))
            if got != refs:
                raise AssertionError(f"detect_stream {name} ({what}) differs from "
                                     "detect_batch")
        print(f"ingest detect_stream {name} {batches[0].dtype} 4 x b{batch}: every batch "
              f"bit-equal to detect_batch ({sum(len(t) for r in refs for t in r)} tags), "
              f"the search on its worker and inline [{card}]", flush=True)
    adapter_check(card)

    dev = torch.device("cuda", 0)
    frames = streams["two_boards"][1]
    rec: dict = {}
    for label, dec, nms in RUNTIME_MODES:
        with _env(**({"AG_TURBO_NMS": nms} if nms else {})):
            sdet = TagDetector("t36h11", device="cuda", decimate=dec)
            ref = sdet.detect_batch(frames)
            for n in (2, 4):
                mesh = make_mesh({"data": n}, [dev] * n)
                if held(lambda: detect_batch_sharded(sdet, frames, mesh)) != ref:
                    raise AssertionError(f"detect_batch_sharded {label} {n} shards "
                                         "differs from detect_batch")
                if label == "exact":
                    rec[f"sharded_{n}_ms"] = _median_ms(
                        lambda: detect_batch_sharded(sdet, frames, mesh))
        print(f"ingest detect_batch_sharded {label} two_boards b{batch}: [cuda:0] * 2 "
              f"and * 4 bit-equal to detect_batch [{card}]", flush=True)
    ref = det.detect_batch(frames)
    cams = MultiCameraDetector(det, make_mesh({"camera": 2}, [dev] * 2))
    got = held(lambda: cams.detect(frames.reshape((2, batch // 2) + frames.shape[1:])))
    if got != [ref[:batch // 2], ref[batch // 2:]]:
        raise AssertionError("MultiCameraDetector on a camera mesh differs from detect_batch")
    pp = PipelineParallelDetector(det, devices=[dev, dev])
    pbatches = streams["two_boards"][:3]
    got = held(lambda: list(pp.detect_batches(pbatches)))
    if got != [det.detect_batch(b) for b in pbatches]:
        raise AssertionError("PipelineParallelDetector differs from detect_batch")
    print(f"ingest MultiCameraDetector (camera mesh [cuda:0] * 2, 2 x {batch // 2} frames) "
          f"and PipelineParallelDetector ([cuda:0, cuda:0], 3 x b{batch}) bit-equal to "
          f"detect_batch [{card}]", flush=True)
    rec["detect_batch_ms"] = _median_ms(lambda: det.detect_batch(frames))
    rec["pipeline_ms"] = _median_ms(lambda: list(pp.detect_batches([frames])))
    if torch.cuda.device_count() > 1:
        two = [dev, torch.device("cuda", 1)]
        if held(lambda: detect_batch_sharded(det, frames, make_mesh({"data": 2}, two))) != ref:
            raise AssertionError("detect_batch_sharded on [cuda:0, cuda:1] differs")
        pp2 = PipelineParallelDetector(det, devices=two)
        if held(lambda: list(pp2.detect_batches([frames]))) != [ref]:
            raise AssertionError("PipelineParallelDetector on [cuda:0, cuda:1] differs")
        print(f"ingest cuda:1: detect_batch_sharded and PipelineParallelDetector on "
              f"[cuda:0, cuda:1] bit-equal to detect_batch [{card}]", flush=True)
    else:
        print("ingest cuda:1: one card visible, the launches on a second card (the "
              "device guard) were not run", flush=True)
    print(f"ingest ms two_boards b{batch} exact, median of 3 on the host clock (one card: "
          f"shards and stages run one after another): {json.dumps(rec)} [{card}]",
          flush=True)
    print(f"launches ingest and multi-device: {json.dumps(launches)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, rec


XLA_KEYS = ("front_kernel", "cluster_rochade_raw", "hamming_scan", "fused_frontend",
            "front_kernel_decimate", "cluster_rochade_raw[luma_f32]", "sparse_refine_raw")


def _tag_gap(got: dict, want: dict) -> float:
    """Largest corner distance (px) between two results with one ID set."""
    return max((float(np.abs(np.asarray(got[t]) - np.asarray(want[t])).max())
                for t in want), default=0.0)


def _event_ms(fn, reps: int) -> list:
    """Device ms of ``reps`` calls, one CUDA event pair around each."""
    import torch

    out = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return out


def _sync_count(fn) -> int:
    """The synchronizing CUDA calls ``fn`` makes: warnings under
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def _queued_ms(fn, iters: int = 50) -> float:
    """Device ms a call of ``fn``: CUDA events around ``iters`` calls
    queued behind a busy kernel (an f32 8192^3 matmul), so the card runs
    them back to back without waiting for the host's enqueue. Raises if the
    busy kernel ended before the last call was enqueued. (torch.profiler
    lost the scan's device events late in the smoke: one of ten, or none.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.randn(8192, 8192, device="cuda")
    busy_end = torch.cuda.Event()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.mm(a, a)
    busy_end.record()
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    hidden = not busy_end.query()
    torch.cuda.synchronize()
    if not hidden:
        raise AssertionError("the busy kernel ended before the calls were enqueued")
    return t0.elapsed_time(t1) / iters


def xla_split(frames) -> dict:
    """Device ms of the xla detect's parts on one batch, by CUDA events
    (mean of 3 after a warm-up): the front-end (``saddle_frontend_batch``),
    the tail (``detect_tail``: both passes' search and decode) and each
    pass's decode (``decode_quads_batch`` on the inputs the tail gave it);
    the search is the tail minus the decodes."""
    import torch

    from aprilgrid_tpu_torch import pipeline
    from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
    from aprilgrid_tpu_torch.families import get_family

    cfg = (DEFAULT_PARAMS, CONSTANTS, DEFAULT_CAPACITIES)
    spec = get_family("t36h11")
    hw = (int(frames.shape[1]), int(frames.shape[2]))
    front = _ms(lambda: pipeline.saddle_frontend_batch(frames, *cfg), 3)
    saddles, luma8, _ = pipeline.saddle_frontend_batch(frames, *cfg)

    def tail():
        return pipeline.detect_tail(saddles, luma8, spec, *cfg, hw,
                                    slots_full=saddles.valid.all(-1))

    tail_ms = _ms(tail, 3)
    calls, decode = [], pipeline.decode_quads_batch

    def captured(*a, **kw):
        calls.append((a, kw))
        return decode(*a, **kw)

    pipeline.decode_quads_batch = captured
    try:
        tail()
    finally:
        pipeline.decode_quads_batch = decode
    dec = [_ms(lambda a=a, kw=kw: decode(*a, **kw), 3) for a, kw in calls]
    return {"front_ms": front, "tail_ms": tail_ms, "decode_ms": dec,
            "search_ms": tail_ms - sum(dec)}


def phase_xla(card: str, batch: int) -> tuple[dict, dict]:
    """Phase 9, the xla mode (the whole detect on the card): ``detect_batch``
    at ``batch`` on the four golden images — the golden count on every
    frame, ID sets equal to the hybrid's on the same batch with corners
    within 1e-4 px, the first frame equal to the port's CPU xla run;
    ``detect`` on two_boards (the single-image plane path); ``decimate=True``
    on iphone and two_boards against the hybrid turbo drain (1e-3 px);
    ``detect_batch_sharded`` on ``[cuda:0] * 2`` bit-equal to
    ``detect_batch``; the standalone ``hamming_scan`` on the inputs this path
    gave it, against its plain version. Records: frames/s (median and
    spread of 5, CUDA events) beside the hybrid's, the ms split, the host's
    syncs a batch, the device-busy share, the peak device memory. Returns
    (each kernel's launches in the held runs, counted from 0 before each
    and summed; the scan's record)."""
    import torch

    from aprilgrid_tpu_torch import TagDetector
    from aprilgrid_tpu_torch.kernels import LAUNCHES, reset_launches
    from aprilgrid_tpu_torch.kernels import decode as kdecode
    from aprilgrid_tpu_torch.ops.board import SYNCS
    from aprilgrid_tpu_torch.parallel.sharding import detect_batch_sharded, make_mesh
    from aprilgrid_tpu_torch.utils.profiling import device_busy

    t_phase = time.perf_counter()
    launches = dict.fromkeys(XLA_KEYS, 0)

    def held(fn):
        torch.cuda.synchronize()
        reset_launches()
        SYNCS.update(dict.fromkeys(SYNCS, 0))
        out = fn()
        torch.cuda.synchronize()
        for k in XLA_KEYS:
            launches[k] += LAUNCHES[k]
        return out

    xgpu = TagDetector("t36h11", device="cuda", mode="xla")
    hgpu = TagDetector("t36h11", device="cuda")
    xcpu = TagDetector("t36h11", device="cpu", mode="xla")
    imgs = {n: read_png(DATA / f"{n}.png") for n in GOLDEN}
    scans: list = []
    scan = kdecode.hamming_scan

    def captured(rots, codes):
        if not scans:
            scans.append((rots.clone(), codes))
        return scan(rots, codes)

    recs: dict = {}
    for name, img in imgs.items():
        frames = torch.from_numpy(np.stack([img] * batch)).cuda()
        xgpu.detect_batch(frames)   # warm-up: builds, allocator, tables
        if name == "two_boards":
            kdecode.hamming_scan = captured
        try:
            res = held(lambda: xgpu.detect_batch(frames))
        finally:
            kdecode.hamming_scan = scan
        loops = dict(SYNCS)
        hyb = hgpu.detect_batch(frames)
        for i, tags in enumerate(res):
            if len(tags) != GOLDEN[name]:
                raise AssertionError(f"xla {name} frame {i}: {len(tags)} tags, "
                                     f"golden {GOLDEN[name]}")
            if set(tags) != set(hyb[i]):
                raise AssertionError(f"xla {name} frame {i}: ID set differs from the hybrid")
        gap = max(_tag_gap(r, h) for r, h in zip(res, hyb))
        if gap > 1e-4:
            raise AssertionError(f"xla {name}: corners {gap} px from the hybrid")
        cpu = xcpu.detect_batch(img[None])[0]
        if set(cpu) != set(res[0]) or _tag_gap(res[0], cpu) > 1e-4:
            raise AssertionError(f"xla {name}: frame 0 differs from the CPU xla run")
        xms = _event_ms(lambda: xgpu.detect_batch(frames), 5)
        hms = _event_ms(lambda: hgpu.detect_batch(frames), 5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        syncs = _sync_count(lambda: xgpu.detect_batch(frames))
        peak = torch.cuda.max_memory_allocated() / 2**20
        busy = device_busy(lambda: xgpu.detect_batch(frames))
        r = {
            "frames_per_s": {"median": batch / statistics.median(xms) * 1e3,
                             "min": batch / max(xms) * 1e3, "max": batch / min(xms) * 1e3},
            "hybrid_frames_per_s": {"median": batch / statistics.median(hms) * 1e3,
                                    "min": batch / max(hms) * 1e3,
                                    "max": batch / min(hms) * 1e3},
            "call_ms": xms, "hybrid_call_ms": hms, "loop_reads": loops,
            "host_syncs": syncs, "device_busy": busy, "peak_mib": peak,
            "corner_gap_hybrid_px": gap, "corner_gap_cpu_px": _tag_gap(res[0], cpu),
            "cpu_bit_equal": cpu == res[0], "split": xla_split(frames),
        }
        recs[name] = r
        print(f"xla {name} {img.shape} b{batch}: {GOLDEN[name]} tags on every frame, ID "
              f"sets = the hybrid's (max corner gap {gap:.2e} px), frame 0 = the CPU xla "
              f"run (gap {r['corner_gap_cpu_px']:.2e} px, bit-equal {r['cpu_bit_equal']}); "
              f"record {json.dumps(r)} [{card}]", flush=True)

    # one image, the single-image front-end (the plane path)
    tb = imgs["two_boards"]
    one = held(lambda: xgpu.detect(tb))
    ref = hgpu.detect(tb)
    if len(one) != GOLDEN["two_boards"] or set(one) != set(ref) or _tag_gap(one, ref) > 1e-3:
        raise AssertionError("xla detect on two_boards differs from the hybrid")
    print(f"xla detect two_boards (one image, plane path): {len(one)} tags = the hybrid's "
          f"(gap {_tag_gap(one, ref):.2e} px) [{card}]", flush=True)

    # the turbo path, against the hybrid turbo's drain (the xla mode's
    # extraction without AG_TURBO_NMS=1)
    with _env(AG_TURBO_NMS="0"):
        txgpu = TagDetector("t36h11", device="cuda", mode="xla", decimate=True)
        thgpu = TagDetector("t36h11", device="cuda", decimate=True)
        for name in TURBO:
            frames = torch.from_numpy(np.stack([imgs[name]] * batch)).cuda()
            txgpu.detect_batch(frames)
            res = held(lambda: txgpu.detect_batch(frames))
            hyb = thgpu.detect_batch(frames)
            for i, tags in enumerate(res):
                if len(tags) != GOLDEN[name] or set(tags) != set(hyb[i]):
                    raise AssertionError(f"xla turbo {name} frame {i}: {len(tags)} tags, "
                                         "or an ID set other than the hybrid turbo's")
            gap = max(_tag_gap(r, h) for r, h in zip(res, hyb))
            if gap > 1e-3:
                raise AssertionError(f"xla turbo {name}: corners {gap} px from the hybrid")
            xms = _event_ms(lambda: txgpu.detect_batch(frames), 5)
            print(f"xla turbo {name} b{batch}: {GOLDEN[name]} tags on every frame = the "
                  f"hybrid turbo drain (max corner gap {gap:.2e} px); "
                  f"{batch / statistics.median(xms) * 1e3:.1f} frames/s median of 5 "
                  f"(min {batch / max(xms) * 1e3:.1f}, max {batch / min(xms) * 1e3:.1f}) "
                  f"[{card}]", flush=True)

    # the standalone scan on the inputs the path gave it (two_boards' first pass)
    rots, codes = scans[0]
    m, i = kdecode.hamming_scan(rots, codes)
    pm, pi = kdecode.hamming_scan_plain(rots, codes)
    if not (torch.equal(m, pm) and torch.equal(i, pi)):
        raise AssertionError("hamming_scan differs from its plain version on the xla path")
    n_rows = rots.shape[0] * rots.shape[1]
    n_codes, nb = codes.shape
    # ms by CUDA events over back-to-back calls (host enqueue included),
    # device_ms with the calls queued ahead (the card's time alone)
    hrec = dict(
        err=0.0, ms=_ms(lambda: kdecode.hamming_scan(rots, codes), 50),
        plain_ms=_ms(lambda: kdecode.hamming_scan_plain(rots, codes), 5),
        bound=_bound_ms(4.0 * (n_rows + n_codes) * nb + 8.0 * n_rows,
                        3.0 * n_rows * n_codes),
        device_ms=_queued_ms(lambda: kdecode.hamming_scan(rots, codes)),
        shape=list(rots.shape),
    )
    print(f"xla hamming_scan on the path's rows {tuple(rots.shape)} vs t36h11: exact; "
          f"{hrec['ms']:.4f} ms (device {hrec['device_ms']:.4f}, plain "
          f"{hrec['plain_ms']:.4f}, bound {hrec['bound'][0]:.4f}) [{card}]", flush=True)

    frames = torch.from_numpy(np.stack([tb] * batch)).cuda()
    want = xgpu.detect_batch(frames)
    mesh = make_mesh({"data": 2}, [torch.device("cuda", 0)] * 2)
    if held(lambda: detect_batch_sharded(xgpu, frames, mesh)) != want:
        raise AssertionError("detect_batch_sharded xla on [cuda:0] * 2 differs from "
                             "detect_batch")
    print(f"xla detect_batch_sharded two_boards b{batch} on [cuda:0] * 2: bit-equal to "
          f"detect_batch [{card}]", flush=True)

    for k in XLA_KEYS:
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the xla path")
    print(f"launches xla path: {json.dumps(launches)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, {"hamming": hrec, "images": recs}

# family, border bits, tags in x and y, first ID: tests/test_boards.py's five
# FAMILIES and its offset board
CHART_BOARDS = (("t16h5", 2, 4, 4, 0), ("t25h7", 2, 5, 5, 0), ("t25h9", 2, 5, 5, 0),
                ("t36h11", 2, 6, 6, 0), ("t36h11b1", 1, 6, 6, 0), ("t36h11", 2, 2, 2, 10))
CHART_MODES = (("exact", {}), ("turbo", {"decimate": True}), ("xla", {"mode": "xla"}))
# the kernels phase 10 must launch; the turbo extraction is one of the two
SURFACE_KEYS = ("front_kernel", "cluster_rochade_raw", "decode_packed",
                "front_kernel_decimate", "sparse_refine_raw", "fused_frontend",
                "hamming_scan")


def _http_get(port: int, path: str) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read()


def _overlay_mask(shape, gpu: dict, cpu: dict, gs: list, cs: list) -> np.ndarray:
    """Pixels an overlay may change where the card's and the CPU run's
    layers differ: the box (+12 px, for the label) of each tag whose corners
    differ, and +8 px around each saddle that differs."""
    mask = np.zeros(shape[:2], bool)
    h, w = shape[:2]

    def box(x0, y0, x1, y1, m):
        mask[max(int(y0) - m, 0):max(min(int(y1) + m + 1, h), 0),
             max(int(x0) - m, 0):max(min(int(x1) + m + 1, w), 0)] = True

    for t in gpu:
        if gpu[t] != cpu[t]:
            c = np.asarray(gpu[t] + cpu[t])
            box(c[:, 0].min(), c[:, 1].min(), c[:, 0].max(), c[:, 1].max(), 12)
    for a, b in zip(gs, cs):
        if (a.p, a.theta) != (b.p, b.theta):
            for q in (a.p, b.p):
                box(q[0], q[1], q[0], q[1], 8)
    return mask


def phase_surfaces(card: str, batch: int) -> dict:
    """Phase 10, the overlay, live-stream and chart surfaces through the
    port alone (what tests/test_boards.py, examples/demo.py and
    examples/live.py run against the JAX package): (a) the charts of every
    family from ``boards.generator.render_png`` at 2 px/mm, ``detect_batch``
    on ``batch`` copies exact and turbo and on 2 in the xla mode, each frame
    equal to the CPU run of its mode (IDs, corners within 1e-3 px), exact
    with every ID; (b) the demo path on the four golden images as PIL
    hands them over (read-only arrays): ``detect``, ``refined_saddle_points``
    and ``decode_positions_px`` on the card, the golden counts, the
    overlays by ``viz.dump_overlay`` equal to ``render_overlay`` of the CPU
    results outside the boxes of the elements that differ,
    ``write_timeline_html`` over the four; (c) ``live.LiveStream`` on
    127.0.0.1 serving each frame's card results; (d)
    ``utils/profiling.py``'s ``detect_stage_report`` and ``trace`` on the
    card. Returns each kernel's launches in those runs (counted from 0
    before each and summed)."""
    import tempfile
    import warnings

    import torch
    from PIL import Image

    from aprilgrid_tpu_torch import TagDetector, get_family
    from aprilgrid_tpu_torch import viz
    from aprilgrid_tpu_torch.boards.generator import AprilGridBoard, render_png
    from aprilgrid_tpu_torch.kernels import LAUNCHES, reset_launches
    from aprilgrid_tpu_torch.live import LiveStream
    from aprilgrid_tpu_torch.ops.board import SYNCS
    from aprilgrid_tpu_torch.ops.decode import decode_positions_px
    from aprilgrid_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    launches = dict.fromkeys(LAUNCHES, 0)

    def held(fn):
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for k in LAUNCHES:
            launches[k] += LAUNCHES[k]
        return out

    # -- (a) the charts of every family
    for family, border, sx, sy, first in CHART_BOARDS:
        board = AprilGridBoard(size_x=sx, size_y=sy, tag_family=family,
                               border_bits=border, first_marker=first)
        chart = render_png(board, pixels_per_mm=2.0)
        want = list(range(first, first + sx * sy))
        label = f"{family} {sx}x{sy} from {first}"
        for mode, kw in CHART_MODES:
            n = 2 if mode == "xla" else batch
            gpu = TagDetector(family, device="cuda", **kw)
            frames = torch.from_numpy(np.stack([chart] * n)).cuda()
            gpu.detect_batch(frames)   # warm-up: builds, allocator, tables
            SYNCS.update(dict.fromkeys(SYNCS, 0))
            res = held(lambda: gpu.detect_batch(frames))
            # the xla search's loop-condition reads (growth sweeps + group checks)
            reads = f", loop reads {json.dumps(SYNCS)}" if mode == "xla" else ""
            ref = TagDetector(family, device="cpu", **kw).detect_batch(chart[None])[0]
            for i, tags in enumerate(res):
                if mode == "exact" and sorted(tags) != want:
                    raise AssertionError(f"chart {label} exact frame {i}: IDs "
                                         f"{sorted(tags)}, want {want}")
                if set(tags) != set(ref) or _tag_gap(tags, ref) > 1e-3:
                    raise AssertionError(f"chart {label} {mode} frame {i}: differs from "
                                         "the CPU run of its mode")
            ms = _event_ms(lambda: gpu.detect_batch(frames), 3)
            print(f"chart {label} {chart.shape} {mode} b{n}: {len(res[0])}/{len(want)} IDs "
                  f"on every frame = the CPU run (max corner gap "
                  f"{max(_tag_gap(t, ref) for t in res):.2e} px); "
                  f"{n / statistics.median(ms) * 1e3:.1f} frames/s median of 3{reads} "
                  f"[{card}]", flush=True)

    # -- (b) the demo path, (c) the live stream
    gpu = TagDetector("t36h11", device="cuda")
    cpu = TagDetector("t36h11", device="cpu")
    spec = get_family("t36h11")

    def decode_points(tags, w, h):
        # each tag's bit-cell sample points, as examples/demo.py draws them
        out = {}
        for tid, corners in tags.items():
            pts = decode_positions_px(corners, spec, 0.5, w, h)
            if pts is not None:
                out[tid] = [tuple(q) for q in pts]
        return out

    entries, rec = [], {}
    stream = LiveStream(port=0).start()
    try:
        with tempfile.TemporaryDirectory() as out, warnings.catch_warnings():
            # the frames are read-only: PyTorch's warning on them is a fault
            warnings.filterwarnings("error", "The given NumPy array is not writable")
            for i, name in enumerate(GOLDEN):
                img = np.asarray(Image.open(DATA / f"{name}.png"))
                h, w = img.shape[:2]
                gpu.detect(img)   # warm-up
                t0 = time.perf_counter()
                tags = held(lambda: gpu.detect(img))
                t1 = time.perf_counter()
                saddles = held(lambda: gpu.refined_saddle_points(img))
                t2 = time.perf_counter()
                points = decode_points(tags, w, h)
                layers = dict(tags=tags, saddles=saddles, decode_points=points)
                t3 = time.perf_counter()
                viz.render_overlay(img, **layers)
                t4 = time.perf_counter()
                path = viz.dump_overlay(os.path.join(out, f"{name}_overlay.png"), img,
                                        **layers)
                t5 = time.perf_counter()
                if len(tags) != GOLDEN[name]:
                    raise AssertionError(f"demo {name}: {len(tags)} tags, golden "
                                         f"{GOLDEN[name]}")
                ctags, csad = cpu.detect(img), cpu.refined_saddle_points(img)
                if set(ctags) != set(tags) or len(csad) != len(saddles):
                    raise AssertionError(f"demo {name}: tags or saddles differ from the "
                                         "CPU run")
                gap = _tag_gap(tags, ctags)
                sgap = max(max(abs(a.p[0] - b.p[0]), abs(a.p[1] - b.p[1]))
                           for a, b in zip(saddles, csad))
                tgap = max(abs(a.theta - b.theta) for a, b in zip(saddles, csad))
                if gap > 1e-3 or sgap > 1e-3 or tgap > 1e-3:
                    raise AssertionError(f"demo {name}: corners {gap} px, saddles {sgap} "
                                         f"px, orientations {tgap} deg from the CPU run")
                want = viz.render_overlay(img, tags=ctags, saddles=csad,
                                          decode_points=decode_points(ctags, w, h))
                with Image.open(path) as im:
                    got = np.asarray(im)
                keep = ~_overlay_mask(img.shape, tags, ctags, saddles, csad)
                if got.shape != want.shape or not (got[keep] == want[keep]).all():
                    raise AssertionError(f"demo {name}: overlay differs from the CPU "
                                         "run's outside the differing elements")
                raw = f"{name}_raw.png"
                Image.fromarray(img if img.ndim == 3 or img.dtype == np.uint8
                                else (img // 257).astype(np.uint8)).save(
                                    os.path.join(out, raw))
                entries.append({
                    "image": raw, "timeline_ns": int(i * 1e9 / 60),
                    "detect_ms": round((t1 - t0) * 1e3, 2),
                    "tags": {int(t): [[float(x), float(y)] for x, y in c]
                             for t, c in tags.items()},
                    "decode_points": {int(t): [[float(x), float(y)] for x, y in p]
                                      for t, p in points.items()},
                    "saddles": [[s.p[0], s.p[1], s.theta] for s in saddles],
                })
                # (c) publish the card's results, read them back
                t6 = time.perf_counter()
                stream.publish(img, **layers)
                t7 = time.perf_counter()
                jpeg = _http_get(stream.port, "/latest.jpg")
                if jpeg[:2] != b"\xff\xd8":
                    raise AssertionError(f"live {name}: /latest.jpg is no JPEG")
                with Image.open(io.BytesIO(jpeg)) as im:
                    if im.size != (w, h):
                        raise AssertionError(f"live {name}: JPEG {im.size}, frame {(w, h)}")
                state = json.loads(_http_get(stream.port, "/state.json"))
                if state != {"frame": i + 1, "tags": sorted(tags), "n_tags": len(tags),
                             "n_saddles": len(saddles)}:
                    raise AssertionError(f"live {name}: /state.json {state}")
                same = gap == 0.0 and sgap == 0.0 and tgap == 0.0
                rec[name] = {"detect_ms": (t1 - t0) * 1e3, "saddles_ms": (t2 - t1) * 1e3,
                             "render_ms": (t4 - t3) * 1e3, "dump_ms": (t5 - t4) * 1e3,
                             "png_write_ms": (t5 - t4 - (t4 - t3)) * 1e3,
                             "publish_ms": (t7 - t6) * 1e3, "tags": len(tags),
                             "saddles": len(saddles), "corner_gap_px": gap,
                             "saddle_gap_px": sgap, "theta_gap_deg": tgap,
                             "cpu_bit_equal": same,
                             "overlay_pixels_compared": int(keep.sum())}
                print(f"demo {name} {img.shape} {img.dtype}: {len(tags)} tags, "
                      f"{len(saddles)} saddles on the card = the CPU run (corner gap "
                      f"{gap:.2e} px, saddle gap {sgap:.2e} px, theta gap {tgap:.2e} deg, "
                      f"bit-equal {same}); overlay "
                      f"= the CPU run's on {int(keep.sum())}/{keep.size} pixels; /latest.jpg "
                      f"{len(jpeg)} bytes {w}x{h}, /state.json frame {i + 1}; record "
                      f"{json.dumps(rec[name])} [{card}]", flush=True)
            html = viz.write_timeline_html(out, entries).read_text()
            data = json.loads(re.search(r"const F=(\[.*?\]);let", html, re.S).group(1))
            if [len(e["tags"]) for e in data] != [GOLDEN[n] for n in GOLDEN]:
                raise AssertionError("timeline.html: embedded tag counts differ from golden")
        # one multipart chunk of the stream: the last frame's JPEG
        with urllib.request.urlopen(f"http://127.0.0.1:{stream.port}/stream.mjpg",
                                    timeout=10) as r:
            if "multipart/x-mixed-replace" not in r.headers["Content-Type"]:
                raise AssertionError("live: /stream.mjpg is not multipart")
            if r.readline() != b"--frame\r\n" or r.readline() != b"Content-Type: image/jpeg\r\n":
                raise AssertionError("live: /stream.mjpg chunk header")
            size = int(r.readline().split(b":")[1])
            r.readline()
            if r.read(size) != jpeg:
                raise AssertionError("live: the stream's chunk is not the last frame")
    finally:
        stream.stop()
    print(f"demo timeline.html: {len(data)} frames, tag counts "
          f"{[len(e['tags']) for e in data]}; live /stream.mjpg chunk = /latest.jpg "
          f"({size} bytes) [{card}]", flush=True)

    # -- (d) the profiling utilities on the card
    frames = torch.from_numpy(np.stack([read_png(DATA / "two_boards.png")] * 32)).cuda()
    report = held(lambda: profiling.detect_stage_report(gpu, frames, reps=1))
    if "board search" not in report or "total" not in report:
        raise AssertionError(f"detect_stage_report: {report}")
    print(f"detect_stage_report two_boards b32 on the card [{card}]:\n{report}", flush=True)
    with tempfile.TemporaryDirectory() as tdir:
        with profiling.trace(tdir):
            held(lambda: gpu.detect_batch(frames))
        with open(os.path.join(tdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("profiling.trace wrote no CUDA kernel event")
    print(f"profiling.trace around detect_batch two_boards b32: {len(events)} events, "
          f"{len(kernels)} CUDA kernel events ({len({e['name'] for e in kernels})} "
          f"names) [{card}]", flush=True)

    for k in SURFACE_KEYS:
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the surfaces' path")
    if launches["cluster_rochade_raw[luma_f32]"] + launches["nms_extract_raw"] <= 0:
        raise AssertionError("no turbo extraction kernel was launched on the charts")
    print(f"launches surfaces: {json.dumps({k: n for k, n in launches.items() if n})}; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# the kernels phase 11 must launch: rows 1-6 and 8 (row 3 as decode_packed)
# and the standalone scan (the xla demo's decode)
EXAMPLE_KEYS = ("front_kernel", "cluster_rochade_raw", "decode_packed",
                "front_kernel_decimate", "nms_extract_raw", "sparse_refine_raw",
                "fused_frontend", "hamming_scan")
DEMO_RUNS = (("exact", ()), ("turbo", ("--turbo",)), ("xla", ("--mode", "xla")))
RIG = (4, 8, 2)   # the 4K rig: cameras, steps, timed reps


def _printed(fn) -> tuple:
    """``fn()``'s return value and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn()
    return rc, out.getvalue()


def _demo_output(out: str) -> tuple[list, list]:
    """A demo run's manifest lines and the frames its timeline.html embeds."""
    with open(os.path.join(out, "manifest.jsonl")) as f:
        manifest = [json.loads(line) for line in f]
    with open(os.path.join(out, "timeline.html")) as f:
        html = f.read()
    return manifest, json.loads(re.search(r"const F=(\[.*?\]);let", html, re.S).group(1))


def _frame_gaps(got: dict, want: dict) -> tuple[float, float, float, float]:
    """Two timeline frames with the same tag IDs and saddle counts: the
    largest gaps of their corners, decode points and saddle positions (px)
    and saddle orientations (deg)."""
    sg, sw = np.asarray(got["saddles"]), np.asarray(want["saddles"])
    return (_tag_gap(got["tags"], want["tags"]),
            _tag_gap(got["decode_points"], want["decode_points"]),
            float(np.abs(sg[:, :2] - sw[:, :2]).max(initial=0.0)),
            float(np.abs(sg[:, 2] - sw[:, 2]).max(initial=0.0)))


def phase_examples(card: str) -> dict:
    """Phase 11, the port's runnable examples and the 4K rig, as a user
    runs them: (a) ``examples.demo`` in-process on a directory linking the
    four golden images, exact, ``--turbo`` and ``--mode xla`` on the card
    — the golden count on every frame; the exact run against the CPU run
    of the same example (IDs equal; corners, decode points and saddles
    within 1e-3 px; orientations within 1e-3 deg); the turbo and xla runs
    with the exact run's IDs, corners within 0.1 px of it; (b) one
    ``python3 -m aprilgrid_tpu_torch.examples.demo`` subprocess: exit 0,
    golden counts in its manifest; (c) ``examples.develop`` on two_boards:
    the CPU run's counts; (d) ``examples.live`` for one loop on a free
    port: golden tag counts and the demo's saddle counts; (e) the 4K rig
    through ``bench.bench_4k`` at 4 cameras x 8 steps, 2 reps, exact and
    turbo: 72 tags on every frame, parity with the CPU run of one frame.
    ``detect_ms`` is the demo's own measure, the wall time of ``detect``:
    the first frame of a run includes its first-use warm-up. Returns each
    kernel's launches in the card's runs (counted from 0 before each and
    summed)."""
    import subprocess
    import tempfile

    import torch

    from aprilgrid_tpu_torch.bench import bench_4k
    from aprilgrid_tpu_torch.examples import demo, develop, live
    from aprilgrid_tpu_torch.kernels import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    launches = dict.fromkeys(LAUNCHES, 0)

    def held(fn):
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for k in LAUNCHES:
            launches[k] += LAUNCHES[k]
        return out

    golden = {f"{name}.png": n for name, n in GOLDEN.items()}
    with tempfile.TemporaryDirectory() as tdir:
        frames = os.path.join(tdir, "frames")
        os.mkdir(frames)
        for name in GOLDEN:
            os.symlink(DATA / f"{name}.png", os.path.join(frames, f"{name}.png"))

        def run_demo(label, *flags, device="cuda"):
            out = os.path.join(tdir, f"demo_{label}_{device}")
            argv = ["--dir", frames, "--out", out, "--device", device, *flags]
            call = lambda: _printed(lambda: demo.main(argv))  # noqa: E731
            rc, _ = held(call) if device == "cuda" else call()
            manifest, entries = _demo_output(out)
            counts = {m["frame"]: m["n_tags"] for m in manifest}
            if rc != 0 or counts != golden:
                raise AssertionError(f"demo {label} {device}: rc {rc}, counts {counts}")
            return manifest, entries

        # -- (a) the demo in-process: exact, turbo, xla on the card; exact on the CPU
        runs = {label: run_demo(label, *flags) for label, flags in DEMO_RUNS}
        _, cpu = run_demo("exact", device="cpu")
        names = [m["frame"] for m in runs["exact"][0]]
        exact = runs["exact"][1]
        for name, e, c in zip(names, exact, cpu):
            if set(e["tags"]) != set(c["tags"]) or len(e["saddles"]) != len(c["saddles"]):
                raise AssertionError(f"demo exact {name}: IDs or saddle count differ from "
                                     "the CPU run")
            gaps = _frame_gaps(e, c)
            if max(gaps) > 1e-3:
                raise AssertionError(f"demo exact {name}: corner, decode point, saddle and "
                                     f"orientation gaps {gaps} from the CPU run")
            print(f"demo exact {name}: {len(e['tags'])} tags, {len(e['saddles'])} "
                  f"saddles = the CPU run's (corner / decode point / saddle gap "
                  f"{gaps[0]:.2e} / {gaps[1]:.2e} / {gaps[2]:.2e} px, orientation "
                  f"{gaps[3]:.2e} deg) [{card}]", flush=True)
        for label in ("turbo", "xla"):
            for name, e, r in zip(names, exact, runs[label][1]):
                if set(r["tags"]) != set(e["tags"]):
                    raise AssertionError(f"demo {label} {name}: IDs differ from exact")
                gap = _tag_gap(r["tags"], e["tags"])
                if gap > 0.1:
                    raise AssertionError(f"demo {label} {name}: corners {gap} px from exact")
        for label, (manifest, _) in runs.items():
            print(f"demo {label} detect_ms per frame (wall time of detect, the first "
                  f"frame with its warm-up): "
                  f"{json.dumps({m['frame']: m['detect_ms'] for m in manifest})} [{card}]",
                  flush=True)

        # -- (b) the demo as a user starts it
        out = os.path.join(tdir, "demo_subprocess")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "aprilgrid_tpu_torch.examples.demo", "--dir", frames,
             "--out", out], capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            raise AssertionError(f"demo subprocess exit {proc.returncode}: {proc.stderr}")
        manifest, _ = _demo_output(out)
        if {m["frame"]: m["n_tags"] for m in manifest} != golden:
            raise AssertionError(f"demo subprocess: counts {manifest}")
        print(f"demo subprocess: exit 0, golden counts, {time.perf_counter() - t0:.1f} s; "
              f"detect_ms {json.dumps({m['frame']: m['detect_ms'] for m in manifest})} "
              f"[{card}]", flush=True)

        # -- (c) develop on two_boards, card and CPU
        pattern = r"refined saddles: (\d+)\nboard quads: (\d+)\ndecoded tags: (\d+)\n"
        counts = {}
        for device in ("cuda", "cpu"):
            argv = [str(DATA / "two_boards.png"), "--out",
                    os.path.join(tdir, f"develop_{device}.png"), "--device", device]
            call = lambda: _printed(lambda: develop.main(argv))  # noqa: E731
            rc, text = held(call) if device == "cuda" else call()
            if rc != 0:
                raise AssertionError(f"develop two_boards {device}: rc {rc}")
            counts[device] = re.findall(pattern, text)
        if counts["cuda"] != counts["cpu"] or len(counts["cuda"]) != 1 \
                or int(counts["cuda"][0][2]) != GOLDEN["two_boards"]:
            raise AssertionError(f"develop two_boards: {counts}")
        print(f"develop two_boards: saddles, quads, tags {counts['cuda'][0]} = the CPU "
              f"run's [{card}]", flush=True)

        # -- (d) live, one loop on a free port
        argv = ["--dir", frames, "--loops", "1", "--fps", "1000", "--port", "0"]
        rc, text = held(lambda: _printed(lambda: live.main(argv)))
        port = int(re.search(r"live viewer: http://127\.0\.0\.1:(\d+)/", text).group(1))
        seen = {m[0]: (int(m[1]), int(m[2])) for m in re.findall(
            r"(?m)^(\S+\.png): (\d+) tags, (\d+) saddles, \d+ ms$", text)}
        want = {m["frame"]: (m["n_tags"], len(e["saddles"])) for m, e in zip(*runs["exact"])}
        if rc != 0 or port <= 0 or seen != want:
            raise AssertionError(f"live: rc {rc}, port {port}, {seen} against {want}")
        print(f"live on port {port}: tags and saddles per frame {json.dumps(seen)} = "
              f"golden and the demo's [{card}]", flush=True)

    # -- (e) the 4K rig
    cams, steps, reps = RIG
    for rec in held(lambda: list(bench_4k("cuda", cams, steps, reps))):
        if not rec["ids_equal"] or rec["corner_max_px"] > 1e-3:
            raise AssertionError(f"4K {rec['mode']}: parity {rec['ids_equal']}, corners "
                                 f"{rec['corner_max_px']} px from the CPU run")
        fps = rec["frames_per_s"]
        print(f"4K rig {rec['mode']} {cams} cams x {steps} steps, {rec['tags']} tags on "
              f"every frame = the CPU run (corner gap {rec['corner_max_px']:.2e} px): "
              f"{fps['median']:.1f} frames/s median of {reps} ({fps['min']:.1f}-"
              f"{fps['max']:.1f}), chunk {rec['chunk']}, record {json.dumps(rec)} "
              f"[{card}]", flush=True)

    for k in EXAMPLE_KEYS:
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the examples' path")
    print(f"launches examples: {json.dumps({k: n for k, n in launches.items() if n})}; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phase 2)")
    ap.add_argument("--cluster-only", action="store_true",
                    help="build, then only the kernel checks on two_boards and the "
                         "cluster entries' per-launch split")
    ap.add_argument("--front-only", action="store_true",
                    help="build, then only front_kernel: both modes bit-equal on the "
                         "four images and on synthetic frames, per-launch split, "
                         "event ms and ptxas")
    ap.add_argument("--decimate-only", action="store_true",
                    help="build, then only front_kernel_decimate: bit-equal on the "
                         "four images and on synthetic frames (a misaligned raw "
                         "pointer included), per-launch split, event ms and ptxas")
    ap.add_argument("--decode-only", action="store_true",
                    help="build, then only the decode kernels' checks and the "
                         "split of each pass's decode (host ms, device operations, "
                         "the idle gap before the scan), the hamming_scan probe "
                         "and ptxas")
    ap.add_argument("--runtime-only", action="store_true",
                    help="build, then only the hybrid runtime at batch 128: sync-debug "
                         "dispatches, every frame against the CPU run, bit-equal "
                         "schedules, timeline sums, frames/s, device busy")
    ap.add_argument("--sharded-only", action="store_true",
                    help="build, then only phase 7: the peak merge bit-equal on the "
                         "four images and end to end, the row-sharding modes on "
                         "windows, the sharded front-ends on the 4K frame")
    ap.add_argument("--ingest-only", action="store_true",
                    help="build, then only phase 8: detect_stream, the adapters, "
                         "detect_batch_sharded, MultiCameraDetector and "
                         "PipelineParallelDetector bit-equal to detect_batch")
    ap.add_argument("--xla-only", action="store_true",
                    help="build, then only phase 9: the xla mode (the whole detect on "
                         "the card) against the hybrid and the CPU run, its records")
    ap.add_argument("--viz-only", action="store_true",
                    help="build, then only phase 10: the charts of every family, the "
                         "demo path with its overlays and timeline, the live stream "
                         "and the profiling utilities, all through the port on the card")
    ap.add_argument("--examples-only", action="store_true",
                    help="build, then only phase 11: the demo, develop and live "
                         "examples and the 4K rig bench on the card")
    ap.add_argument("--turbo-only", action="store_true",
                    help="build, then only the turbo path's kernel checks (all four "
                         "images, the NMS and refine synthetic cases) and the "
                         "per-launch split of nms_extract_raw and sparse_refine_raw")
    ap.add_argument("--split-only", action="store_true",
                    help="build, then only the per-launch split of the NMS at m0 and m8 "
                         "and of the kernels that share its tile passes, with ptxas "
                         "(run from a parent's tree too, to compare two versions)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = phase_build()
    if args.front_only:
        front_synthetic_check()
        phase_front_split(card, batch=32)
        return 0
    if args.decimate_only:
        front_decimate_synthetic_check()
        phase_decimate_split(card, batch=32)
        return 0
    if args.decode_only:
        rec = decode_checks(batch=32)
        _print_times(card, list(rec.items()))
        phase_decode_split(card, batch=32)
        return 0
    if args.runtime_only:
        phase_runtime(card, batch=128)
        return 0
    if args.sharded_only:
        launches, srec = phase_sharded(card, batch=32)
        print(json.dumps({"kernels": sharded_rows(launches, srec)}))
        return 0
    if args.ingest_only:
        phase_ingest(card, batch=32)
        return 0
    if args.xla_only:
        phase_xla(card, batch=16)
        return 0
    if args.viz_only:
        phase_surfaces(card, batch=8)
        return 0
    if args.examples_only:
        phase_examples(card)
        return 0
    if args.split_only:
        phase_launch_split(card, batch=32)
        return 0
    if args.turbo_only:
        rec: dict = {n: {} for n in GOLDEN}
        for name in GOLDEN:
            img = torch.from_numpy(read_png(DATA / f"{name}.png")).cuda()
            frames = img[None].expand(32 if name in TURBO else 8, *img.shape).contiguous()
            turbo_kernels(name, frames, rec)
        nms_tie_break_check()
        nms_synthetic_check()
        refine_synthetic_check()
        _print_times(card, [(f"{n}.{k}", r) for n in GOLDEN for k, r in rec[n].items()])
        phase_turbo_split(card, batch=32)
        return 0
    if args.cluster_only:
        phase_kernels(card, batch=32, names=("two_boards",))
        split = phase_cluster_split(card, batch=32)
        print(f"cluster split two_boards b32 [{card}]: {json.dumps(split)}", flush=True)
        return 0
    rec = phase_kernels(card, batch=32)
    if args.kernels_only:
        return 0
    split = phase_cluster_split(card, batch=32)
    phase_turbo_split(card, batch=32)
    phase_decode_split(card, batch=32)
    launches = phase_end_to_end(card, batch=32)
    for k, n in phase_runtime(card, batch=128).items():
        launches[k] += n
    launches.update(phase_split_chain(card, batch=32))
    for k, n in phase_plane_path(card, batch=32).items():
        launches[k] += n
    sharded_launches, srec = phase_sharded(card, batch=32)
    for k, n in phase_ingest(card, batch=32)[0].items():
        launches[k] += n
    xla_launches, xrec = phase_xla(card, batch=16)
    for k, n in xla_launches.items():
        launches[k] = launches.get(k, 0) + n
    surface_launches = phase_surfaces(card, batch=8)
    example_launches = phase_examples(card)
    for part in (surface_launches, example_launches):
        for k, n in part.items():
            launches[k] = launches.get(k, 0) + n
    tb = rec["two_boards"]
    csrc = "aprilgrid_tpu_torch/csrc/"
    jp = "aprilgrid_tpu/pallas/"

    def worst(key, names):
        return max(rec[n][key]["err"] for n in names)

    # (name = launch counter, source, replaces, record at two_boards b32, error)
    rows = [
        ("front_kernel", "frontend.cu", "frontend.py:357",
         tb["front"], worst("front", GOLDEN)),
        ("cluster_rochade_raw", "cluster.cu", "cluster.py:933",
         tb["cluster"], worst("cluster", GOLDEN)),
        ("hamming_scan", "decode.cu", "decode.py:49", rec["decode"], 0.0),
        ("front_kernel_decimate", "frontend.cu",
         "frontend.py:703", tb["front_decimate"], worst("front_decimate", GOLDEN)),
        ("cluster_rochade_raw[luma_f32]", "cluster.cu",
         "cluster.py:933", tb["cluster_f32"], worst("cluster_f32", GOLDEN)),
        ("nms_extract_raw", "nms.cu", "nms.py:305",
         tb["nms"], worst("nms", GOLDEN)),
        ("sparse_refine_raw", "refine.cu", "refine.py:254",
         tb["refine"], worst("refine", GOLDEN)),
        ("fused_frontend", "frontend.cu", "frontend.py:884",
         tb["fused"], worst("fused", GOLDEN)),
        ("gray_kernel", "frontend.cu", "frontend.py:88",
         tb["gray"], worst("gray", GOLDEN)),
        ("cluster_rochade", "cluster.cu", "cluster.py:845",
         tb["cluster_blur"], worst("cluster_blur", GOLDEN)),
        ("front_kernel[emit_blur]", "frontend.cu", "frontend.py:357",
         tb["front_emit_blur"], worst("front_emit_blur", GOLDEN)),
    ]
    # the scan runs inside the decode of each pass: its row counts the
    # path's decode_packed launches and times that kernel, with the
    # standalone entry's numbers beside them
    counter = {"hamming_scan": "decode_packed"}
    kernels = []
    for name, src, replaces, r, err in rows:
        n = launches[counter.get(name, name)]
        if n <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": jp + replaces, "launches": n,
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None,
        })
        if name in counter:
            h = rec["hamming"]
            kernels[-1].update(
                launched_as=counter[name], standalone_ms=h["ms"],
                standalone_plain_ms=h["plain_ms"], standalone_bound_ms=h["bound"][0])
    # the standalone scan's own launches: the xla path's decode
    h = xrec["hamming"]
    n = (xla_launches["hamming_scan"] + surface_launches["hamming_scan"]
         + example_launches["hamming_scan"])
    if n <= 0:
        raise AssertionError("hamming_scan[standalone] was not launched on its path")
    kernels.append({
        "name": "hamming_scan[standalone]", "route": "cuda", "source": csrc + "decode.cu",
        "replaces": jp + "decode.py:49", "launches": n,
        "max_abs_err": 0.0, "ms": h["ms"], "plain_ms": h["plain_ms"],
        "bound_ms": h["bound"][0], "bound_by": h["bound"][1], "library_ms": None,
        "device_ms": h["device_ms"], "shape": h["shape"],
    })
    kernels += sharded_rows(sharded_launches, srec)
    print(f"cluster split two_boards b32, device ms per launch [{card}]: "
          f"{json.dumps(split)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
