#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — ``TagDetector(device="cuda").detect_batch``,
the exact hybrid detector — on the bundled golden images at full
resolution, after building every kernel from ``aprilgrid_tpu_torch/csrc``
and holding each against its plain PyTorch version on the card.

Phases (a failing phase raises, so the script exits non-zero):

1. card and build: the card's name and power limit, the native search and
   the CUDA library built from source, build seconds;
2. kernels vs plain versions on CUDA tensors at main-path shapes
   (every golden image at batch 32, the end-to-end chunk: EuRoC u8 gray,
   TUM_VI u16 gray, iphone and two_boards RGB; the hamming scan at 32
   frames x 96 quads x 4 rotations) with their times;
3. end to end: ``detect_batch`` at batch 32 on EuRoC, TUM_VI, iphone and
   two_boards — golden tag counts on every frame, ID sets and corners
   against the port's own CPU run, frames/s timed with CUDA events;
4. one JSON line with each kernel's launches in phase 3, its error against
   the plain version, its time, the plain version's time and its bound.

The last line is ``{"ok": true, "device": {...}}``. Run from the
repository root: ``python3 chip_smoke.py`` (``--kernels-only`` stops after
phase 2, for a first check of new kernels).
"""

from __future__ import annotations

import argparse
import json
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
GOLDEN = {"EuRoC": 36, "TUM_VI": 36, "iphone": 66, "two_boards": 72}

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor)
# operations/s; the bound of a kernel is the larger of its two times.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def read_png(path) -> np.ndarray:
    """Decode a non-interlaced 8/16-bit gray, gray+alpha, RGB or RGBA PNG
    with numpy alone. The row filters are undone along anti-diagonals
    (row + pixel column): every byte depends only on its left, upper and
    upper-left neighbours, which lie on earlier diagonals."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if interlace or depth not in (8, 16) or ctype not in (0, 2, 4, 6):
        raise ValueError(f"{path}: unsupported PNG (type {ctype}, depth {depth})")
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, w * bpp + 1)
    ftype = raw[:, 0].astype(np.int32)
    filt = raw[:, 1:].astype(np.int32)
    out = np.zeros((h + 1, (w + 1) * bpp), np.int32)  # row 0 / col 0 stay 0
    k = np.arange(bpp)
    for s in range(h + w - 1):
        r = np.arange(max(0, s - w + 1), min(h - 1, s) + 1)
        px = s - r
        rr = np.repeat(r, bpp) + 1
        xx = (px[:, None] * bpp + k[None, :]).reshape(-1) + bpp
        a = out[rr, xx - bpp]
        b = out[rr - 1, xx]
        c = out[rr - 1, xx - bpp]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ft = np.repeat(ftype[r], bpp)
        pred = np.select(
            [ft == 1, ft == 2, ft == 3, ft == 4],
            [a, b, (a + b) // 2, paeth],
            0,
        )
        out[rr, xx] = (filt[rr - 1, xx - bpp] + pred) & 255
    img = out[1:, bpp:].astype(np.uint8)
    if depth == 16:
        img = (img[:, 0::2].astype(np.uint16) << 8) | img[:, 1::2]
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


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


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_build() -> str:
    from aprilgrid_tpu_torch import native
    from aprilgrid_tpu_torch.kernels import _lib

    card = _card()
    print(card, flush=True)
    t0 = time.perf_counter()
    native.build()
    t1 = time.perf_counter()
    _lib.lib()
    t2 = time.perf_counter()
    print(f"build: native search {t1 - t0:.1f} s, CUDA kernels {t2 - t1:.1f} s",
          flush=True)
    return card


def phase_kernels(card: str, batch: int) -> dict:
    """Each kernel against its plain version on the same CUDA tensors, on
    every golden image at the main path's chunk size."""
    import torch

    from aprilgrid_tpu_torch.config import CONSTANTS
    from aprilgrid_tpu_torch.families import get_family
    from aprilgrid_tpu_torch.kernels.cluster import (
        cluster_rochade_raw,
        cluster_rochade_raw_plain,
        sort_candidates,
    )
    from aprilgrid_tpu_torch.kernels.decode import hamming_scan, hamming_scan_plain
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
    for name in GOLDEN:
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
        # per pixel: luma (<= 5), 2 x 7-tap blur (28), Hessian (13), min (1)
        dense_ops = 47.0 * px
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
                # the fit: 25 x 25 cone taps + 5 x 5 x 5 + 5 x 5 fit taps,
                # x2 (multiply + add), plus ~30 for the solve and gates
                bound=_bound_ms(
                    raw_bytes + thr.numel() * 4 + f.numel() * 4 + c.numel() * 4,
                    dense_ops + batch * roots * (2 * (625 + 125 + 25) + 30),
                ),
            ),
        }

    spec = get_family("t36h11")
    codes = spec.code_bits_tensor(dev)
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 2, (32, 4 * 96, codes.shape[1])).astype(np.float32)
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
    print("kernels hamming_scan 32x384x36 vs t36h11: exact", flush=True)
    n_rows, n_codes, nb = rots.shape[0] * rots.shape[1], codes.shape[0], codes.shape[1]
    rec["hamming"] = dict(
        err=0.0, ms=_ms(lambda: hamming_scan(rots, codes), 50),
        plain_ms=_ms(lambda: hamming_scan_plain(rots, codes), 5),
        # 4-byte reads of rows and table, 8-byte writes; XOR + popcount +
        # compare per (row, code), counted at the f32 rate
        bound=_bound_ms(4.0 * (n_rows + n_codes) * nb + 8.0 * n_rows,
                        3.0 * n_rows * n_codes),
    )
    timed = [(f"{n}.{k}", r) for n in GOLDEN
             for k, r in rec[n].items()] + [("hamming", rec["hamming"])]
    for key, r in timed:
        print(f"time {key}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
                  f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]}) [{card}]",
                  flush=True)
    return rec


def phase_end_to_end(card: str, batch: int) -> dict:
    """detect_batch on the golden images on the card; returns the launch
    counts of the measured runs."""
    import torch

    from aprilgrid_tpu_torch import TagDetector
    from aprilgrid_tpu_torch.kernels import LAUNCHES, reset_launches

    gpu = TagDetector("t36h11", device="cuda")
    cpu = TagDetector("t36h11", device="cpu")
    imgs = {n: read_png(DATA / f"{n}.png") for n in GOLDEN}
    refs = {n: cpu.detect(img) for n, img in imgs.items()}
    for n, img in imgs.items():
        gpu.detect_batch(np.stack([img] * batch))  # warm-up (allocator, build)
    torch.cuda.synchronize()
    reset_launches()
    for n, img in imgs.items():
        frames = np.stack([img] * batch)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        res = gpu.detect_batch(frames)
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1)
        ref = refs[n]
        for i, tags in enumerate(res):
            if len(tags) != GOLDEN[n]:
                raise AssertionError(f"{n} frame {i}: {len(tags)} tags, golden {GOLDEN[n]}")
            if set(tags) != set(ref):
                raise AssertionError(f"{n} frame {i}: ID set differs from the CPU run")
            err = max(
                float(np.abs(np.asarray(tags[t]) - np.asarray(ref[t])).max())
                for t in tags
            )
            if err > 1e-3:
                raise AssertionError(f"{n} frame {i}: corners {err} px from the CPU run")
        print(f"e2e {n} {imgs[n].shape} b{batch}: {GOLDEN[n]} tags on every frame, "
              f"= CPU run (max corner diff {err:.2e} px); {ms:.2f} ms, "
              f"{batch / ms * 1e3:.1f} frames/s [{card}]", flush=True)
    return dict(LAUNCHES)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phase 2)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = phase_build()
    rec = phase_kernels(card, batch=32)
    if args.kernels_only:
        return 0
    launches = phase_end_to_end(card, batch=32)
    tb = rec["two_boards"]
    rows = [
        ("front_kernel", "frontend.cu", "aprilgrid_tpu/pallas/frontend.py:357",
         tb["front"], max(rec[n]["front"]["err"] for n in GOLDEN)),
        ("cluster_rochade_raw", "cluster.cu", "aprilgrid_tpu/pallas/cluster.py:933",
         tb["cluster"], max(rec[n]["cluster"]["err"] for n in GOLDEN)),
        ("hamming_scan", "decode.cu", "aprilgrid_tpu/pallas/decode.py:49",
         rec["hamming"], 0.0),
    ]
    kernels = []
    for name, src, replaces, r, err in rows:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aprilgrid_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
