"""Tag decode kernels: the Hamming table scan, and the decode of a pass.

``hamming_scan`` replaces the JAX package's ``pallas/decode.py::hamming_scan``.
On a CUDA tensor it launches ``csrc/decode.cu::hamming_scan_kernel`` (a warp
per row, the row and the table packed into words by ballots, lanes
splitting the codes, one warp minimum of ``(d << 20) | j`` keys; the
source's head notes the bound); on a CPU tensor it runs
``hamming_scan_plain``, the reference's ``ham = |r| + |c| - 2 r.c``
followed by a first-argmin.

``decode_packed`` is the counterpart of the JAX facade's jitted decode of
one board pass (``aprilgrid_tpu/detector.py:234-275``): quads | count in,
``[id, valid, corners x8]`` rows out. On a CUDA tensor it is one launch of
``decode_packed_kernel``, which carries the scan; on a CPU tensor it runs
``decode_packed_plain``, the facade's gather, ``ops/decode.py``'s decode
chain and the concat.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..families import FamilySpec
from ..ops.decode import _affine_pinv, _bit_grid, _decode_post, _decode_pre, _rot_perms
from . import LAUNCHES
from ._lib import check, launch, require_cuda

MAX_CODES = 1 << 20  # the scan's key holds the code index in 20 bits


def hamming_scan_plain(rots: torch.Tensor, codes: torch.Tensor):
    """Plain PyTorch version of ``hamming_scan``."""
    inner = torch.einsum("brn,cn->brc", rots, codes)
    ham = rots.sum(-1)[..., None] + codes.sum(-1)[None, None, :] - 2.0 * inner
    idx = torch.argmin(ham, dim=-1)  # first minimum
    return torch.gather(ham, -1, idx[..., None])[..., 0], idx.to(torch.int32)


def hamming_scan(rots: torch.Tensor, codes: torch.Tensor):
    """Per row: (min hamming distance over the table, FIRST index reaching
    it). rots (B, R, nb) f32 0/1 LSB-first rotated bit rows, codes (C, nb)
    f32 0/1 with C < 2^20; returns (min (B, R) f32, idx (B, R) int32)."""
    if rots.ndim != 3 or codes.ndim != 2 or rots.shape[2] != codes.shape[1]:
        raise ValueError(
            f"hamming_scan: shapes {tuple(rots.shape)} and {tuple(codes.shape)}"
        )
    if rots.dtype != torch.float32 or codes.dtype != torch.float32:
        raise TypeError("hamming_scan: rots and codes must be f32")
    if rots.shape[2] > 64:
        raise ValueError("hamming_scan: at most 64 bits per code")
    if codes.shape[0] >= MAX_CODES:
        raise ValueError(f"hamming_scan: at most {MAX_CODES - 1} codes")
    if rots.device.type == "cpu":
        return hamming_scan_plain(rots, codes)
    require_cuda(rots, "hamming_scan")
    if codes.device != rots.device:
        raise ValueError("hamming_scan: codes must be on rots's device")
    b, r, nb = rots.shape
    rows = rots.contiguous()
    codes = codes.contiguous()
    out_min = torch.empty((b, r), dtype=torch.float32, device=rots.device)
    out_idx = torch.empty((b, r), dtype=torch.int32, device=rots.device)
    err = launch(
        "hamming_scan", rots,
        rows.data_ptr(), b * r, nb, codes.data_ptr(), codes.shape[0],
        out_min.data_ptr(), out_idx.data_ptr(),
    )
    check(err, "hamming_scan")
    LAUNCHES["hamming_scan"] += 1
    return out_min, out_idx


def decode_packed_plain(packed, luma8, qarr, hw, dcap, spec: FamilySpec, margin,
                        valid_brightness_threshold, max_invalid_bit, min_contrast):
    """Plain PyTorch version of ``decode_packed``."""
    dev = packed.device
    b = qarr.shape[0]
    q = qarr[:, : dcap * 4].reshape(b, dcap, 4).to(torch.int64).clamp(min=0)
    qv = torch.arange(dcap, device=dev)[None, :] < qarr[:, dcap * 4][:, None]
    pos = packed[..., 0:2]  # (B, N+1, 2)
    qp = torch.gather(
        pos, 1, q.reshape(b, dcap * 4, 1).expand(b, dcap * 4, 2)
    ).reshape(b, dcap, 4, 2)
    rots, gates = _decode_pre(
        luma8, qp, qv, spec, margin, valid_brightness_threshold,
        max_invalid_bit, min_contrast, true_shape=hw,
    )
    t, nb = rots.shape[1], rots.shape[3]
    mins, idxs = hamming_scan_plain(
        rots.reshape(b, t * 4, nb), spec.code_bits_tensor(dev)
    )
    d = _decode_post(
        mins.reshape(b, t, 4), idxs.reshape(b, t, 4), gates, qp, spec
    )
    return torch.cat(
        [
            d.ids.to(torch.float32)[..., None],
            d.valid.to(torch.float32)[..., None],
            d.corners.reshape(b, dcap, 8),
        ],
        dim=-1,
    )


@functools.lru_cache(maxsize=None)
def _decode_tables(spec: FamilySpec, margin: float, device: str):
    """The decode kernel's constants on ``device``: the affine's
    pseudo-inverse (6, 8) f32, the bit-cell centres (nb, 2) f32, the
    position (MSB-first order) feeding bit i of rotation r (4, nb) int32
    (the flip and ``_rot_perms``), and the packed code table."""
    nb = spec.edge * spec.edge
    src = (nb - 1 - _rot_perms(spec.edge)).astype(np.int32)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (_affine_pinv(spec.side_bits, margin),
                  _bit_grid(spec.edge, spec.border), src)
    ) + (spec.code_words_tensor(device),)


def decode_packed(packed, luma8, qarr, hw, dcap, spec: FamilySpec, margin,
                  valid_brightness_threshold, max_invalid_bit, min_contrast):
    """Decode the searched quads of a chunk's pass (try_decode_quad,
    src/detector.rs:448-476, for every slot). packed (B, N+1, 4) f32 rows
    [x, y, theta, valid] of ``pipeline.frontend_packed``; luma8 (B, Hp, Wp)
    u8 holding the true (h, w) = ``hw`` frame; qarr (B, dcap*4 + 1) int32
    of quads (saddle rows, -1 padding) | count. Returns (B, dcap, 10) f32
    rows [id (-1 where invalid), valid, corners x8 in canonical order]."""
    b = qarr.shape[0]
    if packed.ndim != 3 or packed.shape[2] != 4 or packed.dtype != torch.float32:
        raise ValueError(f"decode_packed: packed {tuple(packed.shape)} {packed.dtype}")
    if luma8.ndim != 3 or luma8.dtype != torch.uint8 or luma8.shape[0] != b:
        raise ValueError(f"decode_packed: luma8 {tuple(luma8.shape)} {luma8.dtype}")
    if qarr.shape != (b, dcap * 4 + 1) or qarr.dtype != torch.int32 or packed.shape[0] != b:
        raise ValueError(f"decode_packed: qarr {tuple(qarr.shape)} {qarr.dtype} "
                         f"for dcap {dcap} and {packed.shape[0]} frames")
    h, w = hw
    if not (0 < h <= luma8.shape[1] and 0 < w <= luma8.shape[2]):
        raise ValueError(f"decode_packed: frame {hw} beyond luma8 {tuple(luma8.shape)}")
    args = (packed, luma8, qarr, hw, dcap, spec, margin,
            valid_brightness_threshold, max_invalid_bit, min_contrast)
    if packed.device.type == "cpu":
        return decode_packed_plain(*args)
    require_cuda(packed, "decode_packed")
    if luma8.device != packed.device or qarr.device != packed.device:
        raise ValueError("decode_packed: luma8 and qarr must be on packed's device")
    packed, luma8, qarr = (t.contiguous() for t in (packed, luma8, qarr))
    pinv, grid, src, words = _decode_tables(spec, float(margin), str(packed.device))
    out = torch.empty((b, dcap, 10), dtype=torch.float32, device=packed.device)
    err = launch(
        "decode_packed", packed,
        packed.data_ptr(), packed.shape[1], luma8.data_ptr(), luma8.shape[1],
        luma8.shape[2], qarr.data_ptr(), b, dcap, h, w, pinv.data_ptr(),
        grid.data_ptr(), src.data_ptr(), src.shape[1], words.data_ptr(),
        words.shape[0], spec.hamming_distance, int(valid_brightness_threshold),
        int(max_invalid_bit), int(min_contrast), out.data_ptr(),
    )
    check(err, "decode_packed")
    LAUNCHES["decode_packed"] += 1
    return out
