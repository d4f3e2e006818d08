"""Hamming table scan kernel for tag decoding.

``hamming_scan`` replaces the JAX package's ``pallas/decode.py::hamming_scan``.
On a CUDA tensor it launches ``csrc/decode.cu`` (popcount of XOR over the
code table packed into uint64 words in shared memory; the source's head
notes the bound); on a CPU tensor it runs ``hamming_scan_plain``, the
reference's ``ham = |r| + |c| - 2 r.c`` followed by a first-argmin.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from ._lib import check, lib, require_cuda, stream_of


def hamming_scan_plain(rots: torch.Tensor, codes: torch.Tensor):
    """Plain PyTorch version of ``hamming_scan``."""
    inner = torch.einsum("brn,cn->brc", rots, codes)
    ham = rots.sum(-1)[..., None] + codes.sum(-1)[None, None, :] - 2.0 * inner
    idx = torch.argmin(ham, dim=-1)  # first minimum
    return torch.gather(ham, -1, idx[..., None])[..., 0], idx.to(torch.int32)


def hamming_scan(rots: torch.Tensor, codes: torch.Tensor):
    """Per row: (min hamming distance over the table, FIRST index reaching
    it). rots (B, R, nb) f32 0/1 LSB-first rotated bit rows, codes (C, nb)
    f32 0/1; returns (min (B, R) f32, idx (B, R) int32)."""
    if rots.ndim != 3 or codes.ndim != 2 or rots.shape[2] != codes.shape[1]:
        raise ValueError(
            f"hamming_scan: shapes {tuple(rots.shape)} and {tuple(codes.shape)}"
        )
    if rots.dtype != torch.float32 or codes.dtype != torch.float32:
        raise TypeError("hamming_scan: rots and codes must be f32")
    if rots.shape[2] > 64:
        raise ValueError("hamming_scan: at most 64 bits per code")
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
    err = lib().ag_hamming_scan(
        rows.data_ptr(), b * r, nb, codes.data_ptr(), codes.shape[0],
        out_min.data_ptr(), out_idx.data_ptr(), stream_of(rots),
    )
    check(err, "hamming_scan")
    LAUNCHES["hamming_scan"] += 1
    return out_min, out_idx
