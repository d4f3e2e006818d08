"""Per-frame index helpers of the on-device board search.

``nonzero_sized`` is ``jnp.nonzero(mask, size=, fill_value=)`` row by row
without a host sync: ``torch.nonzero`` returns a data-dependent shape, so
on a CUDA tensor it waits for the device. ``take`` gathers each frame's
entries by per-frame indices. ``device_table`` keeps the constant tables
of the search and the decode on each device.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def device_table(table, args: tuple, device: torch.device):
    """``table(*args)``, a constant numpy array or a tuple of them, on
    ``device``, uploaded once: a copy from pageable host memory waits for
    the device."""
    out = table(*args)
    if isinstance(out, tuple):
        return tuple(torch.from_numpy(a).to(device) for a in out)
    return torch.from_numpy(out).to(device)


def nonzero_sized(mask: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """(..., n) bool -> (..., size) int64: per row, the indices of the first
    ``size`` set entries in ascending order, then ``fill_value``.

    Each set entry's rank is a cumsum; entries ranked ``size`` or later go
    to a sink slot past the end, which is cut off, so every kept slot is
    written once."""
    n = mask.shape[-1]
    rank = torch.cumsum(mask.to(torch.int32), dim=-1, dtype=torch.int64) - 1
    slot = torch.where(mask & (rank < size), rank, size)
    out = torch.full((*mask.shape[:-1], size + 1), fill_value, dtype=torch.int64,
                     device=mask.device)
    src = torch.arange(n, device=mask.device).expand(mask.shape)
    out.scatter_(-1, slot, src)
    return out[..., :size]


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-frame gather: ``x`` (B, N, *rest), ``idx`` (B, *S) integer
    indices in [0, N) -> (B, *S, *rest), out[b, s] = x[b, idx[b, s]]."""
    b, n = x.shape[:2]
    off = torch.arange(b, device=idx.device).view(b, *([1] * (idx.ndim - 1))) * n
    return x.reshape(b * n, *x.shape[2:])[idx.long() + off]
