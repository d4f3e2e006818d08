"""Rounding helper shared by the refine and decode stages.

Only ``rust_round`` is needed by the hybrid path; the quad predicates of
the JAX package's ``ops/geometry.py`` serve its on-device board search,
which is not ported yet (ROADMAP.md, section A).
"""

from __future__ import annotations

import torch


def rust_round(x: torch.Tensor) -> torch.Tensor:
    """f32::round — half away from zero."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)
