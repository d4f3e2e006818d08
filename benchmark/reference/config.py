"""The frozen reference's default parameters and family table.

Copies of ``aprilgrid_tpu/config.py::DetectorParams`` (its defaults,
reference: src/detector.rs:25-41) and of the t36h11 entry of
``aprilgrid_tpu/families.py`` (edge 6, border 2, hamming 3, reference:
src/detector.rs:369-405), the code table read from ``t36h11.npy`` beside
this file (the ``t36h11`` array of ``aprilgrid_tpu/data/tag_families.npz``).
The benchmark serves t36h11 only; any other family is refused.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

_TABLE = Path(__file__).resolve().parent / "t36h11.npy"


@dataclasses.dataclass(frozen=True)
class DetectorParams:
    tag_spacing_ratio: float = 0.3
    min_saddle_angle: float = 30.0
    max_saddle_angle: float = 60.0
    max_num_of_boards: int = 2


DEFAULT_PARAMS = DetectorParams()


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    edge: int
    border: int
    hamming_distance: int
    codes: np.ndarray  # (N,) uint64 packed codes


def get_family(family: str = "t36h11") -> FamilySpec:
    if str(family).lower() != "t36h11":
        raise ValueError(f"the frozen reference holds t36h11 only, not {family!r}")
    return FamilySpec(edge=6, border=2, hamming_distance=3, codes=np.load(_TABLE))
