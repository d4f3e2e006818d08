"""AprilTag family definitions.

The reference enumerates five families and embeds their code tables
(reference: src/tag_families.rs:6-28 for the enum/FromStr,
src/detector.rs:364-406 for the per-family (edge, border, hamming)
parameters). The tables live in ``data/tag_families.npz``; each family
holds numpy arrays and hands out tensors on request (``code_bits_tensor``,
``code_words_tensor``):

* the code table unpacked to a (num_codes, edge*edge) bit matrix, the
  layout the hamming table scan takes (kernels/decode.py), and packed into
  one word per code, the layout of the decode kernel's table;
* the 90-degree bit-rotation permutation (reference computes it with a
  const-fn bit loop at src/detector.rs:124-140; here it is a gather).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from pathlib import Path

import numpy as np
import torch

_DATA = Path(__file__).resolve().parent / "data" / "tag_families.npz"


class TagFamily(enum.Enum):
    """Supported tag families (reference: src/tag_families.rs:6-13)."""

    T16H5 = "t16h5"
    T25H7 = "t25h7"
    T25H9 = "t25h9"
    T36H11 = "t36h11"
    T36H11B1 = "t36h11b1"  # T36H11 codes drawn with a 1-bit border

    @classmethod
    def from_str(cls, s: str) -> "TagFamily":
        try:
            return cls(s.lower())
        except ValueError:
            raise ValueError(f"unknown tag family {s!r}") from None


# (edge_bits, border_bits, hamming_distance) per family
# (reference: src/detector.rs:369-405).
_FAMILY_PARAMS = {
    TagFamily.T16H5: (4, 2, 1),
    TagFamily.T25H7: (5, 2, 2),
    TagFamily.T25H9: (5, 2, 2),
    TagFamily.T36H11: (6, 2, 3),
    TagFamily.T36H11B1: (6, 1, 3),
}

# T36H11B1 shares the T36H11 code table (reference: src/detector.rs:398-404).
_CODE_TABLE_KEY = {f: ("t36h11" if f.value.startswith("t36h11") else f.value)
                   for f in TagFamily}


def rotation_permutation(edge: int) -> np.ndarray:
    """Bit-index permutation equivalent to one 90-degree code rotation.

    The reference rotates a packed u64 with a bit loop
    (src/detector.rs:124-140): output bit ``count`` (LSB-first) reads input
    bit ``r + c*edge`` scanning r = edge-1..0 outer, c = 0..edge-1 inner.
    ``perm[i]`` is the input bit index feeding output bit ``i``.
    """
    perm = np.empty(edge * edge, dtype=np.int32)
    count = 0
    for r in range(edge - 1, -1, -1):
        for c in range(edge):
            perm[count] = r + c * edge
            count += 1
    return perm


def unpack_bits_lsb(codes: np.ndarray, nbits: int) -> np.ndarray:
    """Unpack uint64 codes into an LSB-first (N, nbits) uint8 bit matrix."""
    codes = codes.astype(np.uint64)
    out = np.zeros((codes.shape[0], nbits), dtype=np.uint8)
    for b in range(nbits):
        out[:, b] = (codes >> np.uint64(b)) & np.uint64(1)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class FamilySpec:
    """Everything the decode stage needs for one family, as numpy arrays."""

    family: TagFamily
    edge: int
    border: int
    hamming_distance: int
    codes: np.ndarray        # (N,) uint64 packed codes
    code_bits: np.ndarray    # (N, edge*edge) uint8, LSB-first
    rot_perm: np.ndarray     # (edge*edge,) int32 90-degree permutation

    @property
    def side_bits(self) -> int:
        # reference: src/detector.rs:57 (side = 2*border + edge)
        return 2 * self.border + self.edge

    @property
    def num_codes(self) -> int:
        return int(self.codes.shape[0])

    def code_bits_tensor(self, device) -> torch.Tensor:
        """(N, edge*edge) f32 0/1 code table on ``device``."""
        return _code_bits_on(self, str(torch.device(device)))

    def code_words_tensor(self, device) -> torch.Tensor:
        """(N,) int64 code table on ``device``: ``code_bits`` packed LSB
        first, one word per code (the decode kernel's table)."""
        return _code_words_on(self, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _code_bits_on(spec: FamilySpec, device: str) -> torch.Tensor:
    return torch.from_numpy(spec.code_bits.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def _code_words_on(spec: FamilySpec, device: str) -> torch.Tensor:
    bits = spec.code_bits.astype(np.uint64)
    shift = np.arange(bits.shape[1], dtype=np.uint64)
    words = (bits << shift).sum(axis=1, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(words).to(device)


@functools.lru_cache(maxsize=None)
def get_family(family: TagFamily | str) -> FamilySpec:
    if isinstance(family, str):
        family = TagFamily.from_str(family)
    edge, border, hamming = _FAMILY_PARAMS[family]
    with np.load(_DATA) as data:
        codes = data[_CODE_TABLE_KEY[family]].copy()
    return FamilySpec(
        family=family,
        edge=edge,
        border=border,
        hamming_distance=hamming,
        codes=codes,
        code_bits=unpack_bits_lsb(codes, edge * edge),
        rot_perm=rotation_permutation(edge),
    )
