"""Carry the JAX package's detector state across to this package.

The detector has no learned weights; its state is the family tables and
rotation permutation, the configuration dataclasses, and constants that
both packages derive from those (Gaussian taps, ROCHADE pseudo-inverse and
cone). These functions take that state as plain numpy arrays and dicts —
``dataclasses.asdict`` of the JAX dataclasses, a ``FamilySpec``'s fields —
so the tests can run both packages on identical state without this
package importing the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import Capacities, DetectorParams, PipelineConstants
from .families import FamilySpec, TagFamily


def family_from_numpy(
    name: str,
    code_bits: np.ndarray,
    codes: np.ndarray,
    edge: int,
    border: int,
    hamming_distance: int,
    rot_perm: np.ndarray,
) -> FamilySpec:
    """A FamilySpec from the fields of another package's family spec."""
    code_bits = np.asarray(code_bits, np.uint8)
    codes = np.asarray(codes, np.uint64)
    if code_bits.shape != (codes.shape[0], edge * edge):
        raise ValueError(
            f"code_bits {code_bits.shape} does not match {codes.shape[0]} "
            f"codes of {edge}x{edge} bits"
        )
    return FamilySpec(
        family=TagFamily.from_str(name),
        edge=int(edge),
        border=int(border),
        hamming_distance=int(hamming_distance),
        codes=codes,
        code_bits=code_bits,
        rot_perm=np.asarray(rot_perm, np.int32),
    )


def _build(cls, values: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**values)


def params_from_dict(params: dict, consts: dict, caps: dict):
    """(DetectorParams, PipelineConstants, Capacities) from
    ``dataclasses.asdict`` of the JAX package's dataclasses."""
    return (
        _build(DetectorParams, params),
        _build(PipelineConstants, consts),
        _build(Capacities, caps),
    )
