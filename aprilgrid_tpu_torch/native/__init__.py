"""Native host runtime: C++ board search (ctypes bindings).

The dense stages run on the card; the irregular board search runs on the
host through this library, which matches the reference algorithm step
for step (see search.cpp, a copy of the JAX package's source). The hybrid
detector moves the packed saddle arrays to the host once per chunk and
calls ``find_board_batch``.

The library is built on first use with g++ into the package's
``build/`` directory (listed in ``.gitignore``), named by a hash of the
source and flags so a changed source is rebuilt. ``-ffp-contract=off``
pins the numerics: contracting a*b+c into FMA would change rounding on
near-threshold reference-parity gates.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "search.cpp"
BUILD_DIR = _DIR.parent / "build"
_CFLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-ffp-contract=off"]


def build() -> Path:
    """Compile the library if no build of this source and these flags
    exists yet; returns its path. Raises if g++ fails."""
    tag = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_CFLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"libagsearch.{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    try:
        proc = subprocess.run(
            ["g++", *_CFLAGS, str(_SRC), "-o", str(tmp)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.ag_find_board_batch.restype = None
    lib.ag_find_board_batch.argtypes = [
        f32p, f32p, f32p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i32p, ctypes.c_int,
    ]
    return lib


def find_board_batch(
    px: np.ndarray,  # (B, N)
    py: np.ndarray,
    theta: np.ndarray,
    alive: np.ndarray,  # (B, N) uint8
    spacing_ratio: float = 0.3,
    max_seeds: int = 30,
    early_exit_score: int = 36,
    cap: int = 169,
) -> tuple[np.ndarray, np.ndarray]:
    """One board-search pass over B independent frames, spread across
    all host cores; returns
    (quads (B, cap, 4) int32, counts (B,) int32)."""
    b, n = px.shape
    quads = np.zeros((b, cap, 4), np.int32)
    counts = np.zeros(b, np.int32)
    _lib().ag_find_board_batch(
        np.ascontiguousarray(px, np.float32),
        np.ascontiguousarray(py, np.float32),
        np.ascontiguousarray(theta, np.float32),
        np.ascontiguousarray(alive, np.uint8),
        b, n, spacing_ratio, max_seeds, early_exit_score, 0,
        quads, counts, cap,
    )
    return quads, counts
