"""Native host runtime: C++ board search (ctypes bindings).

The dense stages run on the card; the irregular board search runs on the
host through this library, which matches the reference algorithm step
for step (see search.cpp, a copy of the JAX package's source). The hybrid
detector moves the packed saddle arrays to the host once per chunk and
calls ``find_board_batch``, on a worker thread: ctypes releases the GIL
for the duration of each call.

The library is built on first use with g++ into the package's
``build/`` directory (listed in ``.gitignore``), named by a hash of the
source, the flags and the host's ISA, so a changed source is rebuilt and
a build for another host's vector ISA is never loaded.

``-march=native`` by default (``AG_NATIVE_MARCH`` names another target,
``"portable"`` leaves the flag out); if g++ rejects the flag the library
is built portable under the same name. ``-ffp-contract=off`` pins the
numerics: contracting a*b+c into FMA would change rounding on
near-threshold reference-parity gates.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "search.cpp"
BUILD_DIR = _DIR.parent / "build"
_CFLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-ffp-contract=off"]


def _host_isa_signature() -> str:
    """Stable signature of this host's ISA (its CPU flags), so an
    ISA-specific build is never reused on a host that cannot run it."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("flags"):
                return hashlib.sha256(line.encode()).hexdigest()[:16]
    except OSError:
        pass
    return platform.machine()


def _flags() -> tuple[list[str], str]:
    """The g++ flags this host asks for, and the text that names the
    build: the flags plus, under ``-march``, the host-ISA signature."""
    march = os.environ.get("AG_NATIVE_MARCH", "native")
    if not march or march == "portable":
        return list(_CFLAGS), " ".join(_CFLAGS)
    cflags = [*_CFLAGS, f"-march={march}"]
    return cflags, " ".join(cflags) + " isa:" + _host_isa_signature()


def library_path() -> Path:
    """Where the build of this source for these flags and this host lies."""
    _, name = _flags()
    tag = hashlib.sha256(_SRC.read_bytes() + name.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libagsearch.{tag}.so"


def build() -> Path:
    """Compile the library if no build of this source, these flags and
    this host's ISA exists yet; returns its path. Raises if g++ fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cflags, _ = _flags()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    try:
        proc = subprocess.run(
            ["g++", *cflags, str(_SRC), "-o", str(tmp)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0 and cflags != _CFLAGS:
            # g++ rejects this -march: build portable under the same name,
            # so the failing compile is not retried on every import
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
    lib.ag_find_board.restype = ctypes.c_int
    lib.ag_find_board.argtypes = [
        f32p, f32p, f32p, u8p, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int,
    ]
    lib.ag_find_board_batch.restype = None
    lib.ag_find_board_batch.argtypes = [
        f32p, f32p, f32p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i32p, ctypes.c_int,
    ]
    lib.ag_is_valid_quad.restype = ctypes.c_int
    lib.ag_is_valid_quad.argtypes = [f32p]
    return lib


def is_valid_quad(xyt: np.ndarray) -> bool:
    """Quad validity of four (x, y, theta_deg) saddles (for tests)."""
    return bool(
        _lib().ag_is_valid_quad(
            np.ascontiguousarray(xyt, np.float32).reshape(12)
        )
    )


def find_board(
    px: np.ndarray,
    py: np.ndarray,
    theta: np.ndarray,
    alive: np.ndarray,
    spacing_ratio: float = 0.3,
    max_seeds: int = 30,
    early_exit_score: int = 36,
    cap: int = 169,
) -> np.ndarray:
    """One board-search pass over one frame; returns (count, 4) int32 tag
    quads."""
    n = px.shape[0]
    out = np.zeros((cap, 4), np.int32)
    cnt = _lib().ag_find_board(
        np.ascontiguousarray(px, np.float32),
        np.ascontiguousarray(py, np.float32),
        np.ascontiguousarray(theta, np.float32),
        np.ascontiguousarray(alive, np.uint8),
        n, spacing_ratio, max_seeds, early_exit_score, out, cap,
    )
    return out[:cnt]


def find_board_batch(
    px: np.ndarray,  # (B, N)
    py: np.ndarray,
    theta: np.ndarray,
    alive: np.ndarray,  # (B, N) uint8
    spacing_ratio: float = 0.3,
    max_seeds: int = 30,
    early_exit_score: int = 36,
    cap: int = 169,
    num_threads: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """One board-search pass over B independent frames, spread across
    ``num_threads`` host threads (default: the ``AG_SEARCH_THREADS``
    environment variable, else 0 = all cores); returns
    (quads (B, cap, 4) int32, counts (B,) int32)."""
    b, n = px.shape
    quads = np.zeros((b, cap, 4), np.int32)
    counts = np.zeros(b, np.int32)
    if num_threads is None:
        num_threads = int(os.environ.get("AG_SEARCH_THREADS", "0"))
    _lib().ag_find_board_batch(
        np.ascontiguousarray(px, np.float32),
        np.ascontiguousarray(py, np.float32),
        np.ascontiguousarray(theta, np.float32),
        np.ascontiguousarray(alive, np.uint8),
        b, n, spacing_ratio, max_seeds, early_exit_score, num_threads,
        quads, counts, cap,
    )
    return quads, counts
