"""Build and load the CUDA kernel library (nvcc + ctypes).

All ``csrc/*.cu`` sources compile in parallel, one ``nvcc -c`` each, for
``sm_90a`` with ``--fmad=false`` (the kernels reproduce the reference's
f32 op sequence; a contracted a*b+c would round differently), and link
into one shared library with a plain C interface. The library lands in the
package's ``build/`` directory (listed in ``.gitignore``), named by a hash
of the sources and flags, on first use; later calls load it. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "cannot be built"
    )


def build() -> Path:
    """Compile the kernel library unless this exact build exists."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_CSRC.glob("*.cu*")):
        digest.update(f.name.encode() + f.read_bytes())
    lib = BUILD_DIR / f"libagkernels.{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    work = BUILD_DIR / f"obj.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        objs = [work / (s.stem + ".o") for s in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(sources, objs)
        ]
        errors = []
        for s, p in zip(sources, procs):
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{s.name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp = work / lib.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    handle = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    handle.ag_front_kernel.restype = i
    handle.ag_front_kernel.argtypes = [p, i, i, i, i, i, i, i, p, p, p, p]
    handle.ag_cluster_rochade_raw.restype = i
    handle.ag_cluster_rochade_raw.argtypes = [
        p, i, i, i, i, i, i, i, p, p, p, f, i, p, p, p, p, p, p, i, p,
    ]
    handle.ag_hamming_scan.restype = i
    handle.ag_hamming_scan.argtypes = [p, i, i, p, i, p, p, p]
    return handle


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require_cuda(t: torch.Tensor, name: str) -> None:
    """Wrappers serve CPU tensors (plain version) and CUDA tensors
    (kernel); anything else is an error, never a fallback."""
    if t.device.type != "cuda":
        raise ValueError(
            f"{name}: tensors on {t.device} are not served (CPU runs the "
            "plain version, CUDA the kernel)"
        )
