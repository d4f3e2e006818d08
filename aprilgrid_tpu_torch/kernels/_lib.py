"""Build and load the CUDA kernel library (nvcc + ctypes).

All ``csrc/*.cu`` sources compile in parallel, one ``nvcc -c`` each, for
``sm_90a`` with ``--fmad=false`` (the kernels reproduce the reference's
f32 op sequence; a contracted a*b+c would round differently), and link
into one shared library with a plain C interface. The library lands in the
package's ``build/`` directory (listed in ``.gitignore``), named by a hash
of the sources and flags, on first use; later calls load it. What ptxas
says of each kernel (``-Xptxas -v``: registers, stack frame, spills) is
kept beside the library; ``kernel_resources`` reads it. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
        errors, said = [], []
        for s, p in zip(sources, procs):
            out, _ = p.communicate()
            said.append(f"== {s.name}\n{out}")
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
        lib.with_suffix(".ptxas.txt").write_text("\n".join(said))
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def parse_ptxas(text: str) -> list[dict]:
    """The kernels of one ``nvcc -Xptxas -v`` report: name, registers,
    bytes of stack frame (local memory), spill stores and spill loads,
    static shared memory."""
    found = re.findall(
        r"Compiling entry function '(\S+)'.*?(\d+) bytes stack frame, (\d+) bytes "
        r"spill stores, (\d+) bytes spill loads.*?Used (\d+) registers([^\n]*)",
        text, re.S,
    )
    out = []
    for mangled, stack, st, ld, regs, rest in found:
        name = re.findall(r"\d+([a-z][a-z_]*_kernel)", mangled)
        # a kernel template's instance: its integer or bool argument, as <n>
        arg = re.search(r"_kernelIL[ib](\d+)EE", mangled)
        kernel = name[-1] + (f"<{arg.group(1)}>" if arg else "") if name else mangled
        smem = re.search(r"(\d+) bytes smem", rest)
        out.append({
            "kernel": kernel, "registers": int(regs),
            "stack_bytes": int(stack), "spill_store_bytes": int(st),
            "spill_load_bytes": int(ld), "smem_bytes": int(smem.group(1)) if smem else 0,
        })
    return out


def kernel_resources(source: str) -> list[dict]:
    """What ptxas reported for each kernel of ``csrc/<source>`` in the
    current build (``parse_ptxas``)."""
    text = build().with_suffix(".ptxas.txt").read_text()
    return parse_ptxas(text.split(f"== {source}\n", 1)[1].split("\n== ", 1)[0])


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    handle = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    handle.ag_front_kernel.restype = i
    handle.ag_front_kernel.argtypes = [p, i, i, i, i, i, i, i, p, p, i, p, p, p, p]
    handle.ag_fused_frontend.restype = i
    handle.ag_fused_frontend.argtypes = [p, i, i, i, i, i, i, i, p, p, p, i, i, p, p]
    handle.ag_gray_kernel.restype = i
    handle.ag_gray_kernel.argtypes = [p, i, i, i, i, i, i, i, p, p, p]
    handle.ag_cluster_rochade_raw.restype = i
    handle.ag_cluster_rochade_raw.argtypes = [
        p, i, i, i, i, i, i, i, p, p, p, f, i, p, i, p, p, p, p, p, p, p, p, i, p,
    ]
    handle.ag_cluster_rochade.restype = i
    handle.ag_cluster_rochade.argtypes = [
        p, i, i, i, i, i, p, p, f, i, p, p, p, p, p, p, p, i, p,
    ]
    handle.ag_front_kernel_decimate.restype = i
    handle.ag_front_kernel_decimate.argtypes = [
        p, i, i, i, i, i, i, i, p, p, i, p, p, i, i, p, p,
    ]
    handle.ag_nms_extract_raw.restype = i
    handle.ag_nms_extract_raw.argtypes = [
        p, i, i, i, i, i, p, p, p, f, i, p, i, i, p, p, p, p, p, p,
    ]
    handle.ag_sparse_refine_raw.restype = i
    handle.ag_sparse_refine_raw.argtypes = [
        p, i, i, i, i, i, i, i, p, p, p, i, p, f, i, p, p,
    ]
    handle.ag_hamming_scan.restype = i
    handle.ag_hamming_scan.argtypes = [p, i, i, p, i, p, p, p]
    handle.ag_decode_packed.restype = i
    handle.ag_decode_packed.argtypes = [
        p, i, p, i, i, p, i, i, i, i, p, p, p, i, p, i, i, i, i, i, p, p,
    ]
    return handle


def launch(name: str, t: torch.Tensor, *args) -> int:
    """Call the library's entry ``ag_<name>`` with ``args`` and, as its last
    argument, the current stream of ``t``'s device; return its error code
    (``check`` raises on a CUDA error).

    ``t``'s device is made the current CUDA device for the call: an entry's
    ``cudaFuncSetAttribute``, ``cudaGetDevice`` and launch act on the current
    device, and a caller's thread may have another one current (a mesh's
    shards on several cards). Every launch of every wrapper passes here.
    One card cannot show the guard at work: ``chip_smoke.py`` launches on
    ``cuda:1`` only where a second card is visible, and a CPU test pins
    that the guard is entered around the call
    (``tests/test_torch_package.py``)."""
    with torch.cuda.device(t.device):
        return getattr(lib(), f"ag_{name}")(
            *args, torch.cuda.current_stream(t.device).cuda_stream)


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
