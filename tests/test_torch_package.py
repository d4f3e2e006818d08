"""Package rules of the PyTorch port: it imports nothing of JAX or of the
JAX package, runs on the card unless asked for the CPU, its kernel
wrappers never fall back, and the detector state carries across."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import aprilgrid_tpu.config as jconfig
from aprilgrid_tpu.families import TagFamily as JFamily, get_family as j_family
from aprilgrid_tpu_torch import TagDetector
from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
from aprilgrid_tpu_torch.convert import family_from_numpy, params_from_dict
from aprilgrid_tpu_torch.families import TagFamily, get_family
from aprilgrid_tpu_torch.kernels.cluster import cluster_rochade, cluster_rochade_raw
from aprilgrid_tpu_torch.kernels.decode import hamming_scan
from aprilgrid_tpu_torch.kernels.frontend import (
    front_kernel,
    front_kernel_decimate,
    fused_frontend,
    gray_kernel,
)
from aprilgrid_tpu_torch.kernels.nms import nms_extract_raw
from aprilgrid_tpu_torch.kernels.refine import sparse_refine_raw

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "aprilgrid_tpu_torch"


def test_import_pulls_in_no_jax():
    code = (
        "import sys, aprilgrid_tpu_torch, aprilgrid_tpu_torch.detector, "
        "aprilgrid_tpu_torch.convert, aprilgrid_tpu_torch.kernels.nms, "
        "aprilgrid_tpu_torch.kernels.refine, aprilgrid_tpu_torch.kernels._fit, "
        "aprilgrid_tpu_torch.kernels.frontend, aprilgrid_tpu_torch.kernels.cluster, "
        "aprilgrid_tpu_torch.ops.cluster, aprilgrid_tpu_torch.pipeline, "
        "aprilgrid_tpu_torch.bench, aprilgrid_tpu_torch.utils.profiling, "
        "aprilgrid_tpu_torch.utils.images, aprilgrid_tpu_torch.parallel.sharding, "
        "aprilgrid_tpu_torch.adapters, aprilgrid_tpu_torch.parallel.streaming, "
        "aprilgrid_tpu_torch.parallel.pipeline_parallel, aprilgrid_tpu_torch.ops.geometry, "
        "aprilgrid_tpu_torch.ops.compact, aprilgrid_tpu_torch.ops.quads, "
        "aprilgrid_tpu_torch.ops.board, aprilgrid_tpu_torch.ops.search, "
        "aprilgrid_tpu_torch.viz, aprilgrid_tpu_torch.live, aprilgrid_tpu_torch.boards, "
        "aprilgrid_tpu_torch.boards.generator, aprilgrid_tpu_torch.boards.__main__\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'aprilgrid_tpu' or m.startswith('aprilgrid_tpu.')]\n"
        "print(bad)\nsys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_names_jax_or_the_jax_package():
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    assert len(files) > 20
    for p in files:
        text = p.read_text()
        assert not re.search(r"\bjax\b", text), p
        assert not re.search(r"\baprilgrid_tpu\.", text), p


def test_every_launch_makes_its_tensors_device_current(monkeypatch):
    """``kernels/_lib.py::launch``, through which every wrapper launches,
    enters ``torch.cuda.device(t.device)`` around the library call and
    passes that device's current stream last (a card other than the
    thread's current one, which no single-card run can show)."""
    from types import SimpleNamespace

    from aprilgrid_tpu_torch.kernels import _lib

    seen = []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            seen.append(("enter", self.dev))

        def __exit__(self, *exc):
            seen.append(("exit", self.dev))

    def entry(*args):
        seen.append(("call", args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=(str(dev), 7)))
    monkeypatch.setattr(_lib, "lib", lambda: SimpleNamespace(ag_front_kernel=entry))
    t = torch.empty(1, device="meta")
    assert _lib.launch("front_kernel", t, 1, 2) == 0
    assert seen == [("enter", t.device), ("call", (1, 2, ("meta", 7))), ("exit", t.device)]
    sources = [p.read_text() for p in (PKG / "kernels").glob("*.py")]
    assert sum(s.count("launch(") for s in sources) >= 10
    assert not any("lib()." in s for s in sources)


def test_detector_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TagDetector()


@pytest.mark.parametrize("name", ["front", "cluster", "hamming", "front_decimate",
                                  "cluster_f32", "nms", "refine", "fused", "gray",
                                  "cluster_blur", "front_emit_blur"])
def test_wrappers_never_fall_back(name):
    """A tensor on a device the wrapper does not serve is an error, not a
    quiet plain run."""
    meta = torch.device("meta")
    if name == "front":
        raw = torch.empty((1, 80, 128), dtype=torch.uint8, device=meta)
        call = lambda: front_kernel(raw, 1.5, (64, 128), 1, False)  # noqa: E731
    elif name == "front_emit_blur":
        raw = torch.empty((1, 80, 128), dtype=torch.uint8, device=meta)
        call = lambda: front_kernel(raw, 1.5, (64, 128), 1, False, emit_blur=True)  # noqa: E731
    elif name == "fused":
        luma = torch.empty((1, 60, 100), dtype=torch.float32, device=meta)
        call = lambda: fused_frontend(luma, 1.5)  # noqa: E731
    elif name == "gray":
        img = torch.empty((1, 60, 100, 3), dtype=torch.uint8, device=meta)
        call = lambda: gray_kernel(img)  # noqa: E731
    elif name == "cluster_blur":
        blur = torch.empty((1, 64, 128), dtype=torch.float32, device=meta)
        thr = torch.empty((1,), dtype=torch.float32, device=meta)
        call = lambda: cluster_rochade(blur, thr, 60, 100)  # noqa: E731
    elif name == "cluster":
        raw = torch.empty((1, 80, 128), dtype=torch.uint8, device=meta)
        thr = torch.empty((1,), dtype=torch.float32, device=meta)
        call = lambda: cluster_rochade_raw(raw, thr, 64, 128)  # noqa: E731
    elif name == "front_decimate":
        raw = torch.empty((1, 80, 128), dtype=torch.uint8, device=meta)
        call = lambda: front_kernel_decimate(raw, 1.5, (64, 128), 1, False)  # noqa: E731
    elif name in ("cluster_f32", "nms"):
        half = torch.empty((1, 80, 128), dtype=torch.float32, device=meta)
        thr = torch.empty((1,), dtype=torch.float32, device=meta)
        if name == "nms":
            call = lambda: nms_extract_raw(half, thr, 32, 64)  # noqa: E731
        else:
            call = lambda: cluster_rochade_raw(half, thr, 32, 64, luma_f32=True)  # noqa: E731
    elif name == "refine":
        raw = torch.empty((1, 80, 128), dtype=torch.uint8, device=meta)
        centers = torch.empty((1, 8, 2), dtype=torch.float32, device=meta)
        valid = torch.empty((1, 8), dtype=torch.bool, device=meta)
        call = lambda: sparse_refine_raw(raw, centers, valid, 64, 128)  # noqa: E731
    else:
        rots = torch.empty((1, 8, 36), device=meta)
        codes = torch.empty((5, 36), device=meta)
        call = lambda: hamming_scan(rots, codes)  # noqa: E731
    with pytest.raises(ValueError, match="not served"):
        call()


@pytest.mark.parametrize("name", ["front", "front_decimate", "cluster", "cluster_f32",
                                  "nms", "nms_merge"])
def test_mode_wrappers_never_fall_back(name):
    """The row-sharding modes and the peak merge: a tensor on a device the
    wrapper does not serve is an error too, and ``row_off`` without
    ``global_h`` is refused before any run."""
    meta = torch.device("meta")
    roff = torch.zeros((1,), dtype=torch.int32, device=meta)
    raw = torch.empty((1, 80, 128), dtype=torch.uint8, device=meta)
    half = torch.empty((1, 80, 128), dtype=torch.float32, device=meta)
    thr = torch.empty((1,), dtype=torch.float32, device=meta)
    call = {
        "front": lambda **kw: front_kernel(raw, 1.5, (64, 128), 1, False, **kw),
        "front_decimate": lambda **kw: front_kernel_decimate(raw, 1.5, (64, 128), 1, False,
                                                             **kw),
        "cluster": lambda **kw: cluster_rochade_raw(raw, thr, 64, 128, **kw),
        "cluster_f32": lambda **kw: cluster_rochade_raw(half, thr, 32, 64, luma_f32=True,
                                                        **kw),
        "nms": lambda **kw: nms_extract_raw(half, thr, 32, 64, **kw),
        "nms_merge": lambda **kw: nms_extract_raw(half, thr, 32, 64, merge=8, **kw),
    }[name]
    with pytest.raises(ValueError, match="not served"):
        call(row_off=roff, global_h=256) if name != "nms_merge" else call()
    with pytest.raises(ValueError, match="row_off without global_h"):
        call(row_off=roff)


@pytest.mark.parametrize("family", [f.value for f in JFamily])
def test_family_round_trip(family):
    j = j_family(family)
    got = family_from_numpy(family, j.code_bits, j.codes, j.edge, j.border,
                            j.hamming_distance, j.rot_perm)
    own = get_family(family)
    for spec in (got, own):
        assert spec.family == TagFamily(family)
        assert (spec.edge, spec.border, spec.hamming_distance, spec.side_bits) == (
            j.edge, j.border, j.hamming_distance, j.side_bits)
        np.testing.assert_array_equal(spec.codes, j.codes)
        np.testing.assert_array_equal(spec.code_bits, j.code_bits)
        np.testing.assert_array_equal(spec.rot_perm, j.rot_perm)
    t = own.code_bits_tensor("cpu")
    assert t.dtype == torch.float32 and t.shape == j.code_bits.shape


def test_family_from_numpy_checks_shapes():
    j = j_family("t16h5")
    with pytest.raises(ValueError):
        family_from_numpy("t16h5", j.code_bits[:, :9], j.codes, j.edge,
                          j.border, j.hamming_distance, j.rot_perm)


def test_params_round_trip():
    params, consts, caps = params_from_dict(
        dataclasses.asdict(jconfig.DEFAULT_PARAMS),
        dataclasses.asdict(jconfig.CONSTANTS),
        dataclasses.asdict(jconfig.DEFAULT_CAPACITIES),
    )
    assert (params, consts, caps) == (DEFAULT_PARAMS, CONSTANTS, DEFAULT_CAPACITIES)
    custom = dataclasses.asdict(jconfig.DetectorParams(max_num_of_boards=1))
    assert params_from_dict(custom, dataclasses.asdict(jconfig.CONSTANTS),
                            {})[0].max_num_of_boards == 1
    # the plane path's capacities are public API and carry across
    jcaps = jconfig.Capacities(max_clusters=8, max_masked=64, label_prop_rounds=1)
    caps = params_from_dict({}, {}, dataclasses.asdict(jcaps))[2]
    assert (caps.max_clusters, caps.max_masked, caps.label_prop_rounds) == (8, 64, 1)
    assert dataclasses.asdict(caps) == dataclasses.asdict(jcaps)
    with pytest.raises(ValueError):
        params_from_dict({"nope": 1}, {}, {})


@pytest.mark.parametrize("name", ["EuRoC", "TUM_VI", "two_boards"])
def test_chip_smoke_png_reader_matches_pil(data_dir, name):
    from PIL import Image

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    got = chip_smoke.read_png(data_dir / f"{name}.png")
    ref = np.asarray(Image.open(data_dir / f"{name}.png"))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_version_is_the_jax_packages_and_pyprojects():
    import tomllib

    import aprilgrid_tpu
    import aprilgrid_tpu_torch

    project = tomllib.loads((Path(__file__).resolve().parent.parent / "pyproject.toml")
                            .read_text())["project"]
    assert aprilgrid_tpu_torch.__version__ == aprilgrid_tpu.__version__ == project["version"]


def test_parse_ptxas_report():
    """The build keeps what ptxas says of each kernel; the parser reads
    name, registers, stack frame, spills and shared memory."""
    from aprilgrid_tpu_torch.kernels._lib import parse_ptxas

    text = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN49_GLOBAL__N__d1f2_10_cluster_cu_ab1213record_kernelEPKiS1_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN49_GLOBAL__N__d1f2record_kernelEPKiS1_\n"
        "    552 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 0 barriers, 552 bytes cumulative stack "
        "size, 1212 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN49_GLOBAL__N__d1f2_10_cluster_cu_ab1216blur_mask_kernelEPKv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN49_GLOBAL__N__d1f2blur_mask_kernelEPKv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 43 registers, used 1 barriers, 39752 bytes smem, 472 bytes "
        "cmem[0]\n"
    )
    assert parse_ptxas(text) == [
        {"kernel": "record_kernel", "registers": 40, "stack_bytes": 552,
         "spill_store_bytes": 8, "spill_load_bytes": 4, "smem_bytes": 0},
        {"kernel": "blur_mask_kernel", "registers": 43, "stack_bytes": 0,
         "spill_store_bytes": 0, "spill_load_bytes": 0, "smem_bytes": 39752},
    ]


def test_parse_ptxas_names_template_instances():
    """A kernel template's instances (one per raw mode) are told apart by
    their integer argument."""
    from aprilgrid_tpu_torch.kernels._lib import parse_ptxas

    text = "".join(
        "ptxas info    : Compiling entry function "
        f"'_ZN60_GLOBAL__N__3b2a_11_frontend_cu_c0d121front_decimate_kernelILi{n}EEEvPKv' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {40 + n} registers, used 1 barriers, 44832 bytes smem\n"
        for n in (0, 2)
    )
    assert [(r["kernel"], r["registers"], r["smem_bytes"]) for r in parse_ptxas(text)] == [
        ("front_decimate_kernel<0>", 40, 44832), ("front_decimate_kernel<2>", 42, 44832),
    ]
