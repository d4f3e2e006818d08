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
from aprilgrid_tpu_torch.kernels.cluster import cluster_rochade_raw
from aprilgrid_tpu_torch.kernels.decode import hamming_scan
from aprilgrid_tpu_torch.kernels.frontend import front_kernel

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "aprilgrid_tpu_torch"


def test_import_pulls_in_no_jax():
    code = (
        "import sys, aprilgrid_tpu_torch, aprilgrid_tpu_torch.detector, "
        "aprilgrid_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'aprilgrid_tpu' or m.startswith('aprilgrid_tpu.')]\n"
        "print(bad)\nsys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_names_jax_or_the_jax_package():
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    assert len(files) > 15
    for p in files:
        text = p.read_text()
        assert not re.search(r"\bjax\b", text), p
        assert not re.search(r"\baprilgrid_tpu\.", text), p


def test_detector_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TagDetector()


@pytest.mark.parametrize("name", ["front", "cluster", "hamming"])
def test_wrappers_never_fall_back(name):
    """A tensor on a device the wrapper does not serve is an error, not a
    quiet plain run."""
    meta = torch.device("meta")
    if name == "front":
        raw = torch.empty((1, 80, 128), dtype=torch.uint8, device=meta)
        call = lambda: front_kernel(raw, 1.5, (64, 128), 1, False)  # noqa: E731
    elif name == "cluster":
        raw = torch.empty((1, 80, 128), dtype=torch.uint8, device=meta)
        thr = torch.empty((1,), dtype=torch.float32, device=meta)
        call = lambda: cluster_rochade_raw(raw, thr, 64, 128)  # noqa: E731
    else:
        rots = torch.empty((1, 8, 36), device=meta)
        codes = torch.empty((5, 36), device=meta)
        call = lambda: hamming_scan(rots, codes)  # noqa: E731
    with pytest.raises(ValueError, match="not served"):
        call()


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
