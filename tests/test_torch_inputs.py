"""The port's facade on the input forms users hand it (CPU, plain versions):
the JAX package's end-to-end input-mode and capacity-warning tests on the
port, and read-only numpy frames (what PIL hands over), which it takes
without a copy and without a warning."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from aprilgrid_tpu.oracle.numpy_ref import load_image
from aprilgrid_tpu_torch import TagDetector, to_detector_input
from aprilgrid_tpu_torch.config import DEFAULT_CAPACITIES
from conftest import GOLDEN_COUNTS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain versions' many small operations do
    not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def det():
    return TagDetector("t36h11", device="cpu")


@pytest.fixture(scope="module")
def euroc(det, data_dir):
    """EuRoC (L8) and its tags."""
    g8 = load_image(str(data_dir / "EuRoC.png"))
    base = det.detect(g8)
    assert len(base) == 36
    return g8, base


def _euroc_modes(g8):
    """EuRoC re-encoded without changing its content, as
    tests/test_input_modes.py::_as_modes does (x257 is the exact u8 -> u16
    embedding)."""
    g16 = g8.astype(np.uint16) * 257
    rgb16 = np.repeat(g16[..., None], 3, axis=2)
    return {
        "LA8": np.stack([g8, np.full_like(g8, 255)], axis=2),
        "RGB16": rgb16,
        "RGBA16": np.concatenate([rgb16, np.full_like(g16, 65535)[..., None]], axis=2),
        "L32F": g8.astype(np.float32) / 255.0,
    }


@pytest.mark.parametrize("mode", ["LA8", "RGB16", "RGBA16", "L32F"])
def test_detect_modes_end_to_end(det, euroc, mode):
    """tests/test_input_modes.py::test_detect_modes_end_to_end on the port:
    a re-encoded twin gives the L8 frame's IDs, with corners equal for LA8
    and within 1e-3 px for the quantized wide modes."""
    g8, base = euroc
    got = det.detect(_euroc_modes(g8)[mode])
    assert set(got) == set(base)
    err = max(np.abs(np.asarray(got[t]) - np.asarray(base[t])).max() for t in base)
    if mode == "LA8":
        assert err == 0.0
    else:
        assert err < 1e-3, err


def test_saddle_overflow_warns_hybrid(euroc):
    """tests/test_counters.py::test_saddle_overflow_warns_hybrid on the
    port: EuRoC's ~191 saddles in 64 slots warn."""
    caps = dataclasses.replace(DEFAULT_CAPACITIES, max_saddles=64)
    d = TagDetector("t36h11", capacities=caps, device="cpu")
    with pytest.warns(RuntimeWarning, match="saddle capacity"):
        d.detect_batch(np.stack([euroc[0]]))


@pytest.mark.parametrize("name", ["EuRoC", "TUM_VI"])
def test_read_only_frames_raise_no_warning(det, data_dir, name):
    """``np.asarray(Image.open(p))`` is read-only: ``detect``,
    ``detect_batch``, ``refined_saddle_points`` and ``to_detector_input``
    take it without a warning (the tensor aliases it, no copy), and the
    frame is left as it was."""
    img = np.asarray(Image.open(data_dir / f"{name}.png"))
    assert not img.flags.writeable
    before = img.copy()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        one = det.detect(img)
        batch = det.detect_batch(img[None])
        saddles = det.refined_saddle_points(img)
        t = to_detector_input(img)
    assert len(one) == GOLDEN_COUNTS[name] and batch == [one] and saddles
    assert t.data_ptr() == img.ctypes.data
    np.testing.assert_array_equal(img, before)
