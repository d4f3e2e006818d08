"""The PyTorch port's TagDetector (exact hybrid mode, plain versions on the
CPU) held against the JAX TagDetector and the NumPy oracle: the oracle's
tag-ID sets with corners < 0.1 px from it, <= 1e-3 px from the JAX
detector, and the golden counts."""

import warnings

import numpy as np
import pytest

from aprilgrid_tpu.detector import TagDetector as JaxDetector
from aprilgrid_tpu.oracle.numpy_ref import TagDetector as Oracle, load_image
from aprilgrid_tpu_torch import DetectorParams, TagDetector
from aprilgrid_tpu_torch import detector as tdetector
from conftest import GOLDEN_COUNTS, make_stress_scene


@pytest.fixture(scope="module")
def det():
    return TagDetector("t36h11", device="cpu")


def _check(got, img, min_tags=8):
    ref = Oracle("t36h11").detect(img)
    jax_tags = JaxDetector("t36h11").detect(img)
    assert set(got) == set(ref) == set(jax_tags)
    assert len(ref) >= min_tags
    for tid in got:
        c = np.asarray(got[tid])
        assert np.abs(c - np.asarray(ref[tid])).max() < 0.1, tid
        assert np.abs(c - np.asarray(jax_tags[tid])).max() <= 1e-3, tid


def test_detect_batch_euroc(det, data_dir):
    img = load_image(str(data_dir / "EuRoC.png"))
    res = det.detect_batch(np.stack([img, np.zeros_like(img), img]))
    assert len(res) == 3 and res[1] == {}
    assert len(res[0]) == GOLDEN_COUNTS["EuRoC"]
    assert res[0] == res[2]
    _check(res[0], img)


@pytest.mark.parametrize("kind,seed", [("u16", 1), ("rgb", 3), ("two_boards", 2)])
def test_detect_stress_scene(det, kind, seed):
    img = make_stress_scene(seed, kind=kind)
    got = det.detect_batch(img[None])[0]
    _check(got, img, min_tags=12 if kind == "two_boards" else 8)
    if kind == "two_boards":  # the second pass found the second board
        assert any(t < 16 for t in got) and any(t >= 16 for t in got)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["iphone", "two_boards"])
def test_detect_golden_1080p(det, data_dir, name):
    img = load_image(str(data_dir / f"{name}.png"))
    got = det.detect(img)
    assert len(got) == GOLDEN_COUNTS[name]
    _check(got, img)


def test_detect_chunks_match_whole_batch(det, data_dir):
    img = load_image(str(data_dir / "EuRoC.png"))
    frames = np.stack([img, img[:, ::-1].copy(), img])
    assert det.detect_batch(frames, chunk=1) == det.detect_batch(frames)


def test_blank_image_finds_nothing(det):
    assert det.detect(np.full((128, 160), 128, np.uint8)) == {}


def test_zero_boards_dispatches_no_frontend(monkeypatch, data_dir):
    def boom(*a, **k):
        raise AssertionError("front-end dispatched with max_num_of_boards=0")

    monkeypatch.setattr(tdetector, "frontend_packed", boom)
    d = TagDetector(params=DetectorParams(max_num_of_boards=0), device="cpu")
    img = load_image(str(data_dir / "EuRoC.png"))
    assert d.detect_batch(np.stack([img, img])) == [{}, {}]


def test_default_chunk():
    assert tdetector._default_chunk(1080, 1920) == 32
    assert tdetector._default_chunk(2160, 3840) == 16
    assert tdetector._default_chunk(480, 752) == 64


@pytest.mark.parametrize("col", [0, 1, 2])
def test_warn_counters(col):
    cnts = np.zeros((2, 3), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdetector._warn_counters(cnts)
    cnts[1, col] = 1
    with pytest.warns(RuntimeWarning):
        tdetector._warn_counters(cnts)


@pytest.mark.parametrize("kw", [{"mode": "xla"}, {"decimate": True},
                                {"decimate": "auto"}])
def test_unported_modes_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TagDetector(device="cpu", **kw)
