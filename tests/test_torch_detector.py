"""The PyTorch port's TagDetector (exact hybrid mode; the turbo mode is in
test_torch_decimate.py; plain versions on the CPU) held against the JAX TagDetector and the NumPy oracle: the oracle's
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


@pytest.fixture(scope="module")
def two_pass_scene(det):
    """A two-board scene (two board passes), a blank frame, and the
    single-frame results they must give."""
    scene = make_stress_scene(2, kind="two_boards")
    want = det.detect(scene)
    assert any(t < 16 for t in want) and any(t >= 16 for t in want)
    return scene, np.zeros_like(scene), want


# (frames, chunk, AG_SEARCH_ASYNC, AG_FILL_RAMP): three frames in 3, 2 and 1
# chunks; sixteen in two chunks of 8, the first split in half by the ramp
@pytest.mark.parametrize("n,chunk,search_async,ramp", [
    (3, 1, "0", "0"), (3, 1, "1", "0"), (3, 2, "0", "0"), (3, 2, "1", "0"),
    (3, 3, "0", "0"), (3, 3, "1", "0"), (16, 8, "1", "1"),
])
def test_detect_chunks_match_whole_batch(det, two_pass_scene, monkeypatch, n, chunk,
                                         search_async, ramp):
    """The runtime's results are identical for every chunk size, with and
    without the background search and the fill ramp."""
    scene, blank, want = two_pass_scene
    # boards in every chunk (and in both halves of the ramp's first chunk)
    has = {0, 2} if n == 3 else {0, 5, 9}
    frames = np.stack([scene if i in has else blank for i in range(n)])
    monkeypatch.setenv("AG_SEARCH_ASYNC", search_async)
    monkeypatch.setenv("AG_FILL_RAMP", ramp)
    monkeypatch.setenv("AG_TIMELINE", "1")
    assert det.detect_batch(frames, chunk=chunk) == [want if i in has else {}
                                                     for i in range(n)]
    fronts = [e[0] for e in det.last_timeline if e[0].startswith("fe_dispatch")]
    assert len(fronts) == -(-n // chunk) + (ramp == "1")


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


@pytest.mark.parametrize("kw", [{"mode": "xla"},
                                {"mode": "xla", "decimate": True},
                                {"mode": "xla", "decimate": "auto"}])
def test_xla_constructions_match_jax_facade(kw):
    """The xla mode's constructions: the mode and the decimate policy on a
    1080p and a 480p frame equal the JAX facade's."""
    det = TagDetector(device="cpu", **kw)
    jdet = JaxDetector("t36h11", **kw)
    assert det.mode == jdet.mode == "xla"
    for hw in ((1080, 1920), (480, 752)):
        assert det._use_decimate(*hw) == jdet._use_decimate(*hw)


@pytest.mark.parametrize("mode", ["foo", "XLA", ""])
def test_unknown_mode_raises_value_error(mode):
    with pytest.raises(ValueError, match="unknown mode") as jerr:
        JaxDetector("t36h11", mode=mode)
    with pytest.raises(ValueError, match="unknown mode") as terr:
        TagDetector(device="cpu", mode=mode)
    assert str(terr.value) == str(jerr.value)


def test_ag_chunk_env_sizes_the_chunks(det, data_dir, monkeypatch):
    img = load_image(str(data_dir / "EuRoC.png"))
    frames = np.stack([img, img[:, ::-1].copy(), img])
    want = det.detect_batch(frames)
    sizes = []
    front = tdetector.frontend_packed

    def counted(chunk_frames, *a, **k):
        sizes.append(int(chunk_frames.shape[0]))
        return front(chunk_frames, *a, **k)

    monkeypatch.setattr(tdetector, "frontend_packed", counted)
    monkeypatch.setenv("AG_CHUNK", "1")
    assert det.detect_batch(frames) == want
    assert sizes == [1, 1, 1]
