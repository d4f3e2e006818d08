"""The PyTorch port's input adapters, streaming ingest and multi-camera
detector (aprilgrid_tpu_torch/adapters.py, parallel/streaming.py) and its
two API-parity pieces (``saddle_distance2``, ``ops.decode.tag_homography``),
on the CPU, held against the JAX package on the same numpy inputs: the same
arrays and errors from the adapter, tag-ID sets equal and corners within
1e-3 px of the JAX results, and bit for bit the port's own
``detect_batch`` where a function wraps it."""

import numpy as np
import pytest
import torch

from aprilgrid_tpu.adapters import (
    detect_adapted as jax_detect_adapted,
    to_detector_input as jax_to_detector_input,
)
from aprilgrid_tpu.detector import Saddle as JaxSaddle, TagDetector as JaxDetector
from aprilgrid_tpu.detector import saddle_distance2 as jax_saddle_distance2
from aprilgrid_tpu.oracle.numpy_ref import load_image
from aprilgrid_tpu.ops.decode import tag_homography as jax_tag_homography
from aprilgrid_tpu.parallel.sharding import make_mesh as jax_make_mesh
from aprilgrid_tpu.parallel.streaming import (
    MultiCameraDetector as JaxMultiCamera,
    detect_stream as jax_detect_stream,
)
from aprilgrid_tpu_torch import TagDetector
from aprilgrid_tpu_torch.adapters import detect_adapted, to_detector_input
from aprilgrid_tpu_torch.detector import Saddle, _HostUpload, saddle_distance2
from aprilgrid_tpu_torch.ops.decode import tag_homography
from aprilgrid_tpu_torch.parallel.sharding import make_mesh
from aprilgrid_tpu_torch.parallel.streaming import MultiCameraDetector, detect_stream

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions run many small operations; with one intra-op
    thread they do not spin against the other test workers' threads (as in
    tests/test_torch_sharding.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def det():
    return TagDetector("t36h11", device="cpu")


@pytest.fixture(scope="module")
def jdet():
    return JaxDetector("t36h11")


@pytest.fixture(scope="module")
def euroc(data_dir):
    return load_image(str(data_dir / "EuRoC.png"))


@pytest.fixture(scope="module")
def crop(data_dir):
    """The 540x960 top-left of two_boards, the JAX turbo tests' crop."""
    return np.ascontiguousarray(load_image(str(data_dir / "two_boards.png"))[:540, :960])


def _same_tags(got: dict, want: dict, least: int = 1):
    """ID sets equal, corners within 1e-3 px."""
    assert set(got) == set(want) and len(got) >= least
    for tid in got:
        assert np.abs(np.asarray(got[tid]) - np.asarray(want[tid])).max() <= 1e-3, tid


# -- adapters ---------------------------------------------------------------

# every layout of the JAX tests test_layout_normalization
# (tests/test_adapters_streaming.py) and test_adapter_widened_modes
# (tests/test_input_modes.py:138-157), with seeded values
LAYOUTS = [
    ("1HW u8", (1, 10, 12), np.uint8),
    ("HW1 u8", (10, 12, 1), np.uint8),
    ("CHW RGB u8", (3, 10, 12), np.uint8),
    ("HWC RGBA u8", (10, 12, 4), np.uint8),
    ("HW f32", (10, 12), np.float32),
    ("HWC LA u8", (6, 8, 2), np.uint8),
    ("CHW LA u16", (2, 6, 8), np.uint16),
    ("HWC RGBA u16", (6, 8, 4), np.uint16),
    ("HW f64", (6, 8), np.float64),
]


def _seeded(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return rng.random(shape).astype(dtype)
    return rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)


@pytest.mark.parametrize("source", ["numpy", "torch"])
@pytest.mark.parametrize("label,shape,dtype", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_to_detector_input_matches_jax(label, shape, dtype, source):
    arr = _seeded(shape, dtype)
    want = jax_to_detector_input(arr)
    got = to_detector_input(arr if source == "numpy" else torch.from_numpy(arr))
    assert isinstance(got, torch.Tensor) and got.device == CPU and got.is_contiguous()
    assert got.numpy().dtype == want.dtype and got.shape == want.shape, label
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,dtype,error", [
    ((10, 12, 5), np.uint8, ValueError),
    ((6, 8, 5), np.uint8, ValueError),
    ((2, 3, 4, 5), np.uint8, ValueError),
    ((10, 12), np.int64, TypeError),
    ((6, 8), np.int32, TypeError),
])
def test_to_detector_input_errors_match_jax(shape, dtype, error):
    arr = np.zeros(shape, dtype)
    with pytest.raises(error):
        jax_to_detector_input(arr)
    with pytest.raises(error):
        to_detector_input(arr)


def test_to_detector_input_dlpack_producer():
    """Another ``__dlpack__`` producer goes through ``torch.from_dlpack``."""

    class Producer:
        def __init__(self, a):
            self.a = a

        def __dlpack__(self, **kw):
            return self.a.__dlpack__(**kw)

        def __dlpack_device__(self):
            return self.a.__dlpack_device__()

    arr = _seeded((3, 10, 12), np.uint8, seed=4)
    got = to_detector_input(Producer(arr))
    np.testing.assert_array_equal(got.numpy(), jax_to_detector_input(arr))


def test_detect_adapted_torch_chw_matches_jax(det, jdet, euroc):
    chw = torch.from_numpy(np.stack([euroc] * 3, -1)).permute(2, 0, 1)
    got = detect_adapted(det, chw)
    assert len(got) == 36
    _same_tags(got, jax_detect_adapted(jdet, chw), least=36)


# -- the upload helper --------------------------------------------------------

def test_host_upload_on_the_cpu_is_from_numpy():
    """For a CPU device the upload wraps the batch and stages nothing."""
    arr = _seeded((2, 6, 8), np.uint16)
    up = _HostUpload(arr, CPU)
    assert up.host is None and up.event is None
    t = up.tensor()
    assert t.dtype == torch.uint16 and np.shares_memory(t.numpy(), arr)


# -- streaming ----------------------------------------------------------------

def test_detect_stream_prefetches_before_each_detect():
    """The next upload is enqueued before the host blocks on the current
    detect: when batch k's detect starts, batches up to k + prefetch have
    been pulled from the iterable."""
    pulled, seen = [], []

    class Recorder:
        device = CPU

        def detect_batch(self, imgs):
            seen.append((int(imgs[0, 0, 0]), len(pulled)))
            return [{} for _ in range(imgs.shape[0])]

    def batches():
        for k in range(5):
            pulled.append(k)
            yield np.full((1, 2, 2), k, np.uint8)

    out = list(detect_stream(Recorder(), batches(), prefetch=2))
    assert len(out) == 5
    assert seen == [(0, 3), (1, 4), (2, 5), (3, 5), (4, 5)]


def test_detect_stream_matches_detect_batch_and_jax(det, jdet, data_dir):
    """Three two_boards b2 batches of broadcast views (the JAX
    test_detect_stream_pipelined's input)."""
    img = load_image(str(data_dir / "two_boards.png"))
    batches = [np.broadcast_to(img, (2,) + img.shape) for _ in range(3)]
    got = list(detect_stream(det, iter(batches), prefetch=2))
    ref = det.detect_batch(batches[0])
    assert len(got) == 3 and all(res == ref for res in got)
    assert all(len(r) == 72 for r in ref)
    want = list(jax_detect_stream(jdet, iter(batches[:1]), prefetch=2))[0]
    for r, w in zip(ref, want):
        _same_tags(r, w, least=72)


def test_turbo_detect_stream_matches_detect_batch_and_jax(crop):
    """The turbo mode on the 540x960 crop (JAX test_decimate.py::
    test_turbo_detect_stream)."""
    tdet = TagDetector("t36h11", device="cpu", decimate=True)
    batches = [np.broadcast_to(crop, (2,) + crop.shape) for _ in range(2)]
    got = list(detect_stream(tdet, iter(batches), prefetch=2))
    ref = tdet.detect_batch(batches[0])
    assert len(got) == 2 and all(res == ref for res in got)
    want = JaxDetector("t36h11", decimate=True).detect_batch(batches[0])
    for r, w in zip(ref, want):
        _same_tags(r, w, least=10)


# -- multi-camera ---------------------------------------------------------------

@pytest.fixture(scope="module")
def rig(euroc):
    """Two cameras of two frames, camera 1's second frame blank."""
    return np.stack([np.stack([euroc, euroc]), np.stack([euroc, np.zeros_like(euroc)])])


@pytest.fixture(scope="module")
def rig_ref(det, rig):
    """The rig's frames through ``detect_batch``, split per camera."""
    flat = det.detect_batch(rig.reshape((4,) + rig.shape[2:]))
    return [flat[:2], flat[2:]]


def test_multicamera_camera_mesh_matches_jax(det, jdet, rig, rig_ref):
    got = MultiCameraDetector(det, make_mesh({"camera": 2}, [CPU] * 2)).detect(rig)
    assert got == rig_ref
    assert [[len(t) for t in cam] for cam in got] == [[36, 36], [36, 0]]
    want = JaxMultiCamera(jdet, jax_make_mesh({"camera": 2})).detect(rig)
    for gc, wc in zip(got, want):
        for g, w in zip(gc, wc):
            _same_tags(g, w, least=0)


def test_multicamera_without_mesh(det, rig, rig_ref):
    got = MultiCameraDetector(det).detect(torch.from_numpy(rig))
    assert got == rig_ref


def test_multicamera_requires_camera_axis(det):
    with pytest.raises(ValueError, match="camera"):
        MultiCameraDetector(det, make_mesh({"data": 2}, [CPU] * 2))


# -- API parity ---------------------------------------------------------------

def test_saddle_distance2_matches_jax():
    s0, s1 = Saddle(p=(0.0, 0.0), k=1.0, theta=0.0, phi=45.0), \
        Saddle(p=(3.0, 4.0), k=1.0, theta=0.0, phi=45.0)
    j0, j1 = JaxSaddle(p=(0.0, 0.0), k=1.0, theta=0.0, phi=45.0), \
        JaxSaddle(p=(3.0, 4.0), k=1.0, theta=0.0, phi=45.0)
    assert saddle_distance2(s0, s1) == jax_saddle_distance2(j0, j1) == 25.0
    s2 = Saddle(p=(-1.5, 2.25), k=0.0, theta=0.0, phi=0.0)
    assert saddle_distance2(s1, s2) == jax_saddle_distance2(
        j1, JaxSaddle(p=(-1.5, 2.25), k=0.0, theta=0.0, phi=0.0))


@pytest.mark.parametrize("corners,side_bits,margin", [
    ([(3.0, 2.0), (1.0, 41.0), (47.0, 43.0), (40.0, 5.0)], 10, 0.5),
    ([(100.5, 80.25), (98.0, 131.0), (152.75, 135.5), (149.0, 77.0)], 8, 1.0),
    ([(1800.5, 1000.25), (1790.0, 1031.0), (1822.75, 1035.5), (1819.0, 1007.0)], 6, 1.0),
])
def test_tag_homography_maps_source_to_corners(corners, side_bits, margin):
    """H maps the canonical source square to the corners within 1e-3 px and
    is proportional to the JAX package's H (a singular vector's sign and
    scale are not unique)."""
    h = tag_homography(corners, side_bits, margin)
    assert h.shape == (3, 3) and h.dtype == torch.float32
    s = side_bits - 1.0 + margin
    src = np.array([(-margin, -margin), (-margin, s), (s, s), (s, -margin)], np.float64)
    pts = np.concatenate([src, np.ones((4, 1))], axis=1) @ h.numpy().astype(np.float64).T
    np.testing.assert_allclose(pts[:, :2] / pts[:, 2:3], np.array(corners), atol=1e-3)
    hj = jax_tag_homography(corners, side_bits, margin).astype(np.float64)
    hp = h.numpy().astype(np.float64)
    k = np.argmax(np.abs(hj))
    np.testing.assert_allclose(hp / hp.flat[k], hj / hj.flat[k], atol=1e-4)


# -- the bench's stream mode ----------------------------------------------------

def test_bench_stream_mode_on_the_cpu():
    """``python3 -m aprilgrid_tpu_torch.bench --stream`` (the port of
    tools/bench_stream.py): a line per way with its keys, the golden count
    held, then the overlap ratio."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    # one intra-op thread, as the in-process tests (module fixture above)
    env = dict(os.environ, BENCH_BATCH="2", BENCH_NBATCH="2", BENCH_REPS="1",
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "aprilgrid_tpu_torch.bench", "--device", "cpu", "--stream",
         "--images", "EuRoC"],
        cwd=Path(__file__).resolve().parent.parent, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    *ways, overlap = (json.loads(line) for line in out.stdout.strip().splitlines())
    assert [w["stream"] for w in ways] == ["serial", "numpy", "streamed", "device"]
    for w in ways:
        assert {"frames_per_s", "ingest_mb_per_s", "seconds", "batch_done_ms", "card"} <= set(w)
        assert w["tags"] == 36 and w["batches"] == 2 and len(w["batch_done_ms"][0]) == 2
    assert overlap["stream_overlap"] > 0 and overlap["image"] == "EuRoC"
