"""The PyTorch port's row sharding (aprilgrid_tpu_torch/parallel/sharding.py)
on a mesh of CPU devices, held against the port's own single-device path,
which the other test files hold against the JAX package: the stencil and
plain front-ends, the kernel front-ends (exact and turbo) slot for slot, the
row-sharding mode of each kernel on a window against the whole frame, the
mesh and shape errors, and the claim context's bound on a tall blob. Then
the data- and pipeline-parallel detectors (``detect_batch_sharded``,
parallel/pipeline_parallel.py) on CPU meshes: bit for bit the port's own
``detect_batch``, and tag-ID sets equal with corners within 1e-3 px of the
JAX functions on the JAX package's CPU mesh."""

import numpy as np
import pytest
import torch

from aprilgrid_tpu.detector import TagDetector as JaxDetector
from aprilgrid_tpu.oracle.numpy_ref import load_image
from aprilgrid_tpu.parallel.pipeline_parallel import (
    PipelineParallelDetector as JaxPipelineParallel,
)
from aprilgrid_tpu.parallel.sharding import (
    detect_batch_sharded as jax_detect_batch_sharded,
    make_mesh as jax_make_mesh,
)
from aprilgrid_tpu_torch import TagDetector
from aprilgrid_tpu_torch.parallel import sharding as tsharding
from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
from aprilgrid_tpu_torch.kernels.cluster import cluster_rochade_raw
from aprilgrid_tpu_torch.kernels.frontend import front_kernel, front_kernel_decimate, pad_raw
from aprilgrid_tpu_torch.kernels.nms import nms_extract_raw
from aprilgrid_tpu_torch.ops.frontend import gaussian_blur, hessian_response
from aprilgrid_tpu_torch.ops.gray import to_luma
from aprilgrid_tpu_torch.ops.rochade import Saddles
from aprilgrid_tpu_torch.parallel.pipeline_parallel import PipelineParallelDetector
from aprilgrid_tpu_torch.parallel.sharding import (
    CTX,
    detect_batch_sharded,
    frontend_rows_sharded,
    make_mesh,
    row_windows,
    saddle_frontend_rows_sharded,
    saddle_frontend_rows_sharded_kernels,
    saddle_frontend_rows_sharded_kernels_turbo,
)
from aprilgrid_tpu_torch.pipeline import (
    _frontend_tail,
    decimated_frontend_batch,
    saddle_frontend_batch,
)

P, C, K = DEFAULT_PARAMS, CONSTANTS, DEFAULT_CAPACITIES
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions run many small operations per shard; with one
    intra-op thread they do not spin against the other test workers'
    threads (measured under a loaded host: 13 s -> 0.3 s a case)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return make_mesh({"sp": n}, [CPU] * n)


def _first(s):
    return Saddles(*(t[0] for t in s))


def _assert_same(got: Saddles, want: Saddles, least: int):
    """Equal saddles, slot for slot, every field bit for bit."""
    assert int(want.valid.sum()) >= least
    for name in Saddles._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _image(data_dir, name):
    img = load_image(str(data_dir / f"{name}.png"))
    if name == "TUM_VI":
        img = img[:512]   # u16, 512 x 1024
    return torch.from_numpy(np.ascontiguousarray(img))


def _edge_scene():
    """Boards flush to the frame's top and bottom edges and one across the
    cut between two bands (tests/test_sharding.py's edge scene): the
    edge shards' alternated decimate rows and the claims across the cut."""
    from PIL import Image

    from aprilgrid_tpu.boards.generator import AprilGridBoard, render_png

    board = AprilGridBoard(size_x=4, size_y=4, tag_family="t36h11",
                           page_width_meter=0.5, page_height_meter=0.5)
    chart = render_png(board, pixels_per_mm=1.0)
    im = Image.fromarray(chart).resize(
        (int(chart.shape[1] * 0.45), int(chart.shape[0] * 0.45)), Image.BILINEAR)
    arr = np.asarray(im)
    ah, aw = arr.shape
    canvas = np.full((832, 768), 160, np.uint8)
    canvas[0:ah, 10 : 10 + aw] = arr
    canvas[832 - ah : 832, 300 : 300 + aw] = arr
    cw = min(aw, 768 - 540)
    canvas[416 - ah // 2 : 416 - ah // 2 + ah, 540 : 540 + cw] = arr[:, :cw]
    return torch.from_numpy(canvas)


def test_make_mesh(monkeypatch):
    mesh = make_mesh({"data": 2, "sp": 3}, ["cpu"] * 6)
    assert mesh.shape == {"data": 2, "sp": 3}
    assert mesh.along("sp") == [CPU] * 3 and len(mesh.along("data")) == 2
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        make_mesh({"sp": 4}, [CPU] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"sp": 2})


@pytest.mark.parametrize("n", [2, 8])
def test_frontend_rows_sharded_matches_single_device(n):
    rng = np.random.default_rng(0)
    luma = torch.from_numpy(rng.uniform(0, 1, (96, 160)).astype(np.float32))
    blur, resp = frontend_rows_sharded(_mesh(n), 1.5)(luma)
    want = gaussian_blur(luma, 1.5)
    assert torch.equal(blur, want) and torch.equal(resp, hessian_response(want))


def test_saddle_frontend_rows_sharded_matches_single_device(data_dir):
    """The plain-ops front-end over 4 shards: the single device's
    ``_frontend_tail`` slot for slot."""
    luma = to_luma(_image(data_dir, "EuRoC"))[0].reshape(480, 752)
    blur = gaussian_blur(luma, C.blur_sigma)
    want = _first(_frontend_tail(blur[None], hessian_response(blur)[None], P, C, K))
    got = saddle_frontend_rows_sharded(_mesh(4), P, C, K)(luma)
    _assert_same(got, want, 150)


@pytest.mark.parametrize("name,n", [("EuRoC", 2), ("EuRoC", 4), ("TUM_VI", 2)])
def test_sharded_kernels_match_single_device(data_dir, name, n):
    """The exact kernel front-end: ``saddle_frontend_batch``'s saddles slot
    for slot (u8 EuRoC over 2 and 4 shards, the u16 TUM_VI crop)."""
    img = _image(data_dir, name)
    want = _first(saddle_frontend_batch(img[None], P, C, K)[0])
    got = saddle_frontend_rows_sharded_kernels(_mesh(n), P, C, K)(img)
    _assert_same(got, want, 80)


@pytest.mark.parametrize("name,n,least", [("EuRoC", 2, 60), ("TUM_VI", 2, 50),
                                          ("edges", 2, 60), ("edges", 4, 60)])
def test_sharded_turbo_matches_single_device(data_dir, name, n, least):
    """The turbo kernel front-end: the single device's turbo path with the
    drain extraction (the port's, not the JAX function's pre-filter) slot
    for slot, on EuRoC, on the u16 TUM_VI crop and on the edge scene over
    2 and 4 shards."""
    img = _edge_scene() if name == "edges" else _image(data_dir, name)
    want = _first(decimated_frontend_batch(img[None], P, C, K, nms=False)[0])
    got = saddle_frontend_rows_sharded_kernels_turbo(_mesh(n), P, C, K)(img)
    _assert_same(got, want, least)


@pytest.mark.parametrize("mode", ["front", "decimate", "cluster", "cluster_f32",
                                  "nms", "nms_merge"])
def test_window_matches_whole_frame(data_dir, mode):
    """Each kernel's row-sharding mode (plain version) on the windows of a
    frame cut into two bands against the same kernel on the whole frame,
    on the rows each window owns: luma8 and the half plane equal, the same
    global response minimum, the same candidate rows (labels made the
    frame's) and the same cells."""
    img = _image(data_dir, "EuRoC")
    h, w = img.shape
    turbo = mode not in ("front", "cluster")
    wins, roff, local_h, gh = row_windows(img, 2, turbo=turbo)
    raw, *_ = pad_raw(img[None])
    hs = h // 2
    band = [(i * hs, (i + 1) * hs) for i in range(2)]
    if mode in ("front", "cluster"):
        l8, tmin = front_kernel(wins, 1.5, (local_h, w), 1, False, row_off=roff, global_h=gh)
        wl8, wtmin = front_kernel(raw, 1.5, (h, w), 1, False)
        assert float(tmin.amin()) == float(wtmin.amin())
        for i, (a, b) in enumerate(band):
            assert torch.equal(l8[i, CTX : CTX + hs, :w], wl8[0, a:b, :w])
        if mode == "front":
            return
        thr = wtmin.amin().expand(2) * C.response_threshold_ratio
        f, _ = cluster_rochade_raw(wins, thr, local_h, w, row_off=roff, global_h=gh)
        wf, _ = cluster_rochade_raw(raw, thr[:1], h, w)
        _same_claims(f, wf[0], w, roff, band)
        return
    _, half_p, tmin = front_kernel_decimate(wins, 1.5, (local_h, w), 1, False,
                                            row_off=roff, global_h=gh)
    _, whalf, wtmin = front_kernel_decimate(raw, 1.5, (h, w), 1, False)
    assert float(tmin.amin()) == float(wtmin.amin())
    hh, wh, hb = local_h // 2, w // 2, hs // 2
    half_band = [(a // 2, b // 2) for a, b in band]
    for i, (a, b) in enumerate(half_band):
        assert torch.equal(half_p[i, 8 + CTX : 8 + CTX + hb, :wh], whalf[0, 8 + a : 8 + b, :wh])
    thr = wtmin.amin().expand(2) * C.response_threshold_ratio
    if mode == "cluster_f32":
        f, _ = cluster_rochade_raw(half_p, thr, hh, wh, luma_f32=True, row_off=roff,
                                   global_h=gh)
        wf, _ = cluster_rochade_raw(whalf, thr[:1], h // 2, wh, luma_f32=True)
        _same_claims(f, wf[0], wh, roff, half_band)
        return
    merge = 8 if mode == "nms_merge" else 0
    cells = nms_extract_raw(half_p, thr, hh, wh, merge=merge, row_off=roff, global_h=gh)
    wcells = nms_extract_raw(whalf, thr[:1], h // 2, wh, merge=merge)
    for i, (a, b) in enumerate(half_band):
        got = cells[i, :, CTX // 4 : (CTX + hb) // 4]
        assert torch.equal(got, wcells[0, :, a // 4 : b // 4])
        assert (got[5] > 0.5).sum() > 40


def _same_claims(f, wf, w, roff, band):
    """Window i's candidate rows with their root in the band (labels made
    the frame's) equal the whole frame's rows rooted there, in label
    order."""
    def rows(t, off, lo, hi):
        t = t[t[:, 6] > 0.5]
        lab = t[:, 7].to(torch.int64) - 1 + off * w
        t = torch.cat([t[:, :7], (lab + 1).to(torch.float32)[:, None]], 1)
        keep = (lab // w >= lo) & (lab // w < hi)
        t = t[keep]
        return t[torch.argsort(t[:, 7])]

    for i, (a, b) in enumerate(band):
        got = rows(f[i], int(roff[i]), a, b)
        assert len(got) > 15
        assert torch.equal(got, rows(wf, 0, a, b))


@pytest.mark.parametrize("case", ["rows", "band", "odd_band", "rgb", "f32"])
def test_sharded_shape_errors(case):
    """The JAX functions' shape asserts, as ValueErrors with their bounds."""
    mesh = _mesh(2)
    exact = saddle_frontend_rows_sharded_kernels(mesh, P, C, K)
    turbo = saddle_frontend_rows_sharded_kernels_turbo(mesh, P, C, K)
    frame = torch.zeros((256, 128), dtype=torch.uint8)
    call, match = {
        "rows": (lambda: exact(frame[:255]), "divisible by 2"),
        "band": (lambda: exact(frame[:96]), r"\(48 rows\) must cover the halo \(56\)"),
        "odd_band": (lambda: turbo(torch.zeros((2 * 212, 128), dtype=torch.uint8)),
                     "8-row multiples"),
        "rgb": (lambda: exact(torch.zeros((256, 128, 3), dtype=torch.uint8)),
                "divisible by 2"),
        "f32": (lambda: exact(frame.to(torch.float32)), "u8 or u16"),
    }[case]
    with pytest.raises(ValueError, match=match):
        call()
    if case == "band":
        with pytest.raises(ValueError, match=r"\(104\)"):
            turbo(torch.zeros((192, 128), dtype=torch.uint8))


def _tall_blob_scene():
    """Two saddle ridges across the cut between two 192-row bands: at
    column 80 a response blob 111 rows tall (rows 137-247), at column 180
    one 27 rows tall, on a flat grey frame."""
    y = np.arange(384)[:, None].astype(np.float64) - 192
    x = np.arange(256)[None, :].astype(np.float64)
    img = np.full((384, 256), 128.0)
    for cx, sig in ((80, 80), (180, 20)):
        u = x - cx
        img += 0.8 * u * np.exp(-u * u / 18.0) * y * np.exp(-((y / sig) ** 8))
    return torch.from_numpy(np.clip(np.round(img), 0, 255).astype(np.uint8))


def test_claim_context_bound_on_a_tall_blob():
    """The claim context (module head): the blob 27 rows tall across the
    cut is the single device's saddle in the sharded run; the one 111 rows
    tall, taller than the 48 rows of context, is cut at the bottom of the
    window that claims it, and its saddle is not the single device's."""
    from aprilgrid_tpu_torch.ops.cluster import label_components

    img = _tall_blob_scene()
    luma = to_luma(img)[0].reshape(img.shape)
    resp = hessian_response(gaussian_blur(luma, C.blur_sigma))
    mask = resp < resp.min() * C.response_threshold_ratio
    lab = label_components(mask)
    rows = {c: torch.nonzero(mask[:, c - 1 : c + 2].any(1) & (lab[:, c] == lab[192, c]))
            for c in (80, 180)}
    assert int(rows[80].min()) == 137 and int(rows[80].max()) == 247
    assert int(rows[180].max() - rows[180].min()) + 1 == 27

    want = _first(saddle_frontend_batch(img[None], P, C, K)[0])
    got = saddle_frontend_rows_sharded_kernels(_mesh(2), P, C, K)(img)
    wp = want.p[want.valid].tolist()
    gp = got.p[got.valid].tolist()
    assert [80.0, 192.0] in wp and [180.0, 192.0] in wp
    assert [180.0, 192.0] in gp and [80.0, 192.0] not in gp


# -- whole detects over a mesh: data and pipeline parallelism ---------------

@pytest.fixture(scope="module")
def det():
    return TagDetector("t36h11", device="cpu")


@pytest.fixture(scope="module")
def jdet():
    return JaxDetector("t36h11")


@pytest.fixture(scope="module")
def euroc4(data_dir):
    """EuRoC x4 with a blank third frame: a frame's result must stay its own."""
    img = load_image(str(data_dir / "EuRoC.png"))
    return np.stack([img, img, np.zeros_like(img), img])


@pytest.fixture(scope="module")
def euroc4_ref(det, euroc4):
    return det.detect_batch(euroc4)


def _same_tags(got: dict, want: dict):
    """ID sets equal, corners within 1e-3 px."""
    assert set(got) == set(want)
    for tid in got:
        assert np.abs(np.asarray(got[tid]) - np.asarray(want[tid])).max() <= 1e-3, tid


@pytest.mark.parametrize("n", [2, 4])
def test_detect_batch_sharded_matches_detect_batch_and_jax(det, jdet, euroc4, euroc4_ref, n):
    got = detect_batch_sharded(det, euroc4, make_mesh({"data": n}, [CPU] * n))
    assert got == euroc4_ref
    assert [len(t) for t in got] == [36, 36, 0, 36]
    want = jax_detect_batch_sharded(jdet, euroc4, jax_make_mesh({"data": 4}))
    for g, w in zip(got, want):
        _same_tags(g, w)


def test_turbo_detect_batch_sharded_matches_detect_batch_and_jax(data_dir):
    """The turbo mode on the 540x960 crop x4 (JAX test_decimate.py::
    test_turbo_detect_batch_sharded)."""
    img = np.ascontiguousarray(load_image(str(data_dir / "two_boards.png"))[:540, :960])
    imgs = np.stack([img] * 4)
    tdet = TagDetector("t36h11", device="cpu", decimate=True)
    got = detect_batch_sharded(tdet, imgs, make_mesh({"data": 4}, [CPU] * 4))
    ref = tdet.detect_batch(imgs)
    assert got == ref and all(len(t) > 10 for t in got)
    want = jax_detect_batch_sharded(JaxDetector("t36h11", mode="hybrid", decimate=True),
                                    imgs, jax_make_mesh({"data": 4}))
    for g, w in zip(got, want):
        _same_tags(g, w)


def test_detect_batch_sharded_puts_each_shard_on_its_device(det, euroc4, euroc4_ref,
                                                            monkeypatch):
    """One chunk a shard: the put hook hands each shard's frames, and only
    those, to its device of the axis (the second of a 2-D mesh's axes)."""
    devs = [torch.device("cpu", i) for i in range(4)]
    placed = []

    def to(t, dev):
        placed.append((int(t.shape[0]), dev))
        return t

    monkeypatch.setattr(tsharding, "_to", to)
    mesh = make_mesh({"camera": 2, "data": 2}, devs)
    assert detect_batch_sharded(det, euroc4, mesh) == euroc4_ref
    assert placed == [(2, devs[0]), (2, devs[1])]


def test_detect_batch_sharded_rejects_a_batch_that_does_not_split(det, euroc4):
    with pytest.raises(ValueError, match="does not split over 2"):
        detect_batch_sharded(det, euroc4[:3], make_mesh({"data": 2}, [CPU] * 2))


def test_pipeline_parallel_matches_detect_batch_and_jax(det, jdet, data_dir):
    """Micro-batches of 2 and 3 EuRoC frames (tests/test_sharding.py::
    test_pipeline_parallel_matches_hybrid) on [cpu, cpu]."""
    import jax

    img = load_image(str(data_dir / "EuRoC.png"))
    batches = [np.stack([img] * 2), np.stack([img, np.zeros_like(img), img])]
    got = list(PipelineParallelDetector(det, devices=[CPU, CPU]).detect_batches(batches))
    assert got == [det.detect_batch(b) for b in batches]
    assert [[len(t) for t in r] for r in got] == [[36, 36], [36, 0, 36]]
    want = list(JaxPipelineParallel(jdet, devices=jax.devices()[:2]).detect_batches(batches))
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            _same_tags(g, w)


def test_pipeline_parallel_requires_the_hybrid_mode_and_devices(monkeypatch):
    """``mode="xla"`` cannot be built yet, so the check is shown on a
    detector whose mode says so; without a card there is no default."""
    other = TagDetector("t36h11", device="cpu")
    other.mode = "xla"
    with pytest.raises(ValueError, match="hybrid"):
        PipelineParallelDetector(other, devices=[CPU, CPU])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineParallelDetector(TagDetector("t36h11", device="cpu"))
