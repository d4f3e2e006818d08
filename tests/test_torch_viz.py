"""The port's overlay and live-stream surfaces (``aprilgrid_tpu_torch.viz``,
``aprilgrid_tpu_torch.live``) held against the JAX package's on the same
inputs: the same overlay pixels, the same PNG and HTML, the same JPEG
bytes and state from the same ``publish``; and the JAX test's endpoint
checks of ``LiveStream``."""

import io
import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from aprilgrid_tpu import live as jlive
from aprilgrid_tpu import viz as jviz
from aprilgrid_tpu_torch import TagDetector, get_family
from aprilgrid_tpu_torch import live as tlive
from aprilgrid_tpu_torch import viz as tviz
from aprilgrid_tpu_torch.ops.decode import decode_positions_px


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain versions' many small operations do
    not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def euroc(data_dir):
    """EuRoC with the port's CPU results: tags, saddles, decode points."""
    img = np.asarray(Image.open(data_dir / "EuRoC.png"))
    det = TagDetector("t36h11", device="cpu")
    tags = det.detect(img)
    saddles = det.refined_saddle_points(img)
    spec = get_family("t36h11")
    h, w = img.shape
    points = {}
    for tid, corners in tags.items():
        pts = decode_positions_px(corners, spec, 0.5, w, h)
        if pts is not None:
            points[tid] = [tuple(q) for q in pts]
    assert len(tags) == 36 and len(points) == 36 and len(saddles) > 100
    return img, tags, saddles, points


def _frame(img, kind):
    if kind == "u16":
        return img.astype(np.uint16) * 257
    if kind == "rgb":
        return np.repeat(img[..., None], 3, axis=2)
    return img


def test_tag_color_matches_jax():
    for tid in (0, 1, 7, 35, 586, 2**31 - 1):
        assert tviz._tag_color(tid) == jviz._tag_color(tid)


@pytest.mark.parametrize("kind", ["u8", "u16", "rgb"])
def test_render_overlay_matches_jax(euroc, kind):
    img, tags, saddles, points = euroc
    frame = _frame(img, kind)
    layers = dict(tags=tags, saddles=saddles, decode_points=points)
    got = tviz.render_overlay(frame, **layers)
    want = jviz.render_overlay(frame, **layers)
    assert got.shape == img.shape + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # a torch tensor is brought to the host: the same pixels
    np.testing.assert_array_equal(tviz.render_overlay(torch.from_numpy(frame), **layers),
                                  got)
    # every layer drew something
    assert (got != tviz.render_overlay(frame)).any(axis=-1).sum() > 1000


def test_dump_overlay_matches_jax(euroc, tmp_path):
    img, tags, saddles, points = euroc
    layers = dict(tags=tags, saddles=saddles, decode_points=points)
    got = tviz.dump_overlay(tmp_path / "t" / "o.png", img, **layers)
    want = jviz.dump_overlay(tmp_path / "j" / "o.png", img, **layers)
    assert got.read_bytes() == want.read_bytes()
    with Image.open(got) as im:
        np.testing.assert_array_equal(np.asarray(im), tviz.render_overlay(img, **layers))


def test_write_timeline_html_matches_jax(euroc, tmp_path):
    img, tags, saddles, points = euroc
    entries = [{
        "image": "EuRoC_raw.png", "timeline_ns": 16666666, "detect_ms": 12.5,
        "tags": {int(t): [[float(x), float(y)] for x, y in c] for t, c in tags.items()},
        "decode_points": {int(t): [[float(x), float(y)] for x, y in p]
                          for t, p in points.items()},
        "saddles": [[s.p[0], s.p[1], s.theta] for s in saddles],
    }]
    got = tviz.write_timeline_html(tmp_path / "t", entries).read_text()
    assert got == jviz.write_timeline_html(tmp_path / "j", entries).read_text()
    data = json.loads(re.search(r"const F=(\[.*?\]);let", got, re.S).group(1))
    assert len(data[0]["tags"]) == 36 and len(data[0]["saddles"]) == len(saddles)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers, r.read()


def test_live_stream_endpoints():
    """tests/test_live.py's checks, on the port's LiveStream."""
    stream = tlive.LiveStream(port=0).start()
    try:
        port = stream.port
        status, _, body = _get(port, "/")
        assert status == 200 and b"stream.mjpg" in body

        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/latest.jpg")
        assert e.value.code == 404   # no frame yet

        img = np.full((64, 96, 3), 128, np.uint8)
        tags = {3: [(10.0, 10.0), (30.0, 10.0), (30.0, 30.0), (10.0, 30.0)]}
        stream.publish(img, tags=tags)

        status, _, body = _get(port, "/latest.jpg")
        assert status == 200 and body[:2] == b"\xff\xd8"  # JPEG magic

        _, _, body = _get(port, "/state.json")
        state = json.loads(body)
        assert state["frame"] == 1 and state["tags"] == [3] and state["n_tags"] == 1

        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nope")
        assert e.value.code == 404

        # one multipart chunk from the stream
        req = urllib.request.urlopen(f"http://127.0.0.1:{port}/stream.mjpg", timeout=10)
        try:
            assert "multipart/x-mixed-replace" in req.headers["Content-Type"]
            assert req.read(8) == b"--frame\r"
        finally:
            req.close()
    finally:
        stream.stop()


def test_live_publish_matches_jax(euroc):
    """The same ``publish`` on both streams serves equal JPEG bytes and
    equal state; the JPEG decodes to the frame's size."""
    img, tags, saddles, points = euroc
    streams = [tlive.LiveStream(port=0).start(), jlive.LiveStream(port=0).start()]
    try:
        for s in streams:
            s.publish(img, tags=tags, saddles=saddles, decode_points=points)
            s.publish(img, tags=tags, saddles=saddles, decode_points=points)
        (_, _, tj), (_, _, jj) = (_get(s.port, "/latest.jpg") for s in streams)
        assert tj == jj
        with Image.open(io.BytesIO(tj)) as im:
            assert im.size == (img.shape[1], img.shape[0])
        ts, js = (json.loads(_get(s.port, "/state.json")[2]) for s in streams)
        assert ts == js
        assert ts == {"frame": 2, "tags": sorted(tags), "n_tags": 36,
                      "n_saddles": len(saddles)}
    finally:
        for s in streams:
            s.stop()
