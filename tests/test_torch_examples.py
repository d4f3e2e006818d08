"""The port's runnable examples (``aprilgrid_tpu_torch.examples``: demo,
develop, live), its ``utils/images.py::load_image`` and the 4K camera-rig
bench (``python3 -m aprilgrid_tpu_torch.bench --4k``) on the CPU.

Each example runs in-process beside the JAX repo's script of the same
name (``examples/*.py`` through ``runpy``, ``sys.argv`` patched) on a
directory holding EuRoC and EuRoC x 257 as a 16-bit PNG: the same
manifest lines but ``detect_ms`` and ``overlay``; the same tag IDs, with
corners, decode points and saddles within 1e-3 px and orientations within
1e-3 deg; byte-equal raw copies; overlays pixel-equal outside the boxes
of the elements that differ (``chip_smoke.py::_overlay_mask``); the same
printed counts. ``load_image`` equals the JAX oracle's on every mode
branch. The 4K bench gives 72 tags in both modes with exact parity
against the port's CPU run of one frame."""

import contextlib
import io
import json
import re
import runpy
import sys
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from aprilgrid_tpu.oracle.numpy_ref import load_image as jax_load_image
from aprilgrid_tpu_torch import bench
from aprilgrid_tpu_torch.examples import demo, develop, live
from aprilgrid_tpu_torch.utils.images import load_image

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
FRAMES = ("EuRoC", "EuRoC_u16")   # the example directory's frames, in glob order


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain versions' many small operations do
    not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_jax_script(name: str, *args: str) -> str:
    """Run the JAX repo's ``examples/<name>.py`` as ``__main__`` with
    ``args``; return what it printed."""
    out = io.StringIO()
    with mock.patch.object(sys, "argv", [f"{name}.py", *args]), \
            contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_:
        runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    assert exit_.value.code == 0, out.getvalue()
    return out.getvalue()


def _run_port(module, *args: str) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main([*args, "--device", "cpu"]) == 0
    return out.getvalue()


# -- load_image -------------------------------------------------------------

def _written(path: Path, kind: str) -> str:
    """Write a small image of one mode branch from an EuRoC crop; return
    the mode PIL reads it back as."""
    g = np.asarray(Image.open(ROOT / "tests" / "data" / "EuRoC.png"))[100:140, 200:260]
    rgb = np.stack([g, 255 - g, g // 2], axis=-1)
    u16 = g.astype(np.uint16) * 257
    im = {
        "P": lambda: Image.fromarray(rgb).convert("P"),
        "LA": lambda: Image.fromarray(np.stack([g, 255 - g], axis=-1), "LA"),
        "RGBA": lambda: Image.fromarray(np.concatenate([rgb, g[..., None]], axis=-1),
                                        "RGBA"),
        "I;16": lambda: Image.fromarray(u16),
        "1": lambda: Image.fromarray(g).convert("1"),
        "I": lambda: Image.fromarray(g.astype(np.int32) * 100),
        "I;16B": lambda: Image.fromarray(u16.byteswap().view(">u2")),
        "CMYK": lambda: Image.fromarray(rgb).convert("CMYK"),
    }[kind]()
    im.save(path)
    with Image.open(path) as back:
        return back.mode


@pytest.mark.parametrize("name", ["EuRoC", "TUM_VI", "two_boards"])
def test_load_image_matches_oracle_on_golden(data_dir, name):
    got, want = load_image(data_dir / f"{name}.png"), jax_load_image(data_dir / f"{name}.png")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,suffix", [("P", ".png"), ("LA", ".png"), ("RGBA", ".png"),
                                         ("I;16", ".png"), ("1", ".png"), ("I", ".tif"),
                                         ("I;16B", ".tif"), ("CMYK", ".jpg")])
def test_load_image_matches_oracle_on_every_mode(tmp_path, kind, suffix):
    path = tmp_path / f"frame{suffix}"
    assert _written(path, kind) == kind
    got, want = load_image(path), jax_load_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.dtype == (np.uint16 if kind.startswith("I") else np.uint8)


# -- the examples against the JAX scripts -----------------------------------

@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory, data_dir):
    d = tmp_path_factory.mktemp("frames")
    img = np.asarray(Image.open(data_dir / "EuRoC.png"))
    Image.fromarray(img).save(d / "EuRoC.png")
    Image.fromarray(img.astype(np.uint16) * 257).save(d / "EuRoC_u16.png")
    assert [p.stem for p in sorted(d.glob("*.png"))] == list(FRAMES)
    return d


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory, frames_dir):
    """The JAX demo's and the port's output directories, same frames."""
    jax_out, port_out = (tmp_path_factory.mktemp(n) for n in ("jax_demo", "port_demo"))
    _run_jax_script("demo", "--dir", str(frames_dir), "--out", str(jax_out))
    _run_port(demo, "--dir", str(frames_dir), "--out", str(port_out))
    return jax_out, port_out


def _timeline(out: Path) -> list:
    html = (out / "timeline.html").read_text()
    return json.loads(re.search(r"const F=(\[.*?\]);let", html, re.S).group(1))


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_demo_manifest_matches_jax(demo_runs):
    jax_out, port_out = demo_runs
    lines = [[json.loads(s) for s in (out / "manifest.jsonl").read_text().splitlines()]
             for out in demo_runs]
    for got, want in zip(*reversed(lines), strict=True):
        assert Path(got.pop("overlay")).parent == port_out
        assert Path(want.pop("overlay")).parent == jax_out
        assert got.pop("detect_ms") >= 0 and want.pop("detect_ms") >= 0
        assert got == want
    assert [(e["frame"], e["n_tags"]) for e in lines[1]] == [
        ("EuRoC.png", 36), ("EuRoC_u16.png", 36)]


def test_demo_timeline_matches_jax(demo_runs):
    want, got = (_timeline(out) for out in demo_runs)
    assert len(got) == len(want) == len(FRAMES)
    for g, w in zip(got, want):
        assert (g["image"], g["timeline_ns"]) == (w["image"], w["timeline_ns"])
        assert set(g["tags"]) == set(w["tags"]) and len(g["tags"]) == 36
        assert set(g["decode_points"]) == set(w["decode_points"])
        for t in g["tags"]:
            assert _gap(g["tags"][t], w["tags"][t]) <= 1e-3
            assert _gap(g["decode_points"][t], w["decode_points"][t]) <= 1e-3


def test_demo_saddles_match_jax(demo_runs):
    want, got = (_timeline(out) for out in demo_runs)
    for g, w in zip(got, want):
        gs, ws = np.asarray(g["saddles"]), np.asarray(w["saddles"])
        assert gs.shape == ws.shape and len(gs) > 100
        assert _gap(gs[:, :2], ws[:, :2]) <= 1e-3
        assert _gap(gs[:, 2], ws[:, 2]) <= 1e-3


def test_demo_raw_copies_are_byte_equal(demo_runs):
    jax_out, port_out = demo_runs
    for name in FRAMES:
        raw = f"{name}_raw.png"
        assert (port_out / raw).read_bytes() == (jax_out / raw).read_bytes()
    # the u16 frame's copy is its //257, which is EuRoC again
    with Image.open(port_out / "EuRoC_u16_raw.png") as a, \
            Image.open(port_out / "EuRoC_raw.png") as b:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _saddles(entry) -> list:
    return [SimpleNamespace(p=(x, y), theta=t) for x, y, t in entry["saddles"]]


def _held_overlay(got_png: Path, want_png: Path, got: dict, want: dict) -> int:
    """The two overlays are pixel-equal outside the boxes of the elements
    whose values differ between the runs ``got`` and ``want`` (timeline
    entries); returns the pixels compared. Corners that differ by an ulp
    mask their tag's box, so the share compared is only bounded below."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _overlay_mask

    with Image.open(got_png) as a, Image.open(want_png) as b:
        g, w = np.asarray(a), np.asarray(b)
    assert g.shape == w.shape
    keep = ~_overlay_mask(g.shape, got["tags"], want["tags"], _saddles(got), _saddles(want))
    assert (g[keep] == w[keep]).all()
    return int(keep.sum())


def test_demo_overlays_match_jax(demo_runs):
    jax_out, port_out = demo_runs
    want, got = (_timeline(out) for out in demo_runs)
    for name, g, w in zip(FRAMES, got, want):
        png = f"{name}_overlay.png"
        assert _held_overlay(port_out / png, jax_out / png, g, w) > 0.5 * 752 * 480


def _counts(text: str, pattern: str) -> list:
    return [tuple(int(v) for v in m) for m in re.findall(pattern, text)]


def test_develop_matches_jax(tmp_path, data_dir, demo_runs):
    img = str(data_dir / "EuRoC.png")
    want = _run_jax_script("develop", img, "--out", str(tmp_path / "jax.png"))
    got = _run_port(develop, img, "--out", str(tmp_path / "port.png"))
    pattern = r"refined saddles: (\d+)\nboard quads: (\d+)\ndecoded tags: (\d+)\n"
    assert _counts(got, pattern) == _counts(want, pattern) != []
    assert _counts(got, pattern)[0][1:] == (36, 36)
    assert f"overlay -> {tmp_path / 'port.png'}" in got
    # the same layers as the demo's EuRoC frame: tags and saddles
    g, w = (_timeline(out)[0] for out in reversed(demo_runs))
    assert _held_overlay(tmp_path / "port.png", tmp_path / "jax.png", g, w) > 0.5 * 752 * 480


def test_live_matches_jax(frames_dir):
    args = ("--dir", str(frames_dir), "--loops", "1", "--fps", "1000", "--port", "0")
    want, got = _run_jax_script("live", *args), _run_port(live, *args)
    pattern = r"(?m)^EuRoC\S*\.png: (\d+) tags, (\d+) saddles, \d+ ms$"
    assert _counts(got, pattern) == _counts(want, pattern)
    assert [n for n, _ in _counts(got, pattern)] == [36, 36]
    port = int(re.search(r"live viewer: http://127\.0\.0\.1:(\d+)/", got).group(1))
    assert port > 0   # --port 0 serves on a free port, and the URL names it


@pytest.mark.parametrize("module", [demo, develop, live])
def test_examples_raise_without_a_card(monkeypatch, tmp_path, module):
    """No fallback: ``--device cuda`` (the default) without a card raises
    through ``TagDetector``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {develop: [str(tmp_path / "none.png")]}.get(module, ["--dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)


# -- the 4K camera-rig bench -------------------------------------------------

CELL_KEYS = {
    "cell", "image", "shape", "mode", "batch", "chunk", "frames_on", "reps",
    "frames_per_s", "call_ms", "tags", "golden", "ids_equal", "corner_max_px",
    "host_cores", "search_threads", "search_async", "fill_ramp", "device", "card",
    "nms_merge", "saddles_per_frame", "search_syncs", "cams", "steps",
}


@pytest.fixture(scope="module")
def bench_4k_lines():
    env = {"BENCH_CAMS": "1", "BENCH_STEPS": "2", "BENCH_REPS": "1"}
    out = io.StringIO()
    with mock.patch.dict("os.environ", env), contextlib.redirect_stdout(out):
        rc = bench.main(["--4k", "--device", "cpu"])
    return rc, [json.loads(s) for s in out.getvalue().splitlines()]


def test_bench_4k_records(bench_4k_lines):
    rc, lines = bench_4k_lines
    assert rc == 0 and len(lines) == 3
    for rec, mode in zip(lines, ("exact", "turbo")):
        assert set(rec) == CELL_KEYS
        assert (rec["cell"], rec["mode"], rec["shape"]) == (f"4k {mode}", mode,
                                                            [2160, 3840, 3])
        assert (rec["cams"], rec["steps"], rec["batch"], rec["chunk"]) == (1, 2, 2, 16)
        assert set(rec["frames_per_s"]) == {"median", "min", "max"}
        assert rec["frames_per_s"]["min"] <= rec["frames_per_s"]["median"] <= \
            rec["frames_per_s"]["max"]
        assert (rec["device"], rec["card"], rec["frames_on"]) == ("cpu", None, "device")
    assert set(lines[2]["geomean_frames_per_s"]) == {"exact", "turbo"}
    assert lines[2]["parity_ok"] is True and lines[2]["cells"] == 2


@pytest.mark.parametrize("mode", ["exact", "turbo"])
def test_bench_4k_finds_every_tag_at_parity(bench_4k_lines, mode):
    rec = {r["mode"]: r for r in bench_4k_lines[1][:2]}[mode]
    assert rec["tags"] == rec["golden"] == 72
    assert rec["ids_equal"] is True and rec["corner_max_px"] == 0.0
    assert rec["saddles_per_frame"] > 0


def test_bench_4k_frame_is_the_jax_tools():
    """``frame_4k`` is tools/bench_4k.py's canvas: two_boards at the centre
    of a 128-grey 4K RGB frame."""
    frame = bench.frame_4k()
    want = np.full((2160, 3840, 3), 128, np.uint8)
    want[540:1620, 960:2880] = jax_load_image(ROOT / "tests" / "data" / "two_boards.png")
    np.testing.assert_array_equal(frame, want)


def test_bench_4k_exits_3_on_a_parity_miss(monkeypatch, capsys):
    """Exit 3 on a parity miss, as the other cells; ``BENCH_DECIMATE=1``
    runs turbo only."""
    seen = []

    def fake(device, cams, steps, reps, modes, *flags):
        seen.append((cams, steps, modes))
        for mode in modes:
            yield {"mode": mode, "batch": cams * steps, "ids_equal": mode != "turbo",
                   "corner_max_px": 0.0, "frames_per_s": {"median": 1.0}}

    monkeypatch.setattr(bench, "bench_4k", fake)
    monkeypatch.setenv("BENCH_CAMS", "3")
    monkeypatch.delenv("BENCH_STEPS", raising=False)
    monkeypatch.setenv("BENCH_DECIMATE", "1")
    assert bench.main(["--4k", "--device", "cpu"]) == 3
    monkeypatch.setenv("BENCH_DECIMATE", "0")
    assert bench.main(["--4k", "--device", "cpu"]) == 3
    assert seen == [(3, 8, ("turbo",)), (3, 8, ("exact", "turbo"))]
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["parity_ok"] is False and last["batch"] == [24]
