"""The port's chart generator (``aprilgrid_tpu_torch.boards``) held against
the JAX package's on the same boards: byte-equal SVG, PDF and JSON,
pixel-equal PNG, the same file names; its command line against
``tools/generate_aprilgrid.py``; and the port's CPU detector on the port's
charts, which covers the families the bundled photos lack (t16h5, t25h7,
t25h9 and the one-bit border of t36h11b1) end to end."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from aprilgrid_tpu.boards import generator as jgen
from aprilgrid_tpu_torch import TagDetector
from aprilgrid_tpu_torch.boards import generator as tgen

ROOT = Path(__file__).resolve().parent.parent

# family, border, grid x, grid y, first marker: tests/test_boards.py's five
# FAMILIES and its offset board
BOARDS = [
    ("t16h5", 2, 4, 4, 0),
    ("t25h7", 2, 5, 5, 0),
    ("t25h9", 2, 5, 5, 0),
    ("t36h11", 2, 6, 6, 0),
    ("t36h11b1", 1, 6, 6, 0),
    ("t36h11", 2, 2, 2, 10),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain versions' many small operations do
    not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boards(family, border, sx, sy, first):
    kw = dict(size_x=sx, size_y=sy, tag_family=family, border_bits=border,
              first_marker=first)
    return tgen.AprilGridBoard(**kw), jgen.AprilGridBoard(**kw)


def _pixels(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


@pytest.mark.parametrize("family,border,sx,sy,first", BOARDS)
def test_generator_matches_jax(family, border, sx, sy, first):
    tb, jb = _boards(family, border, sx, sy, first)
    assert tb.file_name() == jb.file_name()
    assert tb.to_config() == jb.to_config()
    assert json.dumps(tb.to_config(), indent=2) == json.dumps(jb.to_config(), indent=2)
    assert tgen._board_rects(tb) == jgen._board_rects(jb)
    assert tgen.svg_string(tb) == jgen.svg_string(jb)
    assert tgen.pdf_bytes(tb) == jgen.pdf_bytes(jb)
    got, want = tgen.render_png(tb, 2.0), jgen.render_png(jb, 2.0)
    assert got.shape == want.shape == (1600, 1600) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _same_files(a: Path, b: Path) -> list[str]:
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        if n.endswith(".png"):
            np.testing.assert_array_equal(_pixels(a / n), _pixels(b / n))
        else:
            assert (a / n).read_bytes() == (b / n).read_bytes(), n
    return names


def test_generate_chart_matches_jax(tmp_path):
    tb, jb = _boards("t25h9", 2, 3, 2, 4)
    tw = tgen.generate_chart(tb, tmp_path / "t", pixels_per_mm=1.0)
    jw = jgen.generate_chart(jb, tmp_path / "j", pixels_per_mm=1.0)
    assert {k: p.name for k, p in tw.items()} == {k: p.name for k, p in jw.items()}
    assert set(tw) == {"svg", "png", "pdf", "json"}
    assert _same_files(tmp_path / "t", tmp_path / "j") == [
        f"t25h9_3x2_start_id_4.{ext}" for ext in ("json", "pdf", "png", "svg")]


@pytest.mark.parametrize("family", ["t16h5", "t36h11b1"])
def test_cli_matches_jax_tool(tmp_path, family):
    """``python -m aprilgrid_tpu_torch.boards`` writes the files
    ``tools/generate_aprilgrid.py`` writes with the same flags (t36h11b1:
    the border forced to one bit)."""
    flags = ["-t", family, "-x", "2", "-y", "2", "--pixels-per-mm", "0.5"]
    runs = {
        "t": [sys.executable, "-m", "aprilgrid_tpu_torch.boards"],
        "j": [sys.executable, "tools/generate_aprilgrid.py"],
    }
    for key, cmd in runs.items():
        res = subprocess.run(cmd + flags + ["--out-dir", str(tmp_path / key)], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
    names = _same_files(tmp_path / "t", tmp_path / "j")
    assert f"{family}_2x2_start_id_0.png" in names
    if family == "t36h11b1":
        cfg = json.loads((tmp_path / "t" / f"{family}_2x2_start_id_0.json").read_text())
        assert cfg["tag_cols"] == 2 and cfg["first_id"] == 0
        one_bit = tgen.svg_string(tgen.AprilGridBoard(size_x=2, size_y=2,
                                                      tag_family=family, border_bits=1))
        assert (tmp_path / "t" / f"{family}_2x2_start_id_0.svg").read_text() == one_bit


@pytest.mark.parametrize("family,border,sx,sy,first", BOARDS)
def test_roundtrip_port_detector(family, border, sx, sy, first):
    """The port's CPU detector finds every ID on the port's chart."""
    tb, _ = _boards(family, border, sx, sy, first)
    img = tgen.render_png(tb, pixels_per_mm=2.0)
    tags = TagDetector(family, device="cpu").detect(img)
    assert sorted(tags) == list(range(first, first + sx * sy))
