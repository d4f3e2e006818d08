"""The port's hybrid runtime (front-ends two chunks ahead, the search on a
background worker, the wavefront walk, the fused tail) held against the JAX
facade's schedule and against itself, on the CPU; the profiling utilities,
the native search wrapper against the JAX package's, and the port bench."""

import json
import os
import random
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import aprilgrid_tpu.native as jnative
from aprilgrid_tpu.detector import TagDetector as JaxDetector
from aprilgrid_tpu.oracle.numpy_ref import load_image
from aprilgrid_tpu_torch import TagDetector, native
from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
from aprilgrid_tpu_torch.pipeline import frontend_packed
from aprilgrid_tpu_torch.utils import profiling
from conftest import make_stress_scene

ROOT = Path(__file__).resolve().parent.parent
CAP = (2 * DEFAULT_CAPACITIES.grid_radius + 1) ** 2


@pytest.fixture(scope="module")
def det():
    return TagDetector("t36h11", device="cpu")


@pytest.fixture(scope="module")
def euroc(data_dir):
    return load_image(str(data_dir / "EuRoC.png"))


def _labels(tl):
    return [e[0] for e in tl]


# the JAX facade's label kinds; the port adds fe_stage and fe_launch (inside
# fe_dispatch) and assemble
JAX_KINDS = ("fe_dispatch", "pack_read", "search_submit", "search_wait", "dec_dispatch",
             "dec_read")
CHILDREN = ("fe_stage", "fe_launch")


def _spans_nest_or_part(tl, t0, t1):
    """Every span lies inside the call ``[t0, t1]``; two spans overlap only
    where a ``fe_stage`` or ``fe_launch`` lies inside its own chunk's
    ``fe_dispatch``."""
    spans = sorted(tl, key=lambda e: e[1])
    for label, a, b in spans:
        assert t0 <= a <= b <= t1, label
    for i, (la, a0, a1) in enumerate(spans):
        for lb, b0, b1 in spans[i + 1:]:
            if b0 >= a1:
                break
            kind, ci = lb.split(" ")[:2]
            assert kind in CHILDREN and la == f"fe_dispatch {ci}" and b1 <= a1, (la, lb)


def test_timeline_labels_match_jax(det, euroc, monkeypatch):
    """The wavefront walk, the lazy front-end dispatch and the tail visit
    the host's blocking sites in the JAX facade's order."""
    monkeypatch.setenv("AG_TIMELINE", "1")
    monkeypatch.setenv("AG_SEARCH_ASYNC", "0")
    blank = np.zeros_like(euroc)
    frames = np.stack([euroc, blank, euroc[:, ::-1].copy(), euroc, blank])
    got = det.detect_batch(frames, chunk=2)
    jdet = JaxDetector("t36h11")
    want = jdet.detect_batch(frames, chunk=2)
    assert [set(r) for r in got] == [set(r) for r in want]
    ported = [lb for lb in _labels(det.last_timeline) if lb.split(" ")[0] in JAX_KINDS]
    assert ported == _labels(jdet.last_timeline)
    assert ported[:2] == ["fe_dispatch c0", "fe_dispatch c1"]
    for label, t0, t1 in det.last_timeline:
        assert t0 <= t1, label


@pytest.mark.parametrize("search_async", ["0", "1"])
def test_every_label_once_per_chunk_and_pass(det, monkeypatch, search_async):
    """Three frames of a two-board scene at chunk 1: every chunk decodes in
    both passes, so each blocking site appears once per chunk (front-end
    with its staging and launch, saddle read, first-pass read) or once per
    chunk and pass (search, decode, assembly, the fused tail's slices
    included), and the final pass is read once, fused."""
    monkeypatch.setenv("AG_TIMELINE", "1")
    monkeypatch.setenv("AG_SEARCH_ASYNC", search_async)
    scene = make_stress_scene(2, kind="two_boards")
    det.detect_batch(np.stack([scene] * 3), chunk=1)
    seen = Counter(_labels(det.last_timeline))
    want = Counter({"dec_read tail-fused": 1})
    for c in range(3):
        want.update({f"fe_dispatch c{c}": 1, f"pack_read c{c}": 1,
                     f"search_submit c{c} p0": 1, f"search_submit c{c} p1": 1,
                     f"search_wait c{c}": 2, f"dec_dispatch c{c}": 2,
                     f"dec_read c{c}": 1, f"fe_stage c{c}": 1, f"fe_launch c{c}": 1,
                     f"assemble c{c}": 2})
    assert seen == want


@pytest.mark.parametrize("put", [None, lambda frames, lo: frames.clone()],
                         ids=["to_device", "put"])
def test_stage_and_launch_lie_apart_inside_their_fe_dispatch(det, euroc, monkeypatch, put):
    """Each chunk's staging and front-end launch, on the ``.to`` path and
    through a ``put``, lie one after the other inside that chunk's
    ``fe_dispatch``."""
    monkeypatch.setenv("AG_TIMELINE", "1")
    monkeypatch.setenv("AG_SEARCH_ASYNC", "0")
    frames = torch.from_numpy(np.stack([euroc, np.zeros_like(euroc), euroc]))
    det._detect_hybrid(frames, chunk=1, put=put)
    spans = {label: (a, b) for label, a, b in det.last_timeline}
    for c in range(3):
        fa, fb = spans[f"fe_dispatch c{c}"]
        sa, sb = spans[f"fe_stage c{c}"]
        la, lb = spans[f"fe_launch c{c}"]
        assert fa <= sa <= sb <= la <= lb <= fb


def test_spans_overlap_only_as_children_under_the_background_search(det, monkeypatch):
    """With the search on its worker, finishing at random times while the
    main thread switches every microsecond, every span still lies inside
    the call, and none overlaps another but a child inside its own
    ``fe_dispatch``: nothing is recorded from the worker."""
    scene = make_stress_scene(2, kind="two_boards")
    frames = np.stack([scene, np.zeros_like(scene), scene])
    search, rng = native.find_board_batch, random.Random(1)

    def slow(*a, **kw):
        time.sleep(rng.uniform(0.0, 0.01))
        return search(*a, **kw)

    monkeypatch.setattr(native, "find_board_batch", slow)
    monkeypatch.setenv("AG_SEARCH_ASYNC", "1")
    monkeypatch.setenv("AG_TIMELINE", "1")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            det.detect_batch(frames, chunk=1)
            t1 = time.perf_counter()
            _spans_nest_or_part(det.last_timeline, t0, t1)
            assert {lb.split(" ")[0] for lb in _labels(det.last_timeline)} == {
                *JAX_KINDS, *CHILDREN, "assemble"}
    finally:
        sys.setswitchinterval(interval)


def test_results_equal_with_and_without_the_timeline(det, monkeypatch):
    scene = make_stress_scene(2, kind="two_boards")
    frames = np.stack([scene, np.zeros_like(scene), scene])
    monkeypatch.setenv("AG_TIMELINE", "1")
    traced = det.detect_batch(frames, chunk=1)
    assert det.last_timeline
    monkeypatch.delenv("AG_TIMELINE")
    assert det.detect_batch(frames, chunk=1) == traced
    assert det.last_timeline is None


def test_no_assemble_span_where_the_search_finds_nothing(det, euroc, monkeypatch):
    """A chunk whose search finds no board decodes nothing, so nothing is
    assembled: its ``assemble`` span is missing, the others' are there."""
    monkeypatch.setenv("AG_TIMELINE", "1")
    monkeypatch.setenv("AG_SEARCH_ASYNC", "0")
    frames = np.stack([euroc, np.zeros_like(euroc), euroc])
    res = det.detect_batch(frames, chunk=1)
    assert res[1] == {} and len(res[0]) == len(res[2]) == 36
    seen = Counter(_labels(det.last_timeline))
    assert seen["assemble c0"] >= 1 and seen["assemble c2"] >= 1
    assert "assemble c1" not in seen and "dec_dispatch c1" not in seen


def test_no_timeline_without_the_variable(det, euroc, monkeypatch):
    monkeypatch.delenv("AG_TIMELINE", raising=False)
    assert TagDetector("t36h11", device="cpu").last_timeline is None
    det.detect_batch(euroc[None])
    assert det.last_timeline is None


def test_background_search_keeps_the_order_under_stress(det, monkeypatch):
    """The worker's searches finish at random times while the main thread
    switches every microsecond: each chunk's passes still see the saddles
    the previous pass released, so the results equal the inline walk's."""
    scene = make_stress_scene(2, kind="two_boards")
    frames = np.stack([scene, np.zeros_like(scene), scene])
    monkeypatch.setenv("AG_SEARCH_ASYNC", "0")
    want = det.detect_batch(frames, chunk=1)
    search, rng = native.find_board_batch, random.Random(0)

    def slow(*a, **kw):
        time.sleep(rng.uniform(0.0, 0.01))
        return search(*a, **kw)

    monkeypatch.setattr(native, "find_board_batch", slow)
    monkeypatch.setenv("AG_SEARCH_ASYNC", "1")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(2):
            assert det.detect_batch(frames, chunk=1) == want
    finally:
        sys.setswitchinterval(interval)


def test_stage_timer_and_stage_report(det, euroc):
    t = profiling.StageTimer()
    t.start()
    x = torch.ones(4)
    assert t.stop("cpu stage", x) is x
    assert "cpu stage" in t.stages
    report = profiling.detect_stage_report(det, np.stack([euroc, euroc]), reps=1)
    for stage in ("frontend (device)", "saddle download", "board search pass 1 (host)",
                  "decode pass 1 (upload+device)", "result download pass 2",
                  "collect pass 2 (host)", "total"):
        assert stage in report


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as log_dir:
        torch.ones(8).sum()
    trace = json.loads((Path(log_dir) / "trace.json").read_text())
    assert trace["traceEvents"]


def test_bench_on_the_cpu_prints_its_keys():
    env = dict(os.environ, BENCH_BATCH="2", BENCH_REPS="1")
    out = subprocess.run(
        [sys.executable, "-m", "aprilgrid_tpu_torch.bench", "--device", "cpu",
         "--images", "EuRoC", "--timeline"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    cell, geo = (json.loads(line) for line in out.stdout.strip().splitlines())
    assert {"frames_per_s", "host_cores", "card", "corner_max_px", "ids_equal", "tags",
            "golden", "timeline", "batch", "reps"} <= set(cell)
    assert set(cell["frames_per_s"]) == {"median", "min", "max"}
    assert cell["tags"] == cell["golden"] == 36 and cell["ids_equal"]
    assert cell["corner_max_px"] == 0.0 and cell["batch"] == 2
    assert {"fe_dispatch", "pack_read", "search_submit", "search_wait", "dec_dispatch",
            "dec_read"} <= set(cell["timeline"]["label_ms"])
    assert {"first_pack_read_ms", "after_last_fe_dispatch_ms"} <= set(cell["timeline"])
    assert geo["parity_ok"] and set(geo["geomean_frames_per_s"]) == {"exact"}


# -- the native search wrapper, against the JAX package's ------------------

@pytest.fixture(scope="module")
def euroc_saddles(euroc):
    """EuRoC's packed saddles from the port's front-end: px, py, theta,
    alive of one frame."""
    packed, _ = frontend_packed(torch.from_numpy(euroc)[None], DEFAULT_PARAMS,
                                CONSTANTS, DEFAULT_CAPACITIES)
    pk = packed.numpy()[0, :-1]
    return (np.ascontiguousarray(pk[:, 0]), np.ascontiguousarray(pk[:, 1]),
            np.ascontiguousarray(pk[:, 2]), (pk[:, 3] > 0.5).astype(np.uint8))


def _search_kw():
    return dict(spacing_ratio=DEFAULT_PARAMS.tag_spacing_ratio,
                max_seeds=CONSTANTS.max_seeds,
                early_exit_score=CONSTANTS.early_exit_score, cap=CAP)


def test_find_board_and_quads_match_jax(euroc_saddles):
    px, py, theta, alive = euroc_saddles
    quads = native.find_board(px, py, theta, alive, **_search_kw())
    np.testing.assert_array_equal(quads, jnative.find_board(px, py, theta, alive,
                                                            **_search_kw()))
    assert len(quads) == 36
    xyt = np.stack([px, py, theta], -1)
    for q in quads[:8]:
        assert native.is_valid_quad(xyt[q]) and jnative.is_valid_quad(xyt[q])
    bad = xyt[quads[0]][[0, 2, 1, 3]]  # corners out of order
    assert native.is_valid_quad(bad) == jnative.is_valid_quad(bad)


def test_find_board_batch_matches_jax_on_any_thread_count(euroc_saddles):
    px, py, theta, alive = (np.stack([a, a, a]) for a in euroc_saddles)
    alive[1] = 0  # a frame with nothing alive
    one = native.find_board_batch(px, py, theta, alive, num_threads=1, **_search_kw())
    want = jnative.find_board_batch(px, py, theta, alive, num_threads=1, **_search_kw())
    every = native.find_board_batch(px, py, theta, alive, num_threads=0, **_search_kw())
    for a, b, c in zip(one, want, every):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert one[1].tolist() == [36, 0, 36]


def test_build_name_carries_flags_and_host_isa(monkeypatch):
    monkeypatch.delenv("AG_NATIVE_MARCH", raising=False)
    tuned = native.library_path()
    monkeypatch.setenv("AG_NATIVE_MARCH", "portable")
    portable = native.library_path()
    assert portable != tuned
    monkeypatch.setattr(native, "_host_isa_signature", lambda: "another-host")
    assert native.library_path() == portable  # a portable build names no ISA
    monkeypatch.delenv("AG_NATIVE_MARCH")
    assert native.library_path() not in (tuned, portable)  # another host's ISA
