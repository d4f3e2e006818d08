"""The harness end to end on the CPU, in a copy of a checkout: a cell
added as new files runs with no file that was there edited, and the
comparison that decides ``correct`` fails each fault of the timed path the
cells can have (``drive.py``). The look for a card is skipped; the
detector runs its plain PyTorch versions."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from .conftest import ROOT

FAULTS = ("stale", "half_missing", "half_empty", "id_altered", "corner_altered")


def drive(root: Path, workload: str, seconds: float, trace: int, *faults: str) -> list[dict]:
    proc = subprocess.run(
        [sys.executable, str(root / "benchmark/tests/drive.py"), workload, str(2**33 + 17),
         str(seconds), str(trace), *faults],
        cwd=root, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def test_copy_holds_the_repo_files_unedited(bench_copy):
    for path in (ROOT / "benchmark").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            copy = bench_copy / path.relative_to(ROOT)
            assert copy.read_bytes() == path.read_bytes(), path


# the device metrics need the card; the timeline's and the collector's do not
HOST_METRICS = {"search_ms_per_frame.offline", "fe_dispatch_ms_per_frame.offline",
                "unlabelled_ms_per_frame.offline", "gc_ms_per_frame.offline"}
CELLS = ("euroc-offline-b16", "euroc-offline-b32x3")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_new_cell_runs_from_new_files(bench_copy, workload, trace):
    (out,) = drive(bench_copy, workload, 0.5, trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert out["forbidden"] == []
    if trace:
        assert set(out["metrics"]) == HOST_METRICS
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"frames_per_s", "setup_s"}


# windows long enough for two calls on the CPU: a stale result shows from
# the window's second call on (the first returns the warm-up call's results)
@pytest.mark.parametrize("workload, seconds", zip(CELLS, (2.0, 6.0)))
def test_faults_come_out_not_correct(bench_copy, workload, seconds):
    outs = drive(bench_copy, workload, seconds, 0, "sound", *FAULTS)
    by = {o["fault"]: o for o in outs}
    assert by["sound"]["correct"], by["sound"]["checks"]
    for fault in FAULTS:
        assert not by[fault]["correct"], (fault, by[fault]["checks"])
    checks = {f: {k: c["value"] for k, c in by[f]["checks"].items()} for f in FAULTS}
    assert checks["half_missing"]["frames_unanswered"] > 0
    assert checks["half_empty"]["frames_ids_differ"] > 0
    assert checks["id_altered"]["frames_ids_differ"] > 0
    assert checks["corner_altered"]["corner_max_px"] >= 0.2
    assert checks["stale"]["corner_max_px"] > 1.0
    # two calls or more in every run
    assert all(o["attempted"] >= 2 * int(workload.split("-b")[1].split("x")[0]) for o in outs)
