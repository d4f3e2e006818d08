"""What the benchmark's run imports: no JAX and not the JAX package on
the run path, and nothing of the program in the reference. Top-level names
are compared whole: ``aprilgrid_tpu_torch`` is not ``aprilgrid_tpu``."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "aprilgrid_tpu"}


def imported_top_names(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (ROOT / "benchmark/reference").glob("*.py"):
        found = imported_top_names(path) & (FORBIDDEN | {"aprilgrid_tpu_torch", "torch"})
        assert not found, (path.name, found)


def test_benchmark_sources_import_no_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not imported_top_names(path) & FORBIDDEN, path


def test_forbidden_modules_compares_whole_names():
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "import aprilgrid_tpu_torch\n"
        "from benchmark import harness\n"
        "a = harness.forbidden_modules()\n"
        "import aprilgrid_tpu.config\n"
        "print(json.dumps([a, harness.forbidden_modules()]))\n" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    before, after = json.loads(out.stdout.splitlines()[-1])
    assert before == [] and after == ["aprilgrid_tpu"]


def test_run_path_in_each_cell_imports_no_jax(bench_copy):
    """Every cell's run path up to the reference (the detector built, one
    call of the cell's own frames, the pool, the reference on one frame),
    in one process: ``sys.modules`` holds none of the forbidden names."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark import harness, traffic, reference\n"
        "from aprilgrid_tpu_torch import TagDetector, DetectorParams\n"
        "for wl in sorted(p.stem for p in (traffic.BENCH / 'workloads').glob('*.json')):\n"
        "    w = traffic.load_json('workloads', wl); cfg = traffic.load_json('configs', w['config'])\n"
        "    pool, _ = traffic.make_pool(cfg, 5, 'cpu')\n"
        "    det = TagDetector(cfg['family'], params=DetectorParams(max_num_of_boards=cfg['max_num_of_boards']), device='cpu')\n"
        "    det.detect_batch(pool[:1])\n"
        "    reference.detect_pool(pool[:1], cfg['family'], cfg['max_num_of_boards'])\n"
        "    harness.load_readers()\n"
        "print(json.dumps(harness.forbidden_modules()))\n" % str(bench_copy)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=bench_copy, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []
