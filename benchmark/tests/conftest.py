"""Shared fixtures of the benchmark's own tests (CPU unless a test asks
for the card through ``cuda_card``)."""

from __future__ import annotations

import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is present (decided here, when the
    test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench_copy(tmp_path_factory) -> Path:
    """A checkout's copy with the benchmark and the program only, and two
    cells added as new files on the existing ``euroc-stereo``, each with a
    new traffic mix: ``euroc-offline-b16`` (two distinct batches of 16 sent
    back to back) and ``euroc-offline-b32x3`` (three of 32)."""
    root = tmp_path_factory.mktemp("checkout")
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "obj.*", "lock")
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=ignore)
    shutil.copytree(ROOT / "aprilgrid_tpu_torch", root / "aprilgrid_tpu_torch", ignore=ignore)
    shutil.copy2(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "benchmark/traffic/offline-b16.json").write_text(
        '{"loop": "closed", "batch": 16, "distinct_batches": 2}\n')
    (root / "benchmark/workloads/euroc-offline-b16.json").write_text(
        '{"config": "euroc-stereo", "traffic": "offline-b16", "chips": 1}\n')
    (root / "benchmark/traffic/offline-b32x3.json").write_text(
        '{"loop": "closed", "batch": 32, "distinct_batches": 3}\n')
    (root / "benchmark/workloads/euroc-offline-b32x3.json").write_text(
        '{"config": "euroc-stereo", "traffic": "offline-b32x3", "chips": 1}\n')
    return root
