"""The readers of the spans that split ``fe_dispatch`` and label result
assembly, in a traced CPU run of a cell added as new files."""

from __future__ import annotations

from .test_bench_cells import CELLS, drive


def test_traced_run_splits_fe_dispatch_and_reads_assembly(bench_copy):
    """The staging and launch spans lie inside ``fe_dispatch``, so neither
    reader, nor their sum, reads more than ``fe_dispatch``'s; the cell's
    frames hold boards, so result assembly reads above 0."""
    (out,) = drive(bench_copy, CELLS[0], 0.5, 1)
    ms = {k: m["value"] for k, m in out["metrics"].items()}
    stage, launch = ms["stage_ms_per_frame.offline"], ms["fe_launch_ms_per_frame.offline"]
    fe = ms["fe_dispatch_ms_per_frame.offline"]
    assert 0 < stage <= fe and 0 < launch <= fe and stage + launch <= fe
    assert ms["assemble_ms_per_frame.offline"] > 0
