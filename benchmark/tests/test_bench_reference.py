"""The frozen reference (``benchmark/reference``) against the JAX package's
NumPy oracle it was copied from, read as files and never imported: the code
as text (only the imports of the parameters and the family table differ),
the t36h11 table, the default parameters and the family's sizes. Then the
copy on the golden captures, and the control (the reference in bfloat16)
against the comparison's limit."""

from __future__ import annotations

import ast
import dataclasses
import difflib
from collections import Counter

import numpy as np
import pytest

from benchmark import compare, reference, traffic
from benchmark.reference import config as frozen_config
from benchmark.reference import control
from benchmark.reference import numpy_ref as frozen

from .conftest import ROOT

ORIGINAL = ROOT / "aprilgrid_tpu"

# every line in which the copy differs from the original: the note on the
# copy in its docstring, and the imports of the frozen parameters and table
COPY_ONLY = Counter([
    "Frozen copy of ``aprilgrid_tpu/oracle/numpy_ref.py`` for the benchmark:",
    "only the imports of the default parameters and the family table changed,",
    "to the frozen ones in ``config.py`` beside this file",
    "(``benchmark/tests/test_bench_reference.py`` holds the two equal).",
    "",
    "from .config import DEFAULT_PARAMS",
    "from .config import DEFAULT_PARAMS",
    "from .config import DEFAULT_PARAMS, get_family",
])
ORIGINAL_ONLY = Counter([
    "from ..config import DEFAULT_PARAMS",
    "from ..config import DEFAULT_PARAMS",
    "from ..config import DEFAULT_PARAMS",
    "from ..families import get_family",
])


def class_defaults(path, name: str) -> dict:
    """The defaults of the annotated fields of class ``name`` in ``path``."""
    tree = ast.parse(path.read_text())
    (cls,) = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == name]
    return {n.target.id: ast.literal_eval(n.value) for n in cls.body
            if isinstance(n, ast.AnnAssign) and n.value is not None}


def test_copy_is_the_oracle_but_for_its_imports():
    copy = (ROOT / "benchmark/reference/numpy_ref.py").read_text().splitlines()
    orig = (ORIGINAL / "oracle/numpy_ref.py").read_text().splitlines()
    added, removed = Counter(), Counter()
    for line in difflib.ndiff(orig, copy):
        if line.startswith("+ "):
            added[line[2:].strip()] += 1
        elif line.startswith("- "):
            removed[line[2:].strip()] += 1
    assert added == COPY_ONLY
    assert removed == ORIGINAL_ONLY


def test_frozen_table_is_the_packages():
    with np.load(ORIGINAL / "data/tag_families.npz") as z:
        table = z["t36h11"]
    frozen = frozen_config.get_family("t36h11").codes
    assert frozen.dtype == table.dtype and np.array_equal(frozen, table)


def test_frozen_params_and_family_sizes_are_the_packages():
    frozen = {f.name: f.default for f in dataclasses.fields(frozen_config.DetectorParams)}
    assert frozen == class_defaults(ORIGINAL / "config.py", "DetectorParams")
    assert frozen_config.DEFAULT_PARAMS == frozen_config.DetectorParams()
    tree = ast.parse((ORIGINAL / "families.py").read_text())
    (table,) = [n.value for n in ast.walk(tree) if isinstance(n, (ast.Assign, ast.AnnAssign))
                and any(getattr(t, "id", None) == "_FAMILY_PARAMS"
                        for t in (n.targets if isinstance(n, ast.Assign) else [n.target]))]
    sizes = {ast.unparse(k): ast.literal_eval(v) for k, v in zip(table.keys, table.values)}
    fam = frozen_config.get_family("t36h11")
    assert (fam.edge, fam.border, fam.hamming_distance) == sizes["TagFamily.T36H11"]


@pytest.mark.parametrize("name, count", [("EuRoC", 36), ("two_boards", 72), ("iphone", 66)])
def test_copy_finds_the_golden_counts_on_the_copied_captures(name, count):
    copied = ROOT / "benchmark/data" / f"{name}.png"
    assert copied.read_bytes() == (ROOT / "tests/data" / f"{name}.png").read_bytes()
    frame = frozen.load_image(str(copied))
    got = reference.detect(frame, "t36h11", 2)
    assert len(got) == count
    assert all(len(c) == 4 for c in got.values())


def test_bf16_rounds_to_nearest_even():
    # bfloat16 keeps 7 bits after the point: the step at 1.0 is 2**-7
    x = np.array([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8, 1.0 + 3 * 2**-9, 1.0 + 2**-9, 0.5],
                 np.float32)
    assert control.bf16(x).tolist() == [1.0, 1.0, 1.0 + 2**-6, 1.0 + 2**-7, 1.0, 0.5]


def test_control_fails_the_comparison():
    """The reference in bfloat16 in the detector's place, on pool frames of
    both configurations at their full size: its corners miss the limit."""
    for config, index in (("euroc-stereo", 5), ("phone1080-rgb", 9)):
        pool, _ = traffic.make_pool(traffic.load_json("configs", config), 2**31 + 99)
        frame = pool[index]
        ref = reference.detect(frame, "t36h11", 2)
        ctl = reference.detect(frame, "t36h11", 2, control=True)
        out = compare.compare([([0], [ctl])], {0: ref}, 0)
        assert not compare.passed(out["checks"]), out
        assert compare.passed(compare.compare([([0], [ref])], {0: ref}, 0)["checks"])
