"""The PyTorch port's on-device board search and its xla mode (plain
PyTorch on the CPU) held against the JAX package on the same inputs: the
geometry predicates, the sized compaction, ``knn_table``, ``init_quads``,
``propose_expansions``, ``resolve_conflicts``, ``grow_boards_joint``,
``find_best_board`` and ``detect_tail`` against their JAX functions, bit
for bit where the op sequences match; the facade's ``mode="xla"`` against
the JAX xla facade (corners <= 1e-4 px) and the port's hybrid mode."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aprilgrid_tpu.config import CONSTANTS as JCONSTS
from aprilgrid_tpu.config import DEFAULT_CAPACITIES as JCAPS
from aprilgrid_tpu.config import DEFAULT_PARAMS as JPARAMS
from aprilgrid_tpu.detector import TagDetector as JaxDetector
from aprilgrid_tpu.families import get_family as jget_family
from aprilgrid_tpu.oracle.numpy_ref import load_image
from aprilgrid_tpu.ops import board as jboard
from aprilgrid_tpu.ops import geometry as jgeom
from aprilgrid_tpu.ops import quads as jquads
from aprilgrid_tpu.ops import search as jsearch
from aprilgrid_tpu.ops.rochade import Saddles as JSaddles
from aprilgrid_tpu.pipeline import detect_tail as jdetect_tail
from aprilgrid_tpu_torch import TagDetector, bench
from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
from aprilgrid_tpu_torch.families import get_family
from aprilgrid_tpu_torch.ops import board as tboard
from aprilgrid_tpu_torch.ops import geometry as tgeom
from aprilgrid_tpu_torch.ops import quads as tquads
from aprilgrid_tpu_torch.ops import search as tsearch
from aprilgrid_tpu_torch.ops.compact import nonzero_sized
from aprilgrid_tpu_torch.ops.rochade import Saddles
from aprilgrid_tpu_torch.parallel.pipeline_parallel import PipelineParallelDetector
from aprilgrid_tpu_torch.parallel.sharding import detect_batch_sharded, make_mesh
from aprilgrid_tpu_torch.parallel.streaming import MultiCameraDetector, detect_stream
from aprilgrid_tpu_torch.pipeline import detect_tail, saddle_frontend_batch
from conftest import GOLDEN_COUNTS, make_stress_scene

P, C, K = DEFAULT_PARAMS, CONSTANTS, DEFAULT_CAPACITIES
SEARCH_ARGS = (P.tag_spacing_ratio, K.grid_radius, C.quad_nn, K.max_quads, K.max_boards,
               K.seeds_per_group, K.max_attempts, C.max_seeds, C.early_exit_score,
               K.knn_pool)
BOARD_FIELDS = ("cell_quad", "placed", "failed", "active", "score", "pruned")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the search is many small operations, which
    spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jsaddles(p, theta, valid):
    n = valid.shape[-1]
    return JSaddles(p=jnp.asarray(p), k=jnp.zeros(n, jnp.float32), theta=jnp.asarray(theta),
                    phi=jnp.zeros(n, jnp.float32), valid=jnp.asarray(valid))


def _frontend(img):
    """The port's saddles and luma8 of one frame, as numpy arrays."""
    s, luma8, _ = saddle_frontend_batch(torch.from_numpy(img)[None], P, C, K)
    return s.p[0].numpy(), s.theta[0].numpy(), s.valid[0].numpy(), luma8[0].numpy()


@pytest.fixture(scope="module")
def euroc(data_dir):
    img = load_image(str(data_dir / "EuRoC.png"))
    return (img,) + _frontend(img)


@pytest.fixture(scope="module")
def jax_find():
    return jax.jit(lambda s, a: jsearch.find_best_board(s, a, *SEARCH_ARGS))


@pytest.fixture(scope="module")
def jax_tail():
    spec = jget_family("t36h11")
    return jax.jit(lambda s, l8: jdetect_tail(s, l8, spec, JPARAMS, JCONSTS, JCAPS,
                                              slots_full=jnp.all(s.valid)))


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in f32 units in the last place."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def test_geometry_predicates_match_jax():
    """4,096 random quads near a square lattice (so every gate both passes
    and fails): is_valid_quad's booleans equal; theta distance, cross,
    dot, degrees/radians bit-equal; angle_degree within 2 ulps (atan2)."""
    rng = np.random.default_rng(0)
    n = 4096
    sq = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * 20.0
    p = (sq[None] + rng.normal(0, 1.5, (n, 4, 2))).astype(np.float32)
    t = (rng.choice([10.0, 100.0], (n, 1)) + rng.normal(0, 3.0, (n, 4))).astype(np.float32)
    t[:, 0] = (135.0 + rng.normal(0, 30.0, n)).astype(np.float32)
    args = (p[:, 0], t[:, 0], p[:, 1], t[:, 1], p[:, 2], p[:, 3], t[:, 3])
    got = tgeom.is_valid_quad(*map(_t, args)).numpy()
    want = np.asarray(jgeom.is_valid_quad(*map(jnp.asarray, args)))
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.95
    v0, v1 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    for name in ("cross", "dot"):
        np.testing.assert_array_equal(getattr(tgeom, name)(_t(v0), _t(v1)).numpy(),
                                      np.asarray(getattr(jgeom, name)(v0, v1)))
    np.testing.assert_array_equal(
        tgeom.theta_distance_degree(_t(t[:, 1]), _t(t[:, 3])).numpy(),
        np.asarray(jgeom.theta_distance_degree(t[:, 1], t[:, 3])))
    np.testing.assert_array_equal(tgeom.radians(_t(t)).numpy(), np.asarray(jnp.radians(t)))
    np.testing.assert_array_equal(tgeom.degrees(_t(t)).numpy(), np.asarray(jnp.degrees(t)))
    # atan2 of the two libraries differs by up to 1 ulp (on 16 % of these
    # inputs); the multiply by 180/pi carries that to at most 2 ulps
    c, d = jgeom.cross(v0, v1), jgeom.dot(v0, v1)
    assert _ulps(torch.atan2(_t(c), _t(d)).numpy(), np.asarray(jnp.arctan2(c, d))) <= 1
    assert _ulps(tgeom.angle_degree(_t(v0), _t(v1)).numpy(),
                 np.asarray(jgeom.angle_degree(v0, v1))) <= 2


@pytest.mark.parametrize("kind", ["empty", "full", "over", "random"])
def test_nonzero_sized_matches_jax(kind):
    """The sized compaction = ``jnp.nonzero(size=, fill_value=)`` row by
    row, with fewer, as many and more set entries than ``size``."""
    rng = np.random.default_rng(1)
    mask = {"empty": np.zeros((3, 100), bool), "full": np.ones((3, 100), bool),
            "over": rng.random((3, 100)) < 0.6,
            "random": rng.random((3, 100)) < 0.3}[kind]
    got = nonzero_sized(_t(mask), 40, 100).numpy()
    for row, g in zip(mask, got):
        (want,) = jnp.nonzero(jnp.asarray(row), size=40, fill_value=100)
        np.testing.assert_array_equal(g, np.asarray(want))


@pytest.mark.parametrize("field", ["euroc", "ties"])
def test_knn_table_matches_jax(euroc, field):
    """Equal index tables: on EuRoC's saddles, and on a lattice whose
    distances tie everywhere, with dead saddles among them (``inf``)."""
    if field == "euroc":
        p, _, alive = euroc[1], euroc[2], euroc[3]
    else:
        g = np.stack(np.meshgrid(np.arange(12), np.arange(12)), -1).reshape(-1, 2)
        p = (g * 10.0).astype(np.float32)
        p[7] = p[8]   # a duplicate position
        alive = np.random.default_rng(2).random(len(p)) < 0.8
    got = tboard.knn_table(_t(p)[None], _t(alive)[None], 64)[0].numpy()
    want = np.asarray(jboard.knn_table(_jsaddles(p, np.zeros(len(p), np.float32), alive),
                                       jnp.asarray(alive), 64))
    np.testing.assert_array_equal(got, want)


def test_init_quads_every_alive_seed_of_euroc(euroc):
    """Every alive saddle of EuRoC as a seed (one lane each): the same
    quads, valid flags and overflow counts as the JAX function vmapped
    over the seeds."""
    _, p, theta, alive, _ = euroc
    seeds = np.flatnonzero(alive)
    js = _jsaddles(p, theta, alive)
    want = jax.jit(jax.vmap(lambda s: jquads.init_quads(
        js, js.valid, s, C.quad_nn, K.max_quads)))(jnp.asarray(seeds, jnp.int32))
    for lo in range(0, len(seeds), 64):
        lanes = seeds[lo:lo + 64]
        m = len(lanes)
        got = tquads.init_quads(
            _t(p)[None].expand(m, -1, -1), _t(theta)[None].expand(m, -1),
            _t(alive)[None].expand(m, -1), _t(lanes), C.quad_nn, K.max_quads)
        valid = np.asarray(want.valid)[lo:lo + m]
        np.testing.assert_array_equal(got.valid.numpy(), valid)
        np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow)[lo:lo + m])
        np.testing.assert_array_equal(got.quads.numpy()[valid], np.asarray(want.quads)[lo:lo + m][valid])
        assert got.quads.dtype == torch.int32
    assert np.asarray(want.valid).any()


def test_init_quads_set_overflow_is_flagged():
    """A field whose same-orientation set overflows the 40-slot cap: the
    overflow count equals the JAX function's, and is non-zero."""
    rng = np.random.default_rng(3)
    n = 120
    p = rng.uniform(0, 60, size=(n, 2)).astype(np.float32)
    theta = (10.0 + rng.normal(0, 0.5, n)).astype(np.float32)
    alive = np.ones(n, bool)
    want = jax.jit(lambda s, a: jquads.init_quads(s, a, jnp.int32(0), 50, 32))(
        _jsaddles(p, theta, alive), jnp.asarray(alive))
    got = tquads.init_quads(_t(p)[None], _t(theta)[None], _t(alive)[None],
                            torch.tensor([0]), 50, 32)
    assert int(got.overflow[0]) == int(want.overflow) > 0
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(want.valid))


def _random_field(seed):
    """A clustered field with duplicate positions and a big same-theta
    population, and random proposals (as tests/test_propose_equiv.py)."""
    rng = np.random.default_rng(seed)
    n = 160
    base = rng.uniform(0, 200, size=(n, 2)).astype(np.float32)
    base[: n // 2] = (np.stack(np.meshgrid(np.arange(8), np.arange(10)), -1)
                      .reshape(-1, 2)[: n // 2] * 20.0
                      + rng.normal(0, 1.5, (n // 2, 2))).astype(np.float32)
    base[5] = base[4]
    theta = rng.uniform(-90, 90, n).astype(np.float32)
    theta[: n // 3] = theta[0]
    alive = rng.random(n) > 0.1
    active = alive & (rng.random(n) > 0.15)
    quads = rng.integers(0, n, size=(144, 4), dtype=np.int32)
    return base, theta, alive, active, quads


def _board_field(euroc):
    """EuRoC's saddles with every placed cell of its board as a proposal in
    each of the 4 rotations, every alive saddle claimable: a proposal
    into a neighbouring cell of the board finds that cell's saddles."""
    _, p, theta, alive, _ = euroc
    res = tsearch.find_best_board(_t(p)[None], _t(theta)[None], _t(alive)[None], *SEARCH_ARGS)
    cq = res.board.cell_quad[0].numpy()[res.board.placed[0].numpy()]
    quads = np.concatenate([np.roll(cq, -d, axis=1) for d in range(4)]).astype(np.int32)
    return p, theta, alive, alive, quads


@pytest.mark.parametrize("field", ["random0", "random1", "euroc"])
def test_propose_expansions_matches_jax(euroc, field):
    """The first valid combo, the valid flags and the pool audit bit-equal
    to the JAX function's: random proposals on a clustered field, and the
    rotated cells of EuRoC's board on its saddles (most of which expand).
    Two frames in one call, the second the first's saddles reversed."""
    f = _board_field(euroc) if field == "euroc" else _random_field(int(field[-1]))
    n = len(f[0])
    rev = tuple(x[::-1].copy() for x in f[:4]) + ((n - 1 - f[4]).astype(np.int32),)
    frames = [f, rev]
    stack = [np.stack(x) for x in zip(*frames)]
    knn = tboard.knn_table(_t(stack[0]), _t(stack[2]))
    got = tboard.propose_expansions(_t(stack[0]), _t(stack[1]), knn, _t(stack[2]),
                                    _t(stack[4]), _t(stack[3]), 0.3)
    fn = jax.jit(lambda s, a, q, act: jboard.propose_expansions(
        s, jboard.knn_table(s, a), a, q, act, 0.3))
    valid = []
    for b, (pb, tb, ab, actb, qb) in enumerate(frames):
        want = fn(_jsaddles(pb, tb, ab), jnp.asarray(ab), jnp.asarray(qb), jnp.asarray(actb))
        v = np.asarray(want[1])
        np.testing.assert_array_equal(got[1][b].numpy(), v)
        np.testing.assert_array_equal(got[0][b].numpy()[v], np.asarray(want[0])[v])
        np.testing.assert_array_equal(got[2][b].numpy(), np.asarray(want[2]))
        valid.append(v)
    np.testing.assert_array_equal(valid[0], valid[1])
    if field == "euroc":
        assert 0 < valid[0].sum() < len(valid[0])


@pytest.mark.parametrize("seed", range(4))
def test_resolve_conflicts_matches_dense_and_jax(seed):
    """Scatter-min claims = the pairwise oracle = the JAX function, on
    three frames of random proposals under heavy collision pressure with
    dead-slot sentinels (as tests/test_board_conflicts.py)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 200))
    g2 = int(rng.integers(4, 120))
    n_p = int(rng.integers(1, 96))
    sn = max(2, n // (8 if seed % 2 else 1))
    sg = max(2, g2 // (8 if seed % 3 else 1))
    quad = rng.integers(0, sn, size=(3, n_p, 4)).astype(np.int32)
    dead = rng.random((3, n_p)) < 0.2
    valid = (rng.random((3, n_p)) < 0.6) & ~dead
    tgt = np.where(dead, g2, rng.integers(0, sg, size=(3, n_p))).astype(np.int32)
    got = tboard.resolve_conflicts(_t(tgt), _t(quad), _t(valid), n, g2).numpy()
    dense = tboard.resolve_conflicts_dense(_t(tgt), _t(quad), _t(valid)).numpy()
    np.testing.assert_array_equal(got, dense)
    for b in range(3):
        want = jboard.resolve_conflicts(jnp.asarray(tgt[b]), jnp.asarray(quad[b]),
                                        jnp.asarray(valid[b]), n, g2)
        np.testing.assert_array_equal(got[b], np.asarray(want))


def test_resolve_conflicts_chain_is_single_level():
    """Blocking is by earlier VALID proposals: 0 blocks 1 (same target),
    and 1, though blocked, still blocks 2 (a shared saddle)."""
    tgt = torch.tensor([[5, 5, 6]])
    quad = torch.tensor([[[0, 1, 2, 3], [4, 5, 6, 7], [7, 8, 9, 10]]])
    valid = torch.tensor([[True, True, True]])
    assert tboard.resolve_conflicts(tgt, quad, valid, 16, 8).tolist() == [[True, False, False]]


def test_grow_boards_joint_matches_grow_board_and_jax(euroc):
    """EuRoC's candidate quads of three seeds (full boards and dead quads),
    one frame each: the joint growth = the per-board oracle ``grow_board``
    = the JAX joint growth, every field and the audit."""
    _, p, theta, alive, _ = euroc
    js = _jsaddles(p, theta, alive)
    jknn = jboard.knn_table(js, js.valid, 64)
    jgrow = jax.jit(lambda q, ok: jboard.grow_boards_joint(
        js, jknn, js.valid, q, ok, js.valid, 0.3, 12, loop_attempts=256))
    seeds = (0, 17, 101)
    cands = []
    for s in seeds:
        qs = jquads.init_quads(js, js.valid, jnp.int32(s), 50, 32)
        (sel,) = jnp.nonzero(qs.valid, size=32, fill_value=32)
        cands.append((np.asarray(qs.quads[jnp.minimum(sel, 31)]), np.asarray(sel < 32)))
    q = np.stack([c[0] for c in cands])
    ok = np.stack([c[1] for c in cands])
    bsz = len(seeds)
    tp, tt, ta = (_t(x)[None].expand(bsz, *x.shape).contiguous() for x in (p, theta, alive))
    knn = tboard.knn_table(tp, ta, 64)
    got, audit = tboard.grow_boards_joint(tp, tt, knn, ta, _t(q), _t(ok), ta, 0.3, 12)
    # the oracle: one lane a board
    lanes = bsz * 32
    rep = [x.repeat_interleave(32, 0) for x in (tp, tt, knn, ta)]
    one = tboard.grow_board(rep[0], rep[1], rep[2], rep[3], _t(q).reshape(lanes, 4),
                            _t(ok).reshape(lanes), rep[3], 0.3, 12, max_attempts=64)
    placed = got.placed.numpy()
    for name in ("placed", "failed", "score", "active"):
        np.testing.assert_array_equal(getattr(one, name).numpy().reshape(getattr(got, name).shape),
                                      getattr(got, name).numpy(), err_msg=name)
    for b in range(bsz):
        want, jaudit = jgrow(jnp.asarray(q[b]), jnp.asarray(ok[b]))
        for name in ("placed", "failed", "score", "active"):
            np.testing.assert_array_equal(getattr(got, name)[b].numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
        pm = placed[b][..., None]
        np.testing.assert_array_equal(np.where(pm, got.cell_quad[b].numpy(), -1),
                                      np.where(pm, np.asarray(want.cell_quad), -1))
        assert int(audit[b]) == int(jaudit)
    assert got.score.max() == 36


def test_find_best_board_both_passes_match_jax(euroc, jax_find):
    """``find_best_board`` on EuRoC's saddles, the first pass and a second
    with the winner's saddles released: the winning board's every field,
    ``found`` and the audit bit-equal to the JAX function's."""
    _, p, theta, alive, _ = euroc
    masks = [alive]
    for _ in range(2):
        a = masks[-1]
        res = tsearch.find_best_board(_t(p)[None], _t(theta)[None], _t(a)[None], *SEARCH_ARGS)
        want = jax_find(_jsaddles(p, theta, alive), jnp.asarray(a))
        assert bool(res.found[0]) == bool(want.found)
        for name in BOARD_FIELDS:
            np.testing.assert_array_equal(getattr(res.board, name)[0].numpy(),
                                          np.asarray(getattr(want.board, name)), err_msg=name)
        cq = res.board.cell_quad[0].numpy()
        used = cq[res.board.placed[0].numpy()].reshape(-1)
        nxt = a.copy()
        nxt[used] = False
        masks.append(nxt)
    assert masks[1].sum() < masks[0].sum()


def _tail(frames):
    """The port's detect_tail on a batch of (p, theta, valid, luma8)."""
    p, theta, valid, luma8 = (torch.from_numpy(np.stack(x)) for x in zip(*frames))
    n = valid.shape[1]
    s = Saddles(p=p, k=torch.zeros(len(frames), n), theta=theta,
                phi=torch.zeros(len(frames), n), valid=valid)
    return detect_tail(s, luma8, get_family("t36h11"), P, C, K, slots_full=valid.all(-1))


def _assert_tail_equal(got, b, want):
    np.testing.assert_array_equal(got.ids[b].numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.valid[b].numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.corners[b].numpy(), np.asarray(want.corners))
    np.testing.assert_array_equal(got.flags[b].numpy(), np.asarray(want.flags))


def test_detect_tail_freezes_finished_frames(euroc, data_dir, jax_tail):
    """``detect_tail`` on a batch of EuRoC, a blank frame and EuRoC turned
    by 180 degrees (each frame's loops end after other counts of sweeps and
    groups) equals the JAX function on each frame alone: ids, valid flags,
    corners and flags bit-equal, 36 tags on each EuRoC frame."""
    img = euroc[0]
    frames = [euroc[1:], _frontend(np.zeros_like(img)), _frontend(img[::-1, ::-1].copy())]
    tboard.SYNCS.update(dict.fromkeys(tboard.SYNCS, 0))
    got = _tail(frames)
    assert tboard.SYNCS["grow_sweep"] > 0 and tboard.SYNCS["search_group"] > 0
    for b, (p, theta, valid, luma8) in enumerate(frames):
        want = jax_tail(_jsaddles(p, theta, valid), jnp.asarray(luma8))
        _assert_tail_equal(got, b, want)
    assert [int(v.sum()) for v in got.valid] == [36, 0, 36]


def test_xla_facade_matches_jax_facade(euroc):
    """``TagDetector(mode="xla", device="cpu").detect`` (the single-image
    front-end) = the JAX xla facade on EuRoC: 36 tags, the same IDs,
    corners within 1e-4 px."""
    img = euroc[0]
    got = TagDetector("t36h11", mode="xla", device="cpu").detect(img)
    want = JaxDetector("t36h11", mode="xla").detect(img)
    assert len(got) == GOLDEN_COUNTS["EuRoC"] and set(got) == set(want)
    for tid in want:
        assert np.abs(np.asarray(got[tid]) - np.asarray(want[tid])).max() <= 1e-4, tid


@pytest.mark.parametrize("kind", ["EuRoC", "u16"])
def test_xla_detect_batch_equals_hybrid(euroc, kind):
    """xla ``detect_batch`` of two frames (the image and a blank one) =
    the port's hybrid ``detect_batch``, tag for tag and corner for corner;
    on EuRoC (u8) and a 16-bit stress scene."""
    img = euroc[0] if kind == "EuRoC" else make_stress_scene(1, kind="u16")
    frames = np.stack([img, np.zeros_like(img)])
    got = TagDetector("t36h11", mode="xla", device="cpu").detect_batch(frames, chunk=1)
    want = TagDetector("t36h11", device="cpu").detect_batch(frames)
    assert got == want and len(got[0]) >= 8 and got[1] == {}


def test_xla_turbo_matches_hybrid_turbo(data_dir):
    """``decimate=True`` in the xla mode on a 512 x 1024 two_boards crop:
    the hybrid turbo's ID set, corners within 1e-3 px (the JAX bound,
    tests/test_decimate.py::test_turbo_xla_mode)."""
    img = load_image(str(data_dir / "two_boards.png"))[:512, :1024]
    got = TagDetector("t36h11", mode="xla", device="cpu", decimate=True).detect_batch(img[None])[0]
    want = TagDetector("t36h11", device="cpu", decimate=True).detect_batch(img[None])[0]
    assert set(got) == set(want) and len(want) >= 12
    for tid in want:
        assert np.abs(np.asarray(got[tid]) - np.asarray(want[tid])).max() <= 1e-3, tid


def test_saddle_capacity_warns_xla(euroc):
    """A full saddle capacity raises the xla flags' warning (the JAX
    tests/test_counters.py::test_saddle_overflow_warns_xla)."""
    caps = dataclasses.replace(K, max_saddles=64)
    det = TagDetector("t36h11", capacities=caps, mode="xla", device="cpu")
    with pytest.warns(RuntimeWarning, match="saddle capacity"):
        det.detect_batch(euroc[0][None])


def test_detect_batch_sharded_xla_equals_detect_batch(euroc):
    """Two shards on ``[cpu, cpu]`` in the xla mode = ``detect_batch``, in
    batch order."""
    img = euroc[0]
    frames = np.stack([np.zeros_like(img), img])
    det = TagDetector("t36h11", mode="xla", device="cpu")
    mesh = make_mesh({"data": 2}, [torch.device("cpu")] * 2)
    got = detect_batch_sharded(det, frames, mesh)
    assert got == det.detect_batch(frames) and got[0] == {} and len(got[1]) == 36
    with pytest.raises(ValueError, match="does not split"):
        detect_batch_sharded(det, frames[:1], mesh)


def test_stream_and_cameras_take_the_xla_mode(euroc):
    """``detect_stream`` and ``MultiCameraDetector`` (a ``camera`` mesh of
    two CPU devices) drive an xla detector through ``detect_batch`` and
    ``detect_batch_sharded``: their results equal ``detect_batch``'s."""
    img = euroc[0]
    frames = np.stack([img, np.zeros_like(img)])
    det = TagDetector("t36h11", mode="xla", device="cpu")
    want = det.detect_batch(frames)
    assert list(detect_stream(det, [frames, frames[::-1]])) == [want, want[::-1]]
    cams = MultiCameraDetector(det, make_mesh({"camera": 2}, [torch.device("cpu")] * 2))
    assert cams.detect(frames[:, None]) == [[want[0]], [want[1]]]


def test_pipeline_parallel_rejects_xla():
    with pytest.raises(ValueError, match="hybrid"):
        PipelineParallelDetector(TagDetector("t36h11", mode="xla", device="cpu"),
                                 devices=[torch.device("cpu")] * 2)


def test_xla_on_cuda_without_a_card_raises(monkeypatch):
    """The default device is the card, and there is no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TagDetector("t36h11", mode="xla")


def test_zero_passes_and_empty_batch():
    det = TagDetector("t36h11", mode="xla", device="cpu",
                      params=dataclasses.replace(P, max_num_of_boards=0))
    img = np.zeros((64, 64), np.uint8)
    assert det.detect(img) == {} and det.detect_batch(np.stack([img, img])) == [{}, {}]
    assert TagDetector("t36h11", mode="xla", device="cpu").detect_batch(
        np.zeros((0, 64, 64), np.uint8)) == []


def test_bench_xla_mode_on_the_cpu():
    """``bench --modes xla``: the golden count and CPU parity, no chunk,
    the search's host syncs a call; batch 16 unless BENCH_BATCH is set."""
    env = dict(os.environ, BENCH_BATCH="1", BENCH_REPS="1", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "aprilgrid_tpu_torch.bench", "--device", "cpu",
         "--images", "EuRoC", "--modes", "xla"],
        cwd=Path(__file__).resolve().parents[1], env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    cell, geo = (json.loads(line) for line in out.stdout.strip().splitlines())
    assert cell["mode"] == "xla" and cell["tags"] == 36 and cell["ids_equal"]
    assert cell["chunk"] is None and cell["search_syncs"] > 0 and cell["batch"] == 1
    assert set(geo["geomean_frames_per_s"]) == {"xla"} and bench.XLA_BATCH == 16


def test_static_tables_match_jax():
    """The search's constant table, the grid neighbours, equals the JAX
    package's, and its device copy holds the same values."""
    for a, b in zip(tboard._neighbor_arrays(12), jboard._neighbor_arrays(12)):
        np.testing.assert_array_equal(a, b)
    tgt, ok = tboard._neighbors(12, torch.device("cpu"))
    np.testing.assert_array_equal(tgt.numpy(), jboard._neighbor_arrays(12)[0])
    np.testing.assert_array_equal(ok.numpy(), jboard._neighbor_arrays(12)[1])
