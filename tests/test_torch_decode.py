"""The PyTorch port's tag decode and hamming table scan held against the
JAX package on the CPU (same numpy inputs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aprilgrid_tpu import native as jnative
from aprilgrid_tpu.config import CONSTANTS
from aprilgrid_tpu.families import get_family as j_family
from aprilgrid_tpu.oracle import numpy_ref as R
from aprilgrid_tpu.ops import decode as jdecode
from aprilgrid_tpu.ops.geometry import rust_round as j_round
from aprilgrid_tpu.pallas.decode import hamming_scan as j_hamming
from aprilgrid_tpu_torch.families import get_family
from aprilgrid_tpu_torch.kernels.decode import (
    decode_packed,
    decode_packed_plain,
    hamming_scan,
    hamming_scan_plain,
)
from aprilgrid_tpu_torch.ops import decode as tdecode
from aprilgrid_tpu_torch.ops.geometry import rust_round


@pytest.mark.parametrize("family", ["t36h11", "t16h5", "t25h9"])
def test_hamming_scan_plain_matches_jax_kernel(family):
    """Exact min and FIRST-argmin, with planted exact codes and ties."""
    spec = get_family(family)
    codes = spec.code_bits.astype(np.float32)
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 2, (3, 40, codes.shape[1])).astype(np.float32)
    rows[0, 0] = codes[17 % len(codes)]
    rows[1, 1] = codes[0]
    rows[2, 2:5] = codes[-1]
    jm, ji = j_hamming(jnp.asarray(rows), jnp.asarray(codes), interpret=True)
    tm, ti = hamming_scan(torch.from_numpy(rows), spec.code_bits_tensor("cpu"))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32 and tm.dtype == torch.float32


def test_rust_round_matches_jax():
    x = np.array([-2.5, -1.5, -0.5, -0.49, 0.0, 0.49, 0.5, 1.5, 2.5, 3.7],
                 np.float32)
    np.testing.assert_array_equal(rust_round(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_round(jnp.asarray(x))))


@pytest.fixture(scope="module")
def euroc_search(data_dir):
    """EuRoC's luma8, its oracle saddles (x, y, theta) and the quads the
    board search finds on them (saddle rows)."""
    img = R.load_image(str(data_dir / "EuRoC.png"))
    saddles = R.refined_saddle_points(img)
    px = np.array([s.p[0] for s in saddles], np.float32)
    py = np.array([s.p[1] for s in saddles], np.float32)
    th = np.array([s.theta for s in saddles], np.float32)
    quads = jnative.find_board(px, py, th, np.ones(len(saddles), np.uint8))
    return R.to_luma8(img), px, py, th, quads


@pytest.fixture(scope="module")
def euroc_quads(euroc_search):
    luma8, px, py, _, quads = euroc_search
    qp = np.stack([px[quads], py[quads]], axis=-1)[None]  # (1, T, 4, 2)
    # a perturbed copy adds decodes that shift, fail or pass; the last
    # three quads are masked off
    rng = np.random.default_rng(1)
    bad = qp + rng.normal(0, 3, qp.shape).astype(np.float32)
    qp = np.concatenate([qp, bad], axis=1)
    qv = np.ones(qp.shape[:2], bool)
    qv[0, -3:] = False
    return luma8, qp.astype(np.float32), qv


def test_decode_quads_batch_matches_jax(euroc_quads):
    luma8, qp, qv = euroc_quads
    args = (CONSTANTS.decode_margin, CONSTANTS.valid_brightness_threshold,
            CONSTANTS.max_invalid_bit, CONSTANTS.min_contrast)
    ref = jdecode.decode_quads_batch(
        jnp.asarray(luma8)[None], jnp.asarray(qp), jnp.asarray(qv),
        j_family("t36h11"), *args, use_pallas=False,
    )
    got = tdecode.decode_quads_batch(
        torch.from_numpy(luma8)[None], torch.from_numpy(qp),
        torch.from_numpy(qv), get_family("t36h11"), *args,
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    v = np.asarray(ref.valid)
    assert v.sum() > 36  # the 36 tags, and some perturbed copies
    np.testing.assert_allclose(got.corners.numpy()[v], np.asarray(ref.corners)[v],
                               atol=1e-4)


def test_decode_positions_px_matches_jax(euroc_quads):
    luma8, qp, _ = euroc_quads
    h, w = luma8.shape
    for quad in qp[0, :5]:
        ref = jdecode.decode_positions_px(quad, j_family("t36h11"), 0.5, w, h)
        got = tdecode.decode_positions_px(quad, get_family("t36h11"), 0.5, w, h)
        np.testing.assert_array_equal(got, ref)


# -- the decode of a pass (kernels/decode.py::decode_packed) ----------------

_GATES = (CONSTANTS.decode_margin, CONSTANTS.valid_brightness_threshold,
          CONSTANTS.max_invalid_bit, CONSTANTS.min_contrast)


@pytest.fixture(scope="module")
def euroc_pass(euroc_search):
    """One pass of EuRoC as the facade hands it to ``decode_packed``:
    packed saddle rows (+ a counters row), luma8 in a padded noise plane,
    quads | count with the board's quads, random saddle quads (decodes
    that fail), some beyond the count, and -1 padding; dcap 96."""
    luma8, px, py, th, quads = euroc_search
    rng = np.random.default_rng(5)
    n = len(px)
    packed = np.zeros((1, n + 1, 4), np.float32)
    packed[0, :n] = np.stack([px, py, th, np.ones(n, np.float32)], -1)
    h, w = luma8.shape
    plane = rng.integers(0, 256, (1, h + 32, w + 128)).astype(np.uint8)
    plane[0, :h, :w] = luma8
    dcap = 96
    q = np.full((dcap, 4), -1, np.int64)
    q[: len(quads)] = quads
    q[len(quads) : len(quads) + 30] = rng.integers(0, n, (30, 4))
    count = len(quads) + 20
    qarr = np.concatenate([q.reshape(1, -1), [[count]]], 1).astype(np.int32)
    return packed, plane, qarr, (h, w), dcap


def test_decode_packed_plain_matches_jax(euroc_pass):
    """The facade's gather and concat around the JAX package's decode
    (Pallas scan in interpret mode), done in numpy, against the plain
    version of the port's one-launch decode."""
    packed, plane, qarr, hw, dcap = euroc_pass
    q = np.maximum(qarr[:, : dcap * 4].reshape(1, dcap, 4), 0)
    qp = packed[0][q[0], 0:2][None]
    qv = np.arange(dcap)[None] < qarr[:, dcap * 4][:, None]
    d = jdecode.decode_quads_batch(
        jnp.asarray(plane), jnp.asarray(qp), jnp.asarray(qv), j_family("t36h11"),
        *_GATES, true_shape=hw, use_pallas=True, interpret=True,
    )
    ref = np.concatenate([
        np.asarray(d.ids, np.float32)[..., None],
        np.asarray(d.valid, np.float32)[..., None],
        np.asarray(d.corners).reshape(1, dcap, 8),
    ], -1)
    got = decode_packed_plain(
        *(torch.from_numpy(a) for a in (packed, plane, qarr)), hw, dcap,
        get_family("t36h11"), *_GATES,
    ).numpy()
    np.testing.assert_array_equal(got[..., :2], ref[..., :2])
    assert got[..., 1].sum() == 36  # the board; the random quads fail
    np.testing.assert_allclose(got[..., 2:], ref[..., 2:], atol=1e-4)


def _ballot(pred: np.ndarray) -> np.ndarray:
    """__ballot_sync over the last axis (32 lanes) as uint64."""
    lanes = np.arange(32, dtype=np.uint64)
    return (pred.astype(np.uint64) << lanes).sum(-1, dtype=np.uint64)


def _round(x):
    """The kernel's rust_round: sign(x) * floor(|x| + 0.5) in f32."""
    s = (0 < x).astype(np.float32) - (x < 0).astype(np.float32)
    return s * np.floor(np.abs(x) + np.float32(0.5))


def _clamp0(x):
    return np.where(x < 0, np.float32(0), x)


def _index(x, hi):
    """The kernel's saturating conversion to an index in [0, hi] (NaN -> 0)."""
    return np.where(x > hi, hi, np.where(np.isnan(x), 0, x)).astype(np.int64)


_NO_CODE = np.uint64(65 << 20)


def _scan_keys(words: np.ndarray, table: np.ndarray) -> np.ndarray:
    """first_min_keys: lane l takes codes l, l + 32, ... and keeps its
    smallest (d << 20) | j; the warp's minimum over the lanes. words
    (..., R) uint64 -> keys (..., R) uint64."""
    c = len(table)
    pad = -c % 32
    j = np.arange(c + pad, dtype=np.uint64)
    d = np.bitwise_count(words[..., None] ^ np.concatenate(
        [table, np.zeros(pad, np.uint64)])).astype(np.uint64)
    keys = np.where(j < c, (d << np.uint64(20)) | j, _NO_CODE)
    lane_min = keys.reshape(*keys.shape[:-1], -1, 32).min(-2)  # (..., R, 32)
    return np.minimum(lane_min.min(-1), _NO_CODE)


def _words(spec) -> np.ndarray:
    return spec.code_words_tensor("cpu").numpy().view(np.uint64)


def _model_decode(packed, luma8, qarr, hw, dcap, spec):
    """numpy model of csrc/decode.cu::decode_packed_kernel: a warp (32
    lanes) per slot, lane k holding bits k and k + 32."""
    margin, vbt, max_invalid, min_contrast = _GATES
    bsz, n_rows = packed.shape[:2]
    h, w = hw
    nb = spec.edge * spec.edge
    pinv = tdecode._affine_pinv(spec.side_bits, margin)
    grid = tdecode._bit_grid(spec.edge, spec.border)
    src = nb - 1 - tdecode._rot_perms(spec.edge)
    b = np.repeat(np.arange(bsz), dcap)
    t = np.tile(np.arange(dcap), bsz)
    q = np.clip(qarr[:, : dcap * 4].reshape(-1, 4), 0, n_rows - 1)
    c = packed[b[:, None], q, :2].reshape(-1, 8)
    quad_valid = t < qarr[b, dcap * 4]
    corners_ok = quad_valid & ((_clamp0(_round(c[:, 0::2])) < w)
                               & (_clamp0(_round(c[:, 1::2])) < h)).all(-1)
    prm = []
    for p in range(6):
        acc = np.zeros(len(b), np.float32)
        for k in range(8):
            acc = acc + pinv[p, k] * c[:, k]
        prm.append(acc[:, None])
    lane = np.arange(32)
    on, v, in_frame = [], [], []
    for s in range(2):
        i = lane + 32 * s
        on.append(np.broadcast_to(i < nb, (len(b), 32)))
        gx, gy = grid[np.minimum(i, nb - 1), 0], grid[np.minimum(i, nb - 1), 1]
        px = (prm[0] * gx + prm[1] * gy) + prm[2]
        py = (prm[3] * gx + prm[4] * gy) + prm[5]
        sx, sy = _clamp0(_round(px)), _clamp0(_round(py))
        in_frame.append(~on[s] | ((sx < w) & (sy < h)))
        val = luma8[b[:, None], _index(sy, h - 1), _index(sx, w - 1)].astype(np.int64)
        v.append(np.where(on[s], val, 0))
    mn = np.minimum(*(np.where(o, x, 256) for o, x in zip(on, v))).min(-1)
    mx = np.maximum(*(np.where(o, x, 0) for o, x in zip(on, v))).max(-1)
    mid = (mn + mx + 1) >> 1
    invalid = sum(np.bitwise_count(_ballot(o & (np.abs(mid[:, None] - x) < vbt)))
                  for o, x in zip(on, v)).astype(np.int64)
    sample_ok = (in_frame[0] & in_frame[1]).all(-1)
    code_ok = (mx - mn >= min_contrast) & (invalid <= max_invalid)
    msb = _ballot(on[0] & (v[0] > mid[:, None])) | (
        _ballot(on[1] & (v[1] > mid[:, None])) << np.uint64(32))
    rot = []
    for r in range(4):
        bit = []
        for s in range(2):
            at = src[r][np.minimum(lane + 32 * s, nb - 1)].astype(np.uint64)
            bit.append(on[s] & (((msb[:, None] >> at) & np.uint64(1)) == 1))
        rot.append(_ballot(bit[0]) | (_ballot(bit[1]) << np.uint64(32)))
    keys = _scan_keys(np.stack(rot, -1), _words(spec))       # (slots, 4)
    accept = (keys >> np.uint64(20)).astype(np.int64) < spec.hamming_distance
    rotation = np.where(accept.any(-1), accept.argmax(-1), 0)
    valid = corners_ok & sample_ok & code_ok & accept.any(-1)
    ids = (keys[np.arange(len(b)), rotation] & np.uint64((1 << 20) - 1)).astype(np.float32)
    order = (3 - np.arange(4)[None] + rotation[:, None]) & 3
    corners = np.take_along_axis(c.reshape(-1, 4, 2), order[..., None], 1)
    out = np.concatenate([np.where(valid, ids, -1)[:, None].astype(np.float32),
                          valid[:, None].astype(np.float32), corners.reshape(-1, 8)], 1)
    return out.reshape(bsz, dcap, 10)


def _slot_cases():
    import chip_smoke

    return [case for fam in ("t36h11", "t16h5", "t25h9")
            for case in chip_smoke.decode_slot_sets(fam)]


@pytest.mark.parametrize("case", ["euroc", "t36h11", "t16h5", "t25h9"])
def test_decode_model_equals_plain(case, euroc_pass):
    """The kernel's warp algorithm, modelled in numpy (ballots, rotation
    words, strided lanes, the (d << 20) | j key, the first accepted
    rotation, the corner order), equals decode_packed_plain bit for bit
    over every slot: EuRoC's pass, and the smoke's synthetic slot sets
    (padding, count 0 and count = dcap, corners outside the true frame,
    NaN, an exact code under each rotation, ties; dcap 24 and 192)."""
    if case == "euroc":
        cases = [("t36h11 euroc",) + euroc_pass]
    else:
        cases = [c for c in _slot_cases() if c[0].startswith(case)]
    tags = 0
    for name, packed, luma8, qarr, hw, dcap in cases:
        spec = get_family(name.split()[0])
        want = decode_packed_plain(
            *(torch.from_numpy(a) for a in (packed, luma8, qarr)), hw, dcap, spec,
            *_GATES,
        ).numpy()
        with np.errstate(invalid="ignore"):
            got = _model_decode(packed, luma8, qarr, hw, dcap, spec)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=name)
        tags += int(want[..., 1].sum())
    assert tags == 36 if case == "euroc" else tags == 12  # the planted squares


@pytest.mark.parametrize("family", ["t16h5", "t25h7", "t25h9", "t36h11", "t36h11b1"])
def test_code_words_tensor_packs_code_bits(family):
    spec = get_family(family)
    words = _words(spec)
    bits = (words[:, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    nb = spec.edge * spec.edge
    np.testing.assert_array_equal(bits[:, :nb], spec.code_bits)
    assert not bits[:, nb:].any() and spec.code_words_tensor("cpu").dtype == torch.int64


@pytest.mark.parametrize("family", ["t36h11", "t16h5", "t25h9"])
def test_scan_model_equals_plain(family):
    """hamming_scan_kernel modelled in numpy — the table packed by warps
    from f32 with two ballots, a warp per row, lanes splitting the codes,
    the warp minimum of (d << 20) | j — equals hamming_scan_plain on rows
    with planted exact codes and ties."""
    spec = get_family(family)
    codes = spec.code_bits.astype(np.float32)
    nb = codes.shape[1]
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 2, (2, 70, nb)).astype(np.float32)
    rows[0, 0] = codes[3]
    rows[0, 1:4] = codes[-1]
    rows[1, 5] = codes[0]

    def pack(v):  # row_word: lane k holds values k and k + 32
        lane = np.arange(32)
        lo = np.where(lane < nb, v[..., np.minimum(lane, nb - 1)] > 0.5, False)
        hi = np.where(lane + 32 < nb, v[..., np.minimum(lane + 32, nb - 1)] > 0.5, False)
        return _ballot(lo) | (_ballot(hi) << np.uint64(32))

    table = pack(codes)
    np.testing.assert_array_equal(table, _words(spec))
    keys = _scan_keys(pack(rows)[..., None], table)[..., 0]
    pm, pi = hamming_scan_plain(torch.from_numpy(rows), torch.from_numpy(codes))
    np.testing.assert_array_equal((keys >> np.uint64(20)).astype(np.float32), pm.numpy())
    np.testing.assert_array_equal((keys & np.uint64((1 << 20) - 1)).astype(np.int32),
                                  pi.numpy())


def test_hamming_scan_rejects_2_20_codes():
    rows = torch.zeros((1, 1, 4))
    with pytest.raises(ValueError, match="codes"):
        hamming_scan(rows, torch.zeros((1 << 20, 4)))


def test_decode_packed_contract(euroc_pass):
    """On the CPU the wrapper is the plain version; shapes it cannot take
    raise ValueError."""
    packed, plane, qarr, hw, dcap = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in euroc_pass)
    spec = get_family("t36h11")
    got = decode_packed(packed, plane, qarr, hw, dcap, spec, *_GATES)
    want = decode_packed_plain(packed, plane, qarr, hw, dcap, spec, *_GATES)
    assert torch.equal(got, want) and got.shape == (1, dcap, 10)
    with pytest.raises(ValueError, match="qarr"):
        decode_packed(packed, plane, qarr[:, 1:], hw, dcap, spec, *_GATES)
    with pytest.raises(ValueError, match="beyond"):
        decode_packed(packed, plane, qarr, (plane.shape[1] + 1, 10), dcap, spec, *_GATES)
