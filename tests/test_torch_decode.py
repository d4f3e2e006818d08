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
from aprilgrid_tpu_torch.kernels.decode import hamming_scan
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
def euroc_quads(data_dir):
    img = R.load_image(str(data_dir / "EuRoC.png"))
    saddles = R.refined_saddle_points(img)
    px = np.array([s.p[0] for s in saddles], np.float32)
    py = np.array([s.p[1] for s in saddles], np.float32)
    th = np.array([s.theta for s in saddles], np.float32)
    quads = jnative.find_board(px, py, th, np.ones(len(saddles), np.uint8))
    qp = np.stack([px[quads], py[quads]], axis=-1)[None]  # (1, T, 4, 2)
    # a perturbed copy adds decodes that shift, fail or pass; the last
    # three quads are masked off
    rng = np.random.default_rng(1)
    bad = qp + rng.normal(0, 3, qp.shape).astype(np.float32)
    qp = np.concatenate([qp, bad], axis=1)
    qv = np.ones(qp.shape[:2], bool)
    qv[0, -3:] = False
    return R.to_luma8(img), qp.astype(np.float32), qv


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
