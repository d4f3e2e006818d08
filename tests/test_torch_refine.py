"""The PyTorch port's sparse full-resolution refine (kernels/refine.py,
ops/rochade.py::refine_at_raw; plain version on the CPU) held against the
JAX package's Pallas kernel in interpret mode and its ops statement."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aprilgrid_tpu.oracle import numpy_ref as R
from aprilgrid_tpu.ops import rochade as jrochade
from aprilgrid_tpu.pallas import frontend as jpal
from aprilgrid_tpu.pallas import refine as jrefine
from aprilgrid_tpu_torch.kernels.frontend import pad_raw
from aprilgrid_tpu_torch.kernels.refine import sparse_refine_raw
from aprilgrid_tpu_torch.ops import rochade as trochade


def _centers(img, k=256, seed=0):
    """Valid-prefix candidate slots: the oracle's saddles (jittered), and
    centres within 7 px of each image edge, then invalid filler."""
    h, w = img.shape[:2]
    rng = np.random.default_rng(seed)
    pts = np.array([s.p for s in R.refined_saddle_points(img)], np.float32)
    pts = pts[:150] + rng.uniform(-0.7, 0.7, pts[:150].shape).astype(np.float32)
    t = rng.uniform(0, 1, 12).astype(np.float32)
    edge = np.concatenate([
        np.stack([t[:3] * w, rng.uniform(0, 7, 3)], 1),          # top
        np.stack([t[3:6] * w, h - 1 - rng.uniform(0, 7, 3)], 1),  # bottom
        np.stack([rng.uniform(0, 7, 3), t[6:9] * h], 1),         # left
        np.stack([w - 1 - rng.uniform(0, 7, 3), t[9:] * h], 1),   # right
        [[4.2, 4.4], [w - 5.3, h - 5.2], [0.0, 0.0], [w - 1.0, h - 1.0]],
    ]).astype(np.float32)
    valid_pts = np.concatenate([pts, edge])
    centers = np.zeros((k, 2), np.float32)
    centers[: len(valid_pts)] = valid_pts
    valid = np.arange(k) < len(valid_pts)
    return centers, valid


@pytest.mark.parametrize(
    "name,crop,u16",
    [
        ("iphone", (416, 640), False),   # RGB
        ("EuRoC", (416, 512), False),    # u8 gray
        ("EuRoC", (385, 501), True),     # u16 gray (x257), odd dims
    ],
)
def test_sparse_refine_matches_jax_kernel(data_dir, name, crop, u16):
    """Same ``valid`` as the JAX kernel, positions within 1e-4 px and
    k/theta/phi within 1e-3 on the accepted slots (two f32 fit orders)."""
    img = R.load_image(str(data_dir / f"{name}.png"))[: crop[0], : crop[1]]
    if u16:
        img = img.astype(np.uint16) * 257
    h, w = img.shape[:2]
    centers, valid = _centers(img)
    jraw, _, _, ch, ju16 = jpal.pad_raw(jnp.asarray(img)[None])
    js = jrefine.sparse_refine_raw(
        jraw, jnp.asarray(centers)[None], jnp.asarray(valid)[None], h, w,
        channels=ch, u16=ju16, interpret=True,
    )
    raw, _, _, ch, tu16 = pad_raw(torch.from_numpy(img)[None])
    ts = sparse_refine_raw(raw, torch.from_numpy(centers)[None],
                           torch.from_numpy(valid)[None], h, w, ch, tu16)
    jv = np.asarray(js.valid[0])
    np.testing.assert_array_equal(ts.valid[0].numpy(), jv)
    assert jv.sum() > 25 and not jv[valid.sum():].any()
    np.testing.assert_allclose(ts.p[0].numpy()[jv], np.asarray(js.p[0])[jv],
                               rtol=0, atol=1e-4)
    for field in ("k", "theta", "phi"):
        np.testing.assert_allclose(getattr(ts, field)[0].numpy()[jv],
                                   np.asarray(getattr(js, field)[0])[jv], atol=1e-3)


@pytest.mark.parametrize("u16", [False, True])
def test_refine_at_raw_matches_jax_ops_on_gray(data_dir, u16):
    """Gray frames share every formula with the JAX ops statement up to
    the fit's op order (rank-1 passes here, the dense pseudo-inverse
    there): same accept decisions, positions within 2e-5 px (measured
    1.53e-5, one f32 ulp of a coordinate between 128 and 256); the edge
    centres are included (clamped reads = the blur's edge replication)."""
    img = R.load_image(str(data_dir / "EuRoC.png"))[:300, :400]
    if u16:
        img = img.astype(np.uint16) * 257
    centers, valid = _centers(img, seed=1)
    js = jrochade.refine_at_raw(jnp.asarray(img), jnp.asarray(centers),
                                jnp.asarray(valid))
    ts = trochade.refine_at_raw(torch.from_numpy(img)[None],
                                torch.from_numpy(centers)[None],
                                torch.from_numpy(valid)[None])
    jv = np.asarray(js.valid)
    np.testing.assert_array_equal(ts.valid[0].numpy(), jv)
    assert jv.sum() > 30
    err = np.abs(ts.p[0].numpy()[jv] - np.asarray(js.p)[jv]).max()
    assert err <= 2e-5, err
    # and equal to refining on the blurred luma of the whole frame
    from aprilgrid_tpu_torch.ops.frontend import gaussian_blur
    from aprilgrid_tpu_torch.ops.gray import to_luma

    blur = gaussian_blur(to_luma(torch.from_numpy(img))[0], 1.5)
    whole = trochade.rochade_refine(blur, torch.from_numpy(centers),
                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(whole.valid.numpy(), jv)
    # bit-equal on every slot whose support lies in the image, accepted or
    # not: that includes the centres 4 to 7 px from an edge, whose 15x15
    # raw patch hangs over it
    h, w = img.shape
    rx, ry = np.floor(centers[:, 0] + 0.5), np.floor(centers[:, 1] + 0.5)
    inb = valid & (rx >= 4) & (rx < w - 4) & (ry >= 4) & (ry < h - 4)
    near = inb & ((rx < 7) | (rx >= w - 7) | (ry < 7) | (ry >= h - 7))
    assert near.sum() >= 4
    np.testing.assert_array_equal(whole.p.numpy()[inb], ts.p[0].numpy()[inb])


def test_sparse_refine_checks_its_arguments():
    raw = torch.zeros((1, 80, 128), dtype=torch.uint8)
    c = torch.zeros((1, 8, 2))
    v = torch.zeros((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="centers"):
        sparse_refine_raw(raw, c[0], v, 64, 128)
    with pytest.raises(ValueError, match="valid"):
        sparse_refine_raw(raw, c, v.to(torch.uint8), 64, 128)
    with pytest.raises(ValueError, match="hp2"):
        sparse_refine_raw(raw, c, v, 64, 128, hp2=6)
    assert not sparse_refine_raw(raw, c, v, 64, 128).valid.any()
