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


# -- the refine kernel's per-slot work, gates inside, as a numpy model


def _refine_kernel_model(raw_p, centers, valid, h, w, ch, u16, hp2=4):
    """What ``csrc/refine.cu`` does for each (frame, slot), in numpy on
    the padded frames: a slot that is not valid -> a row of zeros; else
    round the centre half away from zero, gate it against the ``hp2``
    bound, clamp it into the image, gather the 15x15 raw patch with
    clamped indices, luma, the two blur passes in tap order, the fit, the
    angles. Returns (B, K, 8) rows [x, y, k, theta, phi, ok, 0, 0]; the
    valid slots are taken in whatever order they lie, not as a prefix."""
    from aprilgrid_tpu_torch.ops.frontend import gaussian_kernel
    from aprilgrid_tpu_torch.ops.gray import raw_luma

    taps = gaussian_kernel(1.5)
    b, k = valid.shape
    out = np.zeros((b, k, 8), np.float32)
    off = np.arange(15) - 7
    for bi in range(b):
        live = np.nonzero(valid[bi])[0]
        if len(live) == 0:
            continue
        c = centers[bi, live]
        rnd = np.copysign(np.floor(np.abs(c) + np.float32(0.5)), c).astype(np.int64)
        cxr, cyr = rnd[:, 0], rnd[:, 1]
        inside = (cyr >= hp2) & (cyr < h - hp2) & (cxr >= hp2) & (cxr < w - hp2)
        rx, ry = np.clip(cxr, 0, w - 1), np.clip(cyr, 0, h - 1)
        yy = np.clip(ry[:, None] + off, 0, h - 1) + 8          # padded rows
        xx = np.clip(rx[:, None] + off, 0, w - 1)
        cols = (ch * xx)[:, None, :, None] + np.arange(ch)     # (n, 1, 15, ch)
        patch = raw_p[bi][yy[:, :, None, None], cols].reshape(len(live), 15, 15 * ch)
        lum = raw_luma(torch.from_numpy(patch), ch, u16)[0].numpy()
        tmp = np.zeros((len(live), 15, 9), np.float32)
        for i, kw in enumerate(taps):
            tmp = tmp + lum[:, :, i : i + 9] * kw
        bl = np.zeros((len(live), 9, 9), np.float32)
        for i, kw in enumerate(taps):
            bl = bl + tmp[:, i : i + 9, :] * kw
        x0, y0, c3, c4, c5, ok = trochade.fit_record(torch.from_numpy(bl))
        # the angles at the slots' own positions in a (1, K) row: PyTorch's
        # CPU atan2 and acos differ in the last bit between the vector body
        # and the scalar tail of their loops
        spread = torch.zeros((3, 1, k))
        spread[:, 0, live] = torch.stack([c3, c4, c5])
        kk, theta, phi = (t[0, live] for t in trochade.saddle_angles(*spread))
        out[bi, live] = np.stack([
            rx.astype(np.float32) + x0.numpy(), ry.astype(np.float32) + y0.numpy(),
            kk.numpy(), theta.numpy(), phi.numpy(),
            (ok.numpy() & inside).astype(np.float32),
            np.zeros(len(live), np.float32), np.zeros(len(live), np.float32),
        ], 1)
    return out


_SLOT_FRAMES = {}


def _slot_frames(data_dir, kind):
    """A crop of one raw mode and the four slot sets of
    ``chip_smoke.refine_slot_sets`` around the oracle's saddles."""
    import sys

    sys.path.insert(0, str(data_dir.parent.parent))
    import chip_smoke

    if kind not in _SLOT_FRAMES:
        name, crop = ("iphone", (416, 640)) if kind == "rgb" else ("EuRoC", (385, 501))
        img = R.load_image(str(data_dir / f"{name}.png"))[: crop[0], : crop[1]]
        if kind == "u16":
            img = img.astype(np.uint16) * 257
        c0, v0 = _centers(img, k=768)
        _SLOT_FRAMES[kind] = (img, *chip_smoke.refine_slot_sets(c0, v0, *img.shape[:2]))
    return _SLOT_FRAMES[kind]


@pytest.mark.parametrize("slots", ["every", "none", "interleaved", "halves"])
@pytest.mark.parametrize("kind", ["u8", "u16", "rgb"])
def test_refine_kernel_model_equals_plain(data_dir, kind, slots):
    """The kernel's per-slot work with the gates inside equals
    ``sparse_refine_raw_plain`` bit for bit on every slot that goes in
    valid — all 768 slots valid, none, valid slots interleaved with
    invalid ones, centres on x.5 (the rounding's ties), negative, either
    side of the 4-pixel bound and far outside the image — with the same
    accept bits, and rows of zeros elsewhere."""
    from aprilgrid_tpu_torch.kernels.refine import sparse_refine_raw_plain

    img, names, centers, valid = _slot_frames(data_dir, kind)
    i = names.index(slots)
    h, w = img.shape[:2]
    raw, _, _, ch, u16 = pad_raw(torch.from_numpy(img)[None])
    c, v = centers[i : i + 1], valid[i : i + 1]
    rows = _refine_kernel_model(raw.numpy(), c, v, h, w, ch, u16)
    want = sparse_refine_raw_plain(raw, torch.from_numpy(c), torch.from_numpy(v), h, w, ch, u16)
    np.testing.assert_array_equal(rows[..., 5] > 0.5, want.valid.numpy())
    np.testing.assert_array_equal(rows[v][:, 0:2], want.p.numpy()[v])
    for col, field in ((2, "k"), (3, "theta"), (4, "phi")):
        np.testing.assert_array_equal(rows[v][:, col], getattr(want, field).numpy()[v])
    assert not rows[~v].any()
    assert (slots == "none") == (not want.valid.any())
    if slots == "halves":   # centres on the rounding's ties, and gated ones
        frac = np.abs(c[0][v[0]]) % 1
        assert (frac == 0.5).sum() > 100 and (~want.valid.numpy()[v]).sum() > 14
