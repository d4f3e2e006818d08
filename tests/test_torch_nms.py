"""The PyTorch port's NMS extraction (kernels/nms.py, plain version on the
CPU) held against the JAX package's Pallas kernel in interpret mode, its
NumPy statement (tools/probe_nms.py) and its ``cells_to_fields``."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from probe_nms import nms_peaks  # noqa: E402

from aprilgrid_tpu.oracle.numpy_ref import load_image  # noqa: E402
from aprilgrid_tpu.pallas import frontend as jpal  # noqa: E402
from aprilgrid_tpu.pallas import nms as jnms  # noqa: E402
from aprilgrid_tpu_torch.kernels.frontend import (  # noqa: E402
    _response_tile_min,
    front_kernel_decimate,
    pad_half,
    pad_raw,
)
from aprilgrid_tpu_torch.kernels.nms import (  # noqa: E402
    _BIGF,
    cells_to_fields,
    nms_extract_raw,
    nms_peaks_plain,
)


@pytest.mark.parametrize(
    "name,crop",
    [
        ("two_boards", (512, 1024)),  # RGB
        ("iphone", (416, 640)),       # RGB, half width 320 -> padded 384
        ("TUM_VI", (417, 513)),       # u16 gray, odd dims
    ],
)
def test_nms_extract_matches_jax_kernel(data_dir, name, crop):
    """Same occupied cells and label plane as the JAX kernel (merge=0) on
    the cells both grids cover; record planes within 1e-4 (f32 fits in two
    op orders: measured 1.5e-5)."""
    img = load_image(str(data_dir / f"{name}.png"))[: crop[0], : crop[1]]
    h, w = img.shape[:2]
    jraw, _, _, ch, u16 = jpal.pad_raw(jnp.asarray(img)[None])
    _, jhalf, jtmin = jpal.front_kernel_decimate(
        jraw, 1.5, pre_padded=True, true_shape=(h, w), channels=ch, u16=u16,
        interpret=True,
    )
    jthr = jnp.min(jtmin, axis=(1, 2, 3)) * 0.05
    jcells = np.asarray(jnms.nms_extract_raw(
        jhalf, jthr, h // 2, w // 2, channels=1, u16=False, luma_f32=True,
        interpret=True, merge=0,
    ))

    raw, _, _, ch, u16 = pad_raw(torch.from_numpy(img)[None])
    _, half_p, tmin = front_kernel_decimate(raw, 1.5, (h, w), ch, u16)
    thr = tmin.amin(-1) * 0.05
    cells = nms_extract_raw(half_p, thr, h // 2, w // 2).numpy()

    r = min(cells.shape[2], jcells.shape[2])
    c = min(cells.shape[3], jcells.shape[3])
    assert (cells[0, 5] > 0.5).sum() == (jcells[0, 5] > 0.5).sum() > 20
    np.testing.assert_array_equal(cells[0, 5, :r, :c], jcells[0, 5, :r, :c])
    np.testing.assert_allclose(cells[0, :5, :r, :c], jcells[0, :5, :r, :c],
                               rtol=0, atol=1e-4)

    jf, jn = jax.vmap(lambda x: jnms.cells_to_fields(x, 1024))(jnp.asarray(jcells))
    f, n = cells_to_fields(torch.from_numpy(cells), 1024)
    assert float(n[0]) == float(jn[0])
    ok = f[0, :, 6].numpy() > 0.5
    np.testing.assert_array_equal(ok, np.asarray(jf)[0, :, 6] > 0.5)
    np.testing.assert_allclose(f[0].numpy()[ok], np.asarray(jf)[0][ok], atol=1e-4)


def _checkerboard():
    """3-pixel checkerboard: shifts by (3, +-3) map it onto itself, so
    pixels 3 apart have bit-equal responses — exact ties inside the 7x7
    window, in chains down the whole plane."""
    h, w = 96, 128
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    return (((r // 3 + c // 3) % 2) * 0.6 + 0.2).astype(np.float32)


def test_nms_tie_break_on_equal_responses():
    """Planted equal responses: the port's peaks are the NumPy statement's
    (plateau pixels, then the scan-first plateau pixel of each window) —
    here 580 plateau pixels collapse to 20 peaks, all in the first
    candidate row."""
    plane = _checkerboard()
    h, w = plane.shape
    half_p = pad_half(torch.from_numpy(plane)[None])
    thr = _response_tile_min(half_p, 1.5, (h, w)).amin(-1) * 0.05
    cells = nms_extract_raw(half_p, thr, h, w)
    labels = np.sort(cells[0, 5][cells[0, 5] > 0.5].numpy()).astype(np.int64) - 1
    assert len(labels) == 20 and len(set(labels // w)) == 1

    # the same candidates through the NumPy two-pass NMS
    from aprilgrid_tpu_torch.ops.frontend import gaussian_blur, hessian_response
    from aprilgrid_tpu_torch.ops.rochade import fit_record, gather_patches

    blur = gaussian_blur(torch.from_numpy(plane), 1.5)
    resp = hessian_response(blur)
    margin = np.zeros((h, w), bool)
    margin[4:-4, 4:-4] = True
    ys, xs = np.nonzero((resp < thr[0]).numpy() & margin)
    ok = fit_record(gather_patches(blur, torch.from_numpy(xs), torch.from_numpy(ys)))[5].numpy()
    cand = np.zeros((h, w), bool)
    cand[ys[ok], xs[ok]] = True
    want = nms_peaks(resp.numpy(), cand, 3)
    assert cand.sum() > 20 * want.sum()  # ties really were broken
    py, px = np.nonzero(want)
    np.testing.assert_array_equal(labels, np.sort(py * w + px))


def test_nms_peaks_plain_matches_numpy_on_quantized_plane():
    """Random responses quantized to 8 levels (ties everywhere) on a
    random candidate set."""
    rng = np.random.default_rng(11)
    resp = -(rng.integers(1, 9, (70, 90)).astype(np.float32)) / 8
    cand = rng.random((70, 90)) < 0.3
    got = nms_peaks_plain(torch.from_numpy(np.where(cand, resp, np.float32(_BIGF))))
    np.testing.assert_array_equal(got.numpy(), nms_peaks(resp, cand, 3))
    assert got.sum() > 30


def test_cells_to_fields_overflow_counters():
    """More occupied cells than slots: the first capf cells in cell order
    are kept and the count says how many there were (the JAX function's
    result on the same grid)."""
    rng = np.random.default_rng(5)
    cells = np.zeros((2, 6, 48, 64), np.float32)
    occ = rng.random((2, 48, 64)) < 0.5
    occ[:, 0, 0] = occ[:, -1, -1] = False
    occ[1] &= rng.random((48, 64)) < 0.2
    cells[:, :5] = rng.normal(0, 1, (2, 5, 48, 64)) * occ[:, None]
    cells[:, 5] = np.where(occ, rng.integers(1, 10**6, (2, 48, 64)), 0)
    jf, jn = jax.vmap(lambda x: jnms.cells_to_fields(x, 1024))(jnp.asarray(cells))
    f, n = cells_to_fields(torch.from_numpy(cells), 1024)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert n[0] > 1024 > n[1] > 0
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    counts = torch.stack([n.clamp(max=1024.0), (n - 1024.0).clamp(min=0.0)], 1)
    assert counts[0].tolist() == [1024.0, float(n[0]) - 1024.0]
    assert counts[1].tolist() == [float(n[1]), 0.0]


def test_merge_is_not_ported():
    half_p = torch.zeros((1, 80, 128))
    with pytest.raises(NotImplementedError, match="merge"):
        nms_extract_raw(half_p, torch.zeros(1), 60, 100, merge=4)
