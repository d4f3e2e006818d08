"""The PyTorch port's NMS extraction (kernels/nms.py, plain version on the
CPU) held against the JAX package's Pallas kernel in interpret mode, its
NumPy statement (tools/probe_nms.py) and its ``cells_to_fields``; the
geodesic peak merge and the ``AG_NMS_MERGE`` policy likewise."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from probe_nms import merge_peaks, nms_peaks, turbo_nms_detect  # noqa: E402

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
    merge_peaks_plain,
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


@pytest.mark.parametrize("merge", [4, 8])
def test_nms_merge_matches_jax_kernel(data_dir, merge):
    """The geodesic peak merge: the same occupied cells and label plane as
    the JAX kernel with ``merge`` sweeps (its 160-row windows equal the
    global merge the port runs), records within 1e-4, and the merge took
    peaks away."""
    img = load_image(str(data_dir / "iphone.png"))[:416, :640]
    h, w = img.shape[:2]
    jraw, _, _, ch, u16 = jpal.pad_raw(jnp.asarray(img)[None])
    _, jhalf, jtmin = jpal.front_kernel_decimate(
        jraw, 1.5, pre_padded=True, true_shape=(h, w), channels=ch, u16=u16,
        interpret=True,
    )
    jthr = jnp.min(jtmin, axis=(1, 2, 3)) * 0.05
    jcells = np.asarray(jnms.nms_extract_raw(
        jhalf, jthr, h // 2, w // 2, channels=1, u16=False, luma_f32=True,
        interpret=True, merge=merge,
    ))

    raw, _, _, ch, u16 = pad_raw(torch.from_numpy(img)[None])
    _, half_p, tmin = front_kernel_decimate(raw, 1.5, (h, w), ch, u16)
    thr = tmin.amin(-1) * 0.05
    cells = nms_extract_raw(half_p, thr, h // 2, w // 2, merge=merge).numpy()
    unmerged = nms_extract_raw(half_p, thr, h // 2, w // 2).numpy()

    r = min(cells.shape[2], jcells.shape[2])
    c = min(cells.shape[3], jcells.shape[3])
    assert (cells[0, 5] > 0.5).sum() == (jcells[0, 5] > 0.5).sum() > 20
    assert (cells[0, 5] > 0.5).sum() < (unmerged[0, 5] > 0.5).sum()
    np.testing.assert_array_equal(cells[0, 5, :r, :c], jcells[0, 5, :r, :c])
    np.testing.assert_allclose(cells[0, :5, :r, :c], jcells[0, :5, :r, :c],
                               rtol=0, atol=1e-4)


def _two_blobs():
    """A relay mask of two blobs 2 pixels apart: the left one a bent
    corridor holding two peaks 9 steps apart along it, the right one a
    bar holding two peaks 3 steps apart; and a lone peak outside the mask
    between them."""
    relay = np.zeros((20, 30), bool)
    relay[3:6, 2:12] = True      # left blob: a row band ...
    relay[3:15, 9:12] = True     # ... and a column band below its right end
    relay[3:15, 14:17] = True    # right blob, 2 columns from the left one
    peaks = np.zeros_like(relay)
    peaks[4, 3] = peaks[13, 10] = True   # left blob: 9 + 7 steps apart
    peaks[5, 15] = peaks[8, 15] = True   # right blob: 3 steps apart
    peaks[10, 13] = True                 # outside the mask
    return peaks, relay


@pytest.mark.parametrize("sweeps", [1, 3, 8, 16])
def test_merge_peaks_plain_matches_probe(sweeps):
    """``merge_peaks_plain`` is the NumPy statement
    (``tools/probe_nms.py::merge_peaks``) on two blobs next to each other:
    peaks of one blob collapse onto the scan-first once the sweeps cover
    their distance along the mask, the blobs never merge, a peak outside
    the mask stays; and on random planes."""
    peaks, relay = _two_blobs()
    got = merge_peaks_plain(torch.from_numpy(peaks), torch.from_numpy(relay), sweeps).numpy()
    np.testing.assert_array_equal(got, merge_peaks(peaks, relay, sweeps))
    assert got[4, 3] and got[5, 15] and got[10, 13]
    assert got[8, 15] == (sweeps < 3)          # a key moves <= 1 px per pass
    assert got[13, 10] == (sweeps < 16)        # 16 steps along the corridor
    rng = np.random.default_rng(sweeps)
    peaks = rng.random((2, 40, 50)) < 0.08
    relay = rng.random((2, 40, 50)) < 0.6
    got = merge_peaks_plain(torch.from_numpy(peaks), torch.from_numpy(relay), sweeps).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], merge_peaks(peaks[i], relay[i], sweeps))


@pytest.mark.parametrize("merge", [-1, 9])
def test_merge_outside_0_to_8_raises(merge):
    half_p = torch.zeros((1, 80, 128))
    with pytest.raises(ValueError, match="merge"):
        nms_extract_raw(half_p, torch.zeros(1), 60, 100, merge=merge)


@pytest.mark.parametrize("value", [None, "", "0", "4", "8", "12", "-1"])
def test_nms_merge_policy_matches_jax(monkeypatch, value):
    """``AG_NMS_MERGE`` resolves as the JAX pipeline resolves it: default
    0, clamped to 0-8, and an empty value is an error in both."""
    from aprilgrid_tpu import pipeline as jpipe
    from aprilgrid_tpu_torch import pipeline as tpipe

    if value is None:
        monkeypatch.delenv("AG_NMS_MERGE", raising=False)
    else:
        monkeypatch.setenv("AG_NMS_MERGE", value)
    if value == "":
        with pytest.raises(ValueError):
            jpipe._nms_merge()
        with pytest.raises(ValueError):
            tpipe._nms_merge()
        return
    assert tpipe._nms_merge() == jpipe._nms_merge() == {
        None: 0, "0": 0, "4": 4, "8": 8, "12": 8, "-1": 0}[value]


def test_turbo_nms_merge_detect_matches_jax(data_dir, monkeypatch):
    """``AG_NMS_MERGE=8`` on the turbo NMS path (EuRoC, the smallest
    golden whose peaks merge: 333 -> 313 at half resolution): the tag IDs
    of the JAX package's merged NMS detect (its NumPy statement,
    ``tools/probe_nms.py::turbo_nms_detect`` with 8 sweeps) and corners
    within 0.1 px of it; the merge ran on the port's path."""
    from aprilgrid_tpu.config import DEFAULT_PARAMS as JPARAMS
    from aprilgrid_tpu_torch import TagDetector
    from aprilgrid_tpu_torch import pipeline as tpipe

    img = load_image(str(data_dir / "EuRoC.png"))
    want = turbo_nms_detect(img, 3, JPARAMS, {"merge_sweeps": 8})
    monkeypatch.setenv("AG_TURBO_NMS", "1")
    monkeypatch.setenv("AG_NMS_MERGE", "8")
    merges = []
    real = tpipe.nms_extract_raw
    monkeypatch.setattr(tpipe, "nms_extract_raw",
                        lambda *a, **kw: merges.append(kw["merge"]) or real(*a, **kw))
    got = TagDetector("t36h11", device="cpu", decimate=True).detect(img)
    assert merges == [8]
    assert len(want) > 25 and set(got) == set(want)
    for tid, corners in want.items():
        err = np.abs(np.asarray(corners) - np.asarray(got[tid])).max()
        assert err < 0.1, (tid, err)


@pytest.mark.parametrize("merge", [0, 8])
def test_nms_row_off_matches_jax(data_dir, merge):
    """The row-sharding mode (no caller in the JAX package; held by its
    checks) on the turbo path's half planes of a frame cut into two bands,
    window 0 starting 48 half rows above the frame: on the cell rows of
    each window's band, the same occupied cells and labels (the frame's
    scan order) as the JAX kernel in interpret mode on the same planes, y
    in the frame's rows, records within 1e-4."""
    from aprilgrid_tpu_torch.parallel.sharding import CTX, row_windows

    img = load_image(str(data_dir / "EuRoC.png"))[:, :384]
    wins, roff, local_h, gh = row_windows(torch.from_numpy(img), 2, turbo=True)
    w = img.shape[1]
    _, half_p, tmin = front_kernel_decimate(wins, 1.5, (local_h, w), 1, False,
                                            row_off=roff, global_h=gh)
    h, wh = local_h // 2, w // 2
    thr = tmin.amin().expand(2) * 0.05
    cells = nms_extract_raw(half_p, thr, h, wh, merge=merge, row_off=roff,
                            global_h=gh).numpy()
    jcells = np.asarray(jnms.nms_extract_raw(
        jnp.asarray(half_p.numpy()), jnp.asarray(thr.numpy()), h, wh, channels=1,
        u16=False, luma_f32=True, interpret=True, merge=merge,
        row_off=jnp.asarray(roff.numpy()), global_h=gh,
    ))
    band = slice(CTX // 4, (CTX + gh // 2) // 4)
    got, want = cells[:, :, band], jcells[:, :, band, : cells.shape[3]]
    assert (got[:, 5] > 0.5).sum() > 40
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    np.testing.assert_allclose(got[:, :5], want[:, :5], rtol=0, atol=1e-4)
    lab = got[1, 5][got[1, 5] > 0.5].astype(np.int64) - 1
    assert lab.min() // wh >= int(roff[1]) + CTX   # window 1's band, in frame rows


# -- the premise of the kernel's record gate: the fit as stencils of a tile


def _blur_plane(data_dir, case):
    """A small f32 blur plane: a photograph's crop, a rendered scene's, or
    random values (no structure at all)."""
    from conftest import make_stress_scene

    from aprilgrid_tpu_torch.ops.frontend import gaussian_blur
    from aprilgrid_tpu_torch.ops.gray import to_luma

    if case == "random":
        rng = np.random.default_rng(7)
        return torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    if case == "EuRoC":
        img = load_image(str(data_dir / "EuRoC.png"))[100:228, 200:456]
    else:
        img = make_stress_scene(2, kind=case)[300:428, 250:506]
    return gaussian_blur(to_luma(torch.from_numpy(np.ascontiguousarray(img)))[0], 1.5)


@pytest.mark.parametrize("case", ["EuRoC", "u8", "u16", "rgb", "random"])
def test_record_planes_bit_equal_to_fit_record(data_dir, case):
    """The fit does not depend on where its pixel is: evaluated as
    stencils of the whole plane (``record_planes``: one smoothed plane, a
    column stencil per vertical factor, a row stencil per coefficient) it
    equals ``fit_record`` on the gathered 9x9 patch of every pixel at
    least 4 from the edge, bit for bit, accepted or not."""
    from aprilgrid_tpu_torch.ops.rochade import fit_record, gather_patches, record_planes

    blur = _blur_plane(data_dir, case)
    h, w = blur.shape
    ys, xs = torch.meshgrid(torch.arange(4, h - 4), torch.arange(4, w - 4), indexing="ij")
    want = fit_record(gather_patches(blur, xs.reshape(-1), ys.reshape(-1)))
    got = record_planes(blur)
    for g, e in zip(got, want):
        assert g.shape == (h - 8, w - 8)
        # NaN == NaN here: an exactly flat patch divides 0 by 1, never NaN
        assert torch.equal(g.reshape(-1), e)
    assert got[5].sum() > (0 if case == "random" else 50)


@pytest.mark.parametrize("case", ["EuRoC", "u8"])
def test_record_planes_matches_jax_record_planes(data_dir, case):
    """Against the JAX kernels' dense record (``_record_planes``, compiled
    for the CPU: its rolls wrap at the window edge, so interior pixels
    only). The compiled chain contracts multiply-adds: c3..c5 agree to 4e-6
    of the coefficient scale (measured 1.6e-6), the accept bit on all but
    1 % of the accepted pixels (2 of 980: fits on the gate's edge), and the
    offsets, a quotient that is ill-conditioned near a zero determinant,
    to 1e-4 px on half and 1e-3 px on nine tenths of the pixels both
    accept (measured 1.2e-4 at the ninth decile)."""
    from aprilgrid_tpu.pallas.cluster import _record_planes

    from aprilgrid_tpu_torch.ops.rochade import record_planes

    blur = _blur_plane(data_dir, case)
    h, w = blur.shape
    got = [g.numpy() for g in record_planes(blur)]
    jrec = jax.jit(lambda x: _record_planes(x, h, w, 4, 1.0))(jnp.asarray(blur.numpy()))
    jrec = [np.asarray(x)[4:-4, 4:-4] for x in jrec]
    scale = max(np.abs(got[k]).max() for k in (2, 3, 4))
    for k in (2, 3, 4):
        np.testing.assert_allclose(got[k], jrec[k], rtol=0, atol=4e-6 * scale)
    ok, jok = got[5], jrec[5].astype(bool)
    assert ok.sum() > 50 and (ok != jok).sum() <= 0.01 * ok.sum()
    both = ok & jok
    for k in (0, 1):
        err = np.abs(got[k] - jrec[k])[both]
        assert np.median(err) < 1e-4 and np.quantile(err, 0.9) < 1e-3


# -- the merge kernel's blocks (csrc/nms.cu::merge_kernel) as a numpy walk

_ME = 64 + 2 * 8   # staged side: the tile and the 8-pixel halo
_MP = _ME + 2      # with the ring that holds no key
_NOKEY = 0xFFFF


def _merge_block_model(peaks, relay, merge):
    """``merge_kernel`` on (h, w) bool planes (multiples of 64), block by
    block: each tile that holds a peak (the kernel's flag is a candidate;
    a tile without a peak emits nothing) stages its 80 x 80 region, where
    outside the plane is neither relay nor peak, in a position plane with
    a ring; its relay pixels are the entries ``key << 16 | position`` that
    the threads hold (at most 25 each); each pass reads the neighbour's key
    from one key plane, takes the word's min, and writes every entry's key
    into the other plane; a sweep that moves no key ends the walk. Returns the tiles' surviving peaks (key still
    their own) and the sweeps each tile ran."""
    h, w = peaks.shape
    out = np.zeros_like(peaks)
    ran = {}
    grid = np.arange(_MP * _MP, dtype=np.int64).reshape(_MP, _MP)[1:-1, 1:-1]
    for ti in range(h // 64):
        for si in range(w // 64):
            if not peaks[ti * 64 : ti * 64 + 64, si * 64 : si * 64 + 64].any():
                continue
            r0, c0 = ti * 64 - 8, si * 64 - 8
            ya, yb, xa, xb = max(r0, 0), min(r0 + _ME, h), max(c0, 0), min(c0 + _ME, w)
            rel = np.zeros((_ME, _ME), bool)
            pk = np.zeros((_ME, _ME), bool)
            rel[ya - r0 : yb - r0, xa - c0 : xb - c0] = relay[ya:yb, xa:xb]
            pk[ya - r0 : yb - r0, xa - c0 : xb - c0] = peaks[ya:yb, xa:xb]
            assert not (pk & ~rel).any()   # every peak is a relay pixel
            key0 = np.full(_MP * _MP, _NOKEY, np.int64)
            key0[grid[pk]] = grid[pk]
            keys = [key0, key0.copy()]
            p = grid[rel]
            assert len(p) <= 25 * 256
            e = keys[0][p] << 16 | p
            sweeps = 0
            while sweeps < merge:
                sweeps += 1
                moved = False
                for d, off in enumerate((1, -1, _MP, -_MP)):
                    src, dst = keys[d & 1], keys[(d + 1) & 1]
                    v = np.minimum(e, src[p + off] << 16 | p)
                    moved |= bool((v != e).any())
                    e = v
                    dst[p] = e >> 16
                if not moved:
                    break
            ran[(ti, si)] = sweeps
            y, x = p // _MP - 1, p % _MP - 1
            own = (e >> 16 == p) & (y >= 8) & (y < 72) & (x >= 8) & (x < 72)
            out[r0 + y[own], c0 + x[own]] = True
    return out, ran


def _golden_peaks_relay(data_dir, name, crop):
    """The half plane's peaks (the plain NMS's cells at m0) and relay mask
    (``nms_extract_raw_plain``'s ``mask``) of a golden image's crop, on the
    padded plane."""
    from aprilgrid_tpu_torch.ops.frontend import gaussian_blur, hessian_response

    img = load_image(str(data_dir / f"{name}.png"))[: crop[0], : crop[1]]
    h, w = img.shape[:2]
    raw, _, _, ch, u16 = pad_raw(torch.from_numpy(img)[None])
    _, half_p, tmin = front_kernel_decimate(raw, 1.5, (h, w), ch, u16)
    thr = tmin.amin(-1) * 0.05
    hh, wh = h // 2, w // 2
    cells = nms_extract_raw(half_p, thr, hh, wh)
    lab = cells[0, 5][cells[0, 5] > 0.5].to(torch.int64) - 1
    peaks = np.zeros((half_p.shape[1] - 16, half_p.shape[2]), bool)
    peaks[lab // wh, lab % wh] = True
    resp = hessian_response(gaussian_blur(half_p[0, :, :wh], 1.5)[8 : 8 + hh])
    relay = np.zeros_like(peaks)
    relay[1 : hh - 1, 1 : wh - 1] = (resp < thr[0]).numpy()[1:-1, 1:-1]
    return peaks, relay


@pytest.fixture(scope="module")
def one_thread():
    """The plain merge runs many small operations: one intra-op thread
    keeps them from spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", ["EuRoC", "two_boards", "reach8", "corner", "ring",
                                  "edge", "fixed8"])
def test_merge_block_model_equals_plain(data_dir, one_thread, case):
    """The merge kernel's block walk (``_merge_block_model``) equals
    ``merge_peaks_plain`` bit for bit at every m in 1-8: on a golden's
    half-plane peaks and relay (EuRoC whole, a 1080p crop of two_boards)
    and on the smoke's synthetic merge planes, which hold keys that travel
    exactly the halo into a neighbouring tile, through a tile corner,
    around a ring, along the plane's edges, and chains whose fixed point
    comes at sweep 8, 7 and later. The peaks that merge away and the
    sweeps the tiles ran show that the planes do what they are built for."""
    import chip_smoke

    if case in ("EuRoC", "two_boards"):
        peaks, relay = _golden_peaks_relay(data_dir, case, (512, 1024))
    else:
        names, sp, sr = chip_smoke.merge_synthetic_planes()
        assert names == ("reach8", "corner", "ring", "edge", "fixed8")
        peaks, relay = sp[names.index(case)], sr[names.index(case)]
    left, ran = [], {}
    for m in range(1, 9):
        got, ran[m] = _merge_block_model(peaks, relay, m)
        want = merge_peaks_plain(torch.from_numpy(peaks), torch.from_numpy(relay), m)
        np.testing.assert_array_equal(got, want.numpy())
        left.append(int(got.sum()))
    if case in ("EuRoC", "two_boards"):
        assert left[-1] < left[0] <= peaks.sum()
        assert max(ran[8].values()) == 8 and min(ran[8].values()) < 8
    elif case == "fixed8":
        assert left == [4] * 8
        assert ran[8] == {(0, 2): 8, (1, 0): 8, (1, 2): 8, (2, 0): 5}
        assert ran[4] == {(0, 2): 4, (1, 0): 4, (1, 2): 4, (2, 0): 4}
    else:
        want = {"reach8": [7] * 7 + [3], "corner": [4] * 7 + [2],
                "ring": [4] * 6 + [2, 2], "edge": [8] * 4 + [7, 6, 5, 4]}[case]
        assert left == want


# -- launch (a) of the kernel (csrc/nms.cu::blur_resp_kernel) as a numpy walk
#
# The kernel's blocks stage the f32 half plane and blur it as the front and
# cluster kernels' blocks do (the passes of csrc/tile.cuh, modelled in
# tile_model.py), then walk the Hessian rows in the same thread layout: the
# response where it is below thr inside the margin (the window's rows, the
# frame's rows, the columns), else BIGF, the tests only in border blocks;
# the relay bits from a warp's four ballots a row step, interleaved per
# octet of lanes into the word of its 32 columns; the tile's flag. The
# model's planes must be the plain version's.


def _blur_resp_model(half_p, h, w, thr, hp2=4, ro=None, gh=None, aligned=True):
    """(blur (B, Hp, Wp), cand (B, Hp, Wp), relay words (B, Hp, Wp / 32),
    flags (B, Hp / 64, Wp / 64)) as launch (a)'s blocks compute them from a
    ``pad_half`` plane (B, Hp + 16, Wp) f32."""
    from aprilgrid_tpu_torch.ops.frontend import gaussian_kernel
    from tile_model import RRUN, T, hessian_rows, stage_model, stencil_model

    lum, _ = stage_model(half_p, 1, False, w, aligned)
    b, n_t, n_s = lum.shape[:3]
    hp = n_t * T
    blurred, _ = stencil_model(lum, (h, w), gaussian_kernel(1.5))
    v = hessian_rows(blurred)                                     # (B, T, S, 64, 64)

    ro = np.zeros(b, np.int64) if ro is None else np.asarray(ro, np.int64)
    gh = h if gh is None else gh
    rr = (T * np.arange(n_t)[:, None] + np.arange(T))[None, :, None, :, None]
    cc = (T * np.arange(n_s)[:, None] + np.arange(T))[None, None, :, None, :]
    g = rr + ro[:, None, None, None, None]
    margin = ((rr >= hp2) & (rr < h - hp2) & (g >= hp2) & (g < gh - hp2)
              & (cc >= hp2) & (cc < w - hp2))
    inner = (rr > 0) & (rr < h - 1) & (g > 0) & (g < gh - 1) & (cc > 0) & (cc < w - 1)
    # a block that holds no pixel outside the margin, in a frame that is no
    # window of a taller one, tests the response alone
    ti, si = np.arange(n_t)[:, None], np.arange(n_s)[None, :]
    border = (((ti * T < hp2) | ((ti + 1) * T > h - hp2) | (si * T < hp2)
               | ((si + 1) * T > w - hp2))[None]
              | (ro != 0)[:, None, None] | (gh != h))[..., None, None]   # (B, T, S, 1, 1)
    assert (margin | border).all()
    below = v < np.asarray(thr, np.float32)[:, None, None, None, None]
    m = np.where(border, margin & below, below)
    rel = np.where(border, inner & below, below)

    # warp k, lane l = 16 half + q: rows 8k + 4 half + r, columns 4q + j;
    # ballot (r, j) holds pixel j of row step r of every lane, and lane l's
    # octet word has pixel j of lane l at bit 4 (l % 8) + j
    mw = rel.reshape(b, n_t, n_s, 8, 2, RRUN, 16, 4).transpose(0, 1, 2, 3, 5, 7, 4, 6)
    mw = mw.reshape(b, n_t, n_s, 8, RRUN, 4, 32)
    lane = np.arange(32, dtype=np.uint64)
    bal = (mw.astype(np.uint64) << lane).sum(-1)                  # (..., r, j)
    x = (bal[..., None] >> (lane & np.uint64(24))) & np.uint64(0xFF)  # (..., r, j, lane)
    for shift, keep in ((12, 0x000F000F), (6, 0x03030303), (3, 0x11111111)):
        x = (x | (x << np.uint64(shift))) & np.uint64(keep)
    seg = np.bitwise_or.reduce(x << np.arange(4, dtype=np.uint64)[:, None], axis=-2)
    # the first lane of each octet stores its word: lanes 0 and 8 the two
    # words of row group 0's rows, lanes 16 and 24 those of row group 1
    words = seg[..., ::8].reshape(b, n_t, n_s, 8, RRUN, 2, 2).transpose(0, 1, 2, 3, 5, 4, 6)
    words = words.reshape(b, n_t, n_s, T, 2)

    def plane(a):
        return a.transpose(0, 1, 3, 2, 4).reshape(b, hp, -1)

    cand = np.where(m, v, np.float32(_BIGF))
    return (plane(blurred[..., 1:65, 1:65]), plane(cand), plane(words).astype(np.uint32),
            m.any((-2, -1)))


def _blur_resp_case(data_dir, case):
    """(half_p, h, w, row_off, global_h) of a case of the model test."""
    import chip_smoke
    from aprilgrid_tpu_torch.kernels.frontend import front_kernel_decimate_plain

    if case == "synthetic":
        _, planes, _ = chip_smoke.synthetic_blur_planes()
        return pad_half(torch.from_numpy(planes)), *planes.shape[1:], None, None
    if case == "row_off":
        from aprilgrid_tpu_torch.parallel.sharding import row_windows

        img = load_image(str(data_dir / "EuRoC.png"))[:, :384]
        wins, roff, local_h, gh = row_windows(torch.from_numpy(img), 2, turbo=True)
        _, half_p, _ = front_kernel_decimate_plain(wins, 1.5, (local_h, 384), 1, False,
                                                   row_off=roff, global_h=gh)
        assert roff[0] < 0 < roff[1]
        return half_p, local_h // 2, 192, roff, gh
    # two_boards: a crop whose half plane ends 2 rows and 2 columns past a
    # multiple of 64, so that the last tile and strip hold margin pixels
    crop = {"EuRoC": (480, 752), "two_boards": (388, 644)}[case]
    img = load_image(str(data_dir / f"{case}.png"))[: crop[0], : crop[1]]
    raw, _, _, ch, u16 = pad_raw(torch.from_numpy(np.ascontiguousarray(img))[None])
    _, half_p, _ = front_kernel_decimate_plain(raw, 1.5, crop, ch, u16)
    return half_p, crop[0] // 2, crop[1] // 2, None, None


@pytest.mark.parametrize("mask", [False, True], ids=["m0", "merge"])
@pytest.mark.parametrize("case", ["EuRoC", "two_boards", "synthetic", "row_off"])
def test_blur_resp_model_equals_plain(data_dir, one_thread, case, mask):
    """Launch (a)'s block walk (``_blur_resp_model``) equals the plain
    version's planes before the fit (``nms_planes_plain``) bit for bit: the
    blur, the candidate plane (the response where it is below thr in the
    margin, else BIGF), the tiles' flags and, for the merge's launch
    (``mask``), the relay words; on EuRoC's half plane, a two_boards crop's,
    the smoke's synthetic planes (250 x 380, also staged as from an
    unaligned pointer) and the half-plane windows of a frame cut into two
    bands. The threshold masks about a quarter of each plane's pixels."""
    from aprilgrid_tpu_torch.kernels.nms import nms_planes_plain

    half_p, h, w, roff, gh = _blur_resp_case(data_dir, case)
    bsz, hp, wp = half_p.shape[0], half_p.shape[1] - 16, half_p.shape[2]
    resp = nms_planes_plain(half_p, torch.zeros(bsz), h, w, 1.5, 4, roff, gh)[1]
    thr = torch.stack([torch.quantile(r[1:-1, 1:-1], 0.25) for r in resp])
    blur, resp, relay, margin = nms_planes_plain(half_p, thr, h, w, 1.5, 4, roff, gh)
    want = np.full((bsz, hp, wp), np.float32(_BIGF))
    want[:, :h, :w] = torch.where(relay & margin, resp, _BIGF).numpy()
    assert 0.05 < (want < _BIGF).sum() / (bsz * h * w) < 0.3
    bits = np.zeros((bsz, hp, wp), np.uint64)
    bits[:, :h, :w] = relay.numpy()
    words = (bits.reshape(bsz, hp, wp // 32, 32) << np.arange(32, dtype=np.uint64)).sum(-1)
    flags = (want < _BIGF).reshape(bsz, hp // 64, 64, wp // 64, 64).any((2, 4))
    ro = None if roff is None else roff.tolist()
    for aligned in (True, False) if case == "synthetic" else (True,):
        mblur, mcand, mwords, mflags = _blur_resp_model(half_p.numpy(), h, w, thr.numpy(),
                                                        4, ro, gh, aligned)
        np.testing.assert_array_equal(mblur[:, :h, :w], blur.numpy())
        np.testing.assert_array_equal(mcand, want)
        np.testing.assert_array_equal(mflags, flags)
        if mask:
            np.testing.assert_array_equal(mwords, words.astype(np.uint32))
