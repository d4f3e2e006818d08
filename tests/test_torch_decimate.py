"""The PyTorch port's turbo path (``decimate=True/"auto"``; plain versions
on the CPU) held against the JAX package: the decimating front kernel and
the cluster kernel's f32-luma mode against the Pallas kernels in interpret
mode and the ops chain, the turbo front-end as a whole against
``_pallas_decimated_frontend_batch(interpret=True)``, and the detector
against the oracle and the JAX turbo detector."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aprilgrid_tpu import pipeline as jpipe
from aprilgrid_tpu.config import CONSTANTS as JCONSTS
from aprilgrid_tpu.config import DEFAULT_CAPACITIES as JCAPS
from aprilgrid_tpu.config import DEFAULT_PARAMS as JPARAMS
from aprilgrid_tpu.detector import TagDetector as JaxDetector
from aprilgrid_tpu.oracle import numpy_ref as R
from aprilgrid_tpu.ops import frontend as jfront
from aprilgrid_tpu.ops.gray import to_luma as j_luma
from aprilgrid_tpu.pallas import cluster as jpcl
from aprilgrid_tpu.pallas import frontend as jpal
from aprilgrid_tpu_torch import TagDetector
from aprilgrid_tpu_torch import detector as tdetector
from aprilgrid_tpu_torch import pipeline as tpipe
from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
from aprilgrid_tpu_torch.kernels.cluster import cluster_rochade_raw
from aprilgrid_tpu_torch.kernels.frontend import front_kernel_decimate, pad_raw
from aprilgrid_tpu_torch.ops.frontend import decimate2
from conftest import GOLDEN_COUNTS

CROPS = {
    "iphone": ("iphone", (416, 640), False),       # RGB, even dims
    "tum_odd": ("TUM_VI", (417, 513), False),      # u16 gray, odd dims
    "tum_385": ("TUM_VI", (385, 512), False),      # h = 1 mod 128
    "euroc_u16": ("EuRoC", (416, 512), True),      # u8 gray x 257 -> u16
    "two_boards": ("two_boards", (512, 1024), False),
}


def _crop(data_dir, key):
    name, (h, w), x257 = CROPS[key]
    img = R.load_image(str(data_dir / f"{name}.png"))[:h, :w]
    return img.astype(np.uint16) * 257 if x257 else img


def _jax_front(img):
    h, w = img.shape[:2]
    jraw, _, _, ch, u16 = jpal.pad_raw(jnp.asarray(img)[None])
    return jpal.front_kernel_decimate(
        jraw, 1.5, pre_padded=True, true_shape=(h, w), channels=ch, u16=u16,
        interpret=True,
    )


def _torch_front(img):
    h, w = img.shape[:2]
    raw, _, _, ch, u16 = pad_raw(torch.from_numpy(img)[None])
    return front_kernel_decimate(raw, 1.5, (h, w), ch, u16)


def test_decimate2_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.random((2, 37, 53)).astype(np.float32)
    got = decimate2(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 18, 26)
    for i in range(2):
        np.testing.assert_array_equal(got[i], np.asarray(jpipe._decimate2(jnp.asarray(x[i]))))


@pytest.mark.parametrize("key", ["iphone", "tum_odd", "tum_385", "euroc_u16"])
def test_front_kernel_decimate_matches_jax(data_dir, key):
    """luma8 equal to the JAX kernel's. Half plane: for gray input
    bit-equal to the JAX ops chain ``_decimate2(to_luma(img))`` on the
    true region; against the compiled JAX kernel within 1.2e-7 (its
    reciprocal divides are an ulp off on some pixels; RGB, whose luma is a
    multiply-add chain in both, measured 0), padding included. Global
    minimum: within 2e-6 relative of the compiled JAX kernel (the gap
    tests/test_torch_frontend.py documents), bit-equal to the op-by-op
    JAX blur + response of the same half plane."""
    img = _crop(data_dir, key)
    h, w = img.shape[:2]
    hh, wh = h // 2, w // 2
    jl8, jhalf, jtmin = (np.asarray(a) for a in _jax_front(img))
    l8, half_p, tmin = _torch_front(img)
    np.testing.assert_array_equal(l8.numpy(), jl8)
    half = half_p.numpy()[0]
    assert half.shape == (-(-hh // 64) * 64 + 16, -(-wh // 128) * 128)
    if img.ndim == 2:
        ref = np.asarray(jpipe._decimate2(j_luma(jnp.asarray(img))[0]))
        np.testing.assert_array_equal(half[8 : 8 + hh, :wh], ref)
    rows = min(half.shape[0], jhalf.shape[1])
    np.testing.assert_allclose(half[:rows], jhalf[0, :rows], rtol=0, atol=1.2e-7)
    # the padding replicates the half plane's own edges
    np.testing.assert_array_equal(half[:8], np.broadcast_to(half[8], (8, half.shape[1])))
    np.testing.assert_array_equal(half[8 + hh :], np.broadcast_to(half[7 + hh], half[8 + hh :].shape))
    np.testing.assert_array_equal(half[:, wh:], np.broadcast_to(half[:, wh - 1 : wh], half[:, wh:].shape))
    gmin = float(tmin.min())
    np.testing.assert_allclose(gmin, float(jtmin.min()), rtol=2e-6)
    resp = jfront.hessian_response(
        jfront.gaussian_blur(jnp.asarray(half[8 : 8 + hh, :wh]), 1.5))
    assert gmin == float(jnp.min(resp))


# ---- the CUDA kernel's block walk (csrc/frontend.cu::front_decimate_kernel)
#
# A numpy model of how the one launch covers its three outputs: blocks over
# the half grid or, where it is taller or wider, the luma8 grid; each half
# tile staged from raw quads of 2 x 8 pixels (half coordinates clamped per
# element only where a quad leaves the half plane or the frame is
# unaligned), the 2x2 mean in its association; luma8 of the block's own
# unclamped half quads from the staged bytes and of everything else it owns
# (rows at and beyond 2 * (h // 2), quads that reach w // 2, blocks beyond
# the half grid, an unaligned frame) from the padded raw rows; half_p's own
# pixels and replica rows. Every output element must be written exactly
# once, and the whole must equal front_kernel_decimate_plain bit for bit.

# (h, w): luma8 grid taller and wider than twice the half grid; odd height
# and width; tile-aligned
_DECIMATE_SHAPES = [(129, 257), (37, 50), (256, 512)]


def _decimate_model(raw, channels, u16, true_shape, taps, aligned=True):
    """(luma8 (B, Hp, Wp), half_p (B, Hhp+16, Whp), tile_min (B, Hhp/64))
    as the kernel's blocks compute them."""
    from tile_model import T as _T, luma_model, stencil_model

    h, w = true_shape
    hh, wh = h // 2, w // 2
    b, rows, row_elems = raw.shape
    hp, wp = rows - 16, row_elems // channels
    hhp, whp = -(-hh // _T) * _T, -(-wh // 128) * 128
    n_ht, n_hs = hhp // _T, whp // _T
    n_t, n_s = max(n_ht, -(-hp // (2 * _T))), max(n_hs, wp // (2 * _T))
    lf, l8 = luma_model(raw.reshape(b, rows, wp, channels), channels, u16)

    # staging: staged row y = half row clamp(64 ti - 4 + y); quad k = half
    # columns 64 si - 4 + 4k .. +3, raw columns 2x, 2x + 1 of each
    yu = _T * np.arange(n_ht)[:, None] - 4 + np.arange(72)[None, :]      # (T, 72)
    yr = np.clip(yu, 0, hh - 1)
    xq = _T * np.arange(n_hs)[:, None] - 4 + 4 * np.arange(18)[None, :]  # (S, 18)
    vec = aligned & (xq >= 0) & (xq + 3 < wh)
    x = xq[..., None] + np.arange(4)                                     # (S, 18, 4)
    xc = np.where(vec[..., None], x, np.clip(x, 0, wh - 1))
    assert xc.min() >= 0 and 2 * xc.max() + 1 < w     # every quad reads the image
    r0 = (2 * yr + 8)[None, :, None, :, None, None]
    c0 = (2 * xc)[None, None, :, None, :, :]
    four = [lf[np.arange(b)[:, None, None, None, None, None], r0 + dr, c0 + dc]
            for dr in (0, 1) for dc in (0, 1)]
    lum = ((four[0] + four[1]) + (four[2] + four[3])) * np.float32(0.25)
    lum = lum.reshape(b, n_ht, n_hs, 72, 72)

    half_p = np.zeros((b, hhp + 16, whp), np.float32)
    n_half = np.zeros(half_p.shape[1:], int)
    for ti in range(n_ht):
        for si in range(n_hs):
            rows_, cols = slice(8 + _T * ti, 8 + _T * ti + _T), slice(_T * si, _T * si + _T)
            half_p[:, rows_, cols] = lum[:, ti, si, 4:68, 4:68]
            n_half[rows_, cols] += 1
            if ti == 0:                           # replicas of half row 0
                half_p[:, :8, cols] = lum[:, ti, si, None, 0, 4:68]
                n_half[:8, cols] += 1
            if ti == n_ht - 1:                    # replicas of half row hh - 1
                half_p[:, hhp + 8 :, cols] = lum[:, ti, si, None, 71, 4:68]
                n_half[hhp + 8 :, cols] += 1
    assert (n_half == 1).all()

    # luma8: each block's own half quads (64 rows x 16), 2 raw rows x 8 raw
    # columns each, the staged bytes where the quad is unclamped, the padded
    # raw rows as they stand otherwise
    luma8 = np.zeros((b, hp, wp), np.uint8)
    n8 = np.zeros((hp, wp), int)
    for ti in range(n_t):
        for si in range(n_s):
            for yh in range(_T * ti, _T * ti + _T):
                for xh in range(_T * si, _T * si + _T, 4):
                    r, c = 2 * yh, 2 * xh
                    if r >= hp or c >= wp:
                        continue
                    staged = (aligned and ti < n_ht and si < n_hs and yh < hh
                              and xh + 3 < wh)
                    assert not staged or (yr[ti, yh - _T * ti + 4] == yh
                                          and (xc[si, (xh - _T * si) // 4 + 1] == xh + np.arange(4)).all())
                    luma8[:, r : r + 2, c : c + 8] = l8[:, r + 8 : r + 10, c : c + 8]
                    n8[r : r + 2, c : c + 8] += 1
    assert (n8 == 1).all()

    _, strip_min = stencil_model(lum, (hh, wh), taps)
    return luma8, half_p, strip_min.min(-1)


@pytest.mark.parametrize("shape", _DECIMATE_SHAPES)
@pytest.mark.parametrize("mode", ["u8", "u16", "rgb"])
def test_decimate_model_equals_plain(mode, shape):
    """On frames of the kind the smoke holds the kernel to on the card."""
    import chip_smoke
    from aprilgrid_tpu_torch.kernels.frontend import front_kernel_decimate_plain
    from aprilgrid_tpu_torch.ops.frontend import gaussian_kernel

    assert set(_DECIMATE_SHAPES[:2]) <= set(chip_smoke.FRONT_SHAPES)
    h, w = shape
    img = chip_smoke.synthetic_raw_frames(mode, h, w, 2, seed=h + w)
    raw, _, _, ch, u16 = pad_raw(torch.from_numpy(img))
    raw_np = raw.view(torch.int16).numpy().view(np.uint16) if u16 else raw.numpy()
    want = front_kernel_decimate_plain(raw, 1.5, shape, ch, u16)
    for aligned in (True, False) if shape == _DECIMATE_SHAPES[0] else (True,):
        got = _decimate_model(raw_np, ch, u16, shape, gaussian_kernel(1.5), aligned)
        for g, p in zip(got, want):
            np.testing.assert_array_equal(g, p.numpy())


@pytest.mark.parametrize("prefilter", [True, False])
@pytest.mark.parametrize("key", ["iphone", "euroc_u16"])
def test_cluster_luma_f32_matches_jax(data_dir, key, prefilter):
    """The drain variant's cluster kernel on the half plane against the
    JAX kernel's turbo settings (``win=160``) with and without its blob
    pre-filter, which the port leaves out: same accepted label set, x/y
    within 1e-4 px."""
    img = _crop(data_dir, key)
    h, w = img.shape[:2]
    _, jhalf, jtmin = _jax_front(img)
    jthr = jnp.min(jtmin, axis=(1, 2, 3)) * JCONSTS.response_threshold_ratio
    jf, jc = jpcl.cluster_rochade_raw(
        jhalf, jthr, h // 2, w // 2, channels=1, u16=False, luma_f32=True,
        prefilter=prefilter, win=160, interpret=True,
    )
    _, half_p, tmin = _torch_front(img)
    thr = tmin.amin(-1) * CONSTANTS.response_threshold_ratio
    f, c = cluster_rochade_raw(half_p, thr, h // 2, w // 2, luma_f32=True)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc)[:, :2])
    f, jf = f[0].numpy(), np.asarray(jf)[0]
    f, jf = f[f[:, 6] > 0.5], jf[jf[:, 6] > 0.5]
    f, jf = f[np.argsort(f[:, 7])], jf[np.argsort(jf[:, 7])]
    assert len(f) > 25
    np.testing.assert_array_equal(f[:, 7], jf[:, 7])
    np.testing.assert_allclose(f[:, :2], jf[:, :2], rtol=0, atol=1e-4)


def test_cluster_luma_f32_checks_the_layout():
    thr = torch.zeros(1)
    with pytest.raises(TypeError, match="f32 luma plane"):
        cluster_rochade_raw(torch.zeros((1, 80, 128), dtype=torch.uint8), thr,
                            60, 100, luma_f32=True)
    with pytest.raises(TypeError, match="f32 luma plane"):
        cluster_rochade_raw(torch.zeros((1, 80, 128)), thr, 60, 100,
                            channels=3, luma_f32=True)
    with pytest.raises(TypeError, match="dtype"):
        cluster_rochade_raw(torch.zeros((1, 80, 128)), thr, 60, 100)


@pytest.mark.parametrize("nms", [True, False], ids=["nms", "drain"])
@pytest.mark.parametrize("key", ["iphone", "tum_odd", "two_boards"])
def test_decimated_frontend_matches_jax(data_dir, key, nms):
    """The whole turbo front-end, both extraction variants: same count of
    valid saddles, sorted positions within 1e-3 px, luma8 and counters
    equal."""
    img = _crop(data_dir, key)
    h, w = img.shape[:2]
    js, jl8, jcnt = jpipe._pallas_decimated_frontend_batch(
        jnp.asarray(img)[None], JPARAMS, JCONSTS, JCAPS, with_counters=True,
        nms=nms, interpret=True,
    )
    ts, l8, cnt = tpipe.saddle_frontend_batch(
        torch.from_numpy(img)[None], DEFAULT_PARAMS, CONSTANTS,
        DEFAULT_CAPACITIES, decimate=True, nms=nms,
    )
    jv, tv = np.asarray(js.valid[0]), ts.valid[0].numpy()
    assert jv.sum() == tv.sum() > 10
    jp, tp = np.asarray(js.p[0])[jv], ts.p[0].numpy()[tv]
    np.testing.assert_allclose(tp[np.lexsort(tp.T)], jp[np.lexsort(jp.T)],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(l8.numpy()[0, :h, :w], np.asarray(jl8)[0, :h, :w])
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_turbo_policy_matches_jax(monkeypatch):
    """``AG_TURBO_NMS`` and the fast-path domain resolve as in the JAX
    package, so the facade picks the variant it picks."""
    for v in (None, "", "0", "1", "auto", "yes"):
        if v is None:
            monkeypatch.delenv("AG_TURBO_NMS", raising=False)
        else:
            monkeypatch.setenv("AG_TURBO_NMS", v)
        assert tpipe._turbo_nms_env() == jpipe._turbo_nms_env()
        for explicit in (None, True, False):
            assert tpipe._resolve_nms(explicit) == jpipe._resolve_nms(explicit)
    shapes = [(1080, 1920), (1024, 1024), (2160, 3840), (240, 320), (366, 640),
              (368, 640), (1024, 2**17 + 64), (4320, 7680), (8200, 8200)]
    for h, w in shapes:
        assert tpipe.turbo_fast_path_ok(h, w) == jpipe.turbo_fast_path_ok(h, w), (h, w)
    det = TagDetector(device="cpu", decimate=True)
    monkeypatch.setenv("AG_TURBO_NMS", "0")
    assert det._turbo_nms(1080, 1920) is False
    monkeypatch.setenv("AG_TURBO_NMS", "1")
    assert det._turbo_nms(240, 320) is True
    monkeypatch.setenv("AG_TURBO_NMS", "auto")
    monkeypatch.setattr(tdetector.os, "cpu_count", lambda: 8)
    assert det._turbo_nms(1080, 1920) is True and det._turbo_nms(240, 320) is False
    monkeypatch.setattr(tdetector.os, "cpu_count", lambda: 1)
    assert det._turbo_nms(1080, 1920) is False


@pytest.fixture(scope="module")
def golden_refs(data_dir):
    """Per 1080p golden: (image, oracle tags, JAX turbo detector tags)."""
    out = {}
    jdet = JaxDetector("t36h11", mode="hybrid", decimate=True)
    for name in ("iphone", "two_boards"):
        img = R.load_image(str(data_dir / f"{name}.png"))
        out[name] = (img, R.TagDetector("t36h11").detect(img), jdet.detect(img))
    return out


@pytest.mark.parametrize("variant", ["1", "0"], ids=["nms", "drain"])
@pytest.mark.parametrize("name", ["iphone", "two_boards"])
def test_turbo_detector_matches_oracle_at_1080p(golden_refs, monkeypatch, name, variant):
    """The contract of the JAX package's turbo mode, for both extraction
    variants: the oracle's tag-ID set with corners < 0.1 px from it, and
    the JAX turbo detector's ID set."""
    monkeypatch.setenv("AG_TURBO_NMS", variant)
    img, oracle_tags, jax_tags = golden_refs[name]
    got = TagDetector("t36h11", device="cpu", decimate=True).detect(img)
    assert len(got) == GOLDEN_COUNTS[name]
    assert set(got) == set(oracle_tags) == set(jax_tags)
    for tid, corners in oracle_tags.items():
        err = np.abs(np.asarray(corners) - np.asarray(got[tid])).max()
        assert err < 0.1, (tid, err)


def test_turbo_batch_of_two_equals_two_singles(golden_refs):
    det = TagDetector("t36h11", device="cpu", decimate=True)
    a, b = golden_refs["two_boards"][0], golden_refs["iphone"][0]
    assert det.detect_batch(np.stack([a, b])) == [det.detect(a), det.detect(b)]
    assert det.detect_batch(np.stack([a, b]), chunk=1) == [det.detect(a), det.detect(b)]


def test_auto_policy(data_dir, golden_refs, monkeypatch):
    """``decimate="auto"`` engages at >= 2 MP only: a 1024x1024 frame takes
    the exact path (all 36 tags), a 1080p frame the turbo path."""
    det = TagDetector("t36h11", device="cpu", decimate="auto")
    assert det._use_decimate(1080, 1920) and det._use_decimate(2160, 3840)
    assert not det._use_decimate(1024, 1024)
    assert not TagDetector("t36h11", device="cpu")._use_decimate(2160, 3840)
    seen = []
    real = tdetector.frontend_packed

    def spy(imgs, params, consts, caps, decimate=False, nms=None):
        seen.append((decimate, nms))
        return real(imgs, params, consts, caps, decimate, nms)

    monkeypatch.setattr(tdetector, "frontend_packed", spy)
    monkeypatch.setenv("AG_TURBO_NMS", "1")
    r45 = R.load_image(str(data_dir / "r45.png"))
    exact = TagDetector("t36h11", device="cpu").detect(r45)
    assert det.detect(r45) == exact and len(exact) == 36
    assert len(det.detect(golden_refs["two_boards"][0])) == 72
    assert seen == [(False, None), (False, None), (True, True)]


@pytest.mark.parametrize("decimate", [True, False], ids=["turbo", "exact"])
def test_refined_saddle_points_match_oracle(data_dir, monkeypatch, decimate):
    """Front-end only, against the oracle's statement of the same path
    (the drain variant is the one with the oracle's cluster semantics)."""
    monkeypatch.setenv("AG_TURBO_NMS", "0")
    img = R.load_image(str(data_dir / "TUM_VI.png"))
    got = TagDetector("t36h11", device="cpu", decimate=decimate).refined_saddle_points(img)
    want = (R.decimated_refined_saddle_points if decimate
            else R.refined_saddle_points)(img)
    assert len(got) == len(want) > 100
    gp = np.array(sorted(s.p for s in got))
    wp = np.array(sorted(s.p for s in want))
    np.testing.assert_allclose(gp, wp, atol=1e-3)
    assert all(30.0 <= s.phi <= 60.0 and s.k > 0 for s in got)


def test_invalid_decimate_arg():
    with pytest.raises(ValueError, match="decimate"):
        TagDetector("t36h11", device="cpu", decimate="always")
