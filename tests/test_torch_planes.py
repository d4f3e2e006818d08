"""The PyTorch port's plane path (plain versions on the CPU) held against
the JAX package: ``fused_frontend``, ``gray_kernel``, the front kernel's
``emit_blur`` mode and the blur-fed ``cluster_rochade`` against the Pallas
kernels in interpret mode and the ops chain; the split kernel chain against
the fused one; the capacity-bound clustering against the JAX ops; and
``saddle_frontend`` / ``planes_frontend_batch`` and the detector's routing
of out-of-domain frames against the JAX pipeline and the oracle."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aprilgrid_tpu import pipeline as jpipe
from aprilgrid_tpu.config import CONSTANTS as JCONSTS
from aprilgrid_tpu.config import DEFAULT_CAPACITIES as JCAPS
from aprilgrid_tpu.config import DEFAULT_PARAMS as JPARAMS
from aprilgrid_tpu.detector import TagDetector as JaxDetector
from aprilgrid_tpu.oracle import numpy_ref as R
from aprilgrid_tpu.ops import cluster as jcluster
from aprilgrid_tpu.ops import frontend as jfront
from aprilgrid_tpu.ops.gray import to_luma as j_luma
from aprilgrid_tpu.pallas import cluster as jpcl
from aprilgrid_tpu.pallas import frontend as jpal
from aprilgrid_tpu_torch import TagDetector
from aprilgrid_tpu_torch import pipeline as tpipe
from aprilgrid_tpu_torch.config import CONSTANTS, DEFAULT_CAPACITIES, DEFAULT_PARAMS
from aprilgrid_tpu_torch.kernels.cluster import (
    cluster_rochade,
    cluster_rochade_raw,
    saddles_from_candidates,
)
from aprilgrid_tpu_torch.kernels.frontend import (
    front_kernel,
    fused_frontend,
    gray_kernel,
    pad_raw,
)
from aprilgrid_tpu_torch.ops import cluster as tcluster
from aprilgrid_tpu_torch.ops.gray import to_luma_batch

# name -> (image, rows, cols): the whole EuRoC frame (u8 gray, 480 is not
# a multiple of 64, 752 not of 128) and crops of the u16 and RGB goldens
# whose sizes are multiples of neither
SCENES = {
    "EuRoC": ("EuRoC", slice(None), slice(None)),
    "tum_crop": ("TUM_VI", slice(300, 717), slice(200, 713)),
    "rgb_crop": ("two_boards", slice(300, 685), slice(0, 700)),
}


def _scene(data_dir, key):
    name, rows, cols = SCENES[key]
    return np.ascontiguousarray(R.load_image(str(data_dir / f"{name}.png"))[rows, cols])


def _jax_luma(img):
    return np.array(j_luma(jnp.asarray(img))[0])


# -- fused_frontend -----------------------------------------------------------


@pytest.mark.parametrize("key", sorted(SCENES))
def test_fused_frontend_bit_equal_to_jax_ops(data_dir, key):
    """Blur and response equal the JAX ops chain bit for bit, for an
    (H, W) plane and for a (B, H, W) batch."""
    luma = _jax_luma(_scene(data_dir, key))
    jb = jfront.gaussian_blur(jnp.asarray(luma), 1.5)
    jr = jfront.hessian_response(jb)
    blur, resp = fused_frontend(torch.from_numpy(luma), 1.5)
    assert blur.shape == resp.shape == luma.shape
    np.testing.assert_array_equal(blur.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(resp.numpy(), np.asarray(jr))
    both = torch.from_numpy(np.stack([luma, luma[::-1].copy()]))
    bblur, bresp = fused_frontend(both, 1.5)
    assert bblur.shape == (2, *luma.shape)
    np.testing.assert_array_equal(bblur[0].numpy(), np.asarray(jb))
    np.testing.assert_array_equal(bresp[0].numpy(), np.asarray(jr))
    jb1 = jfront.gaussian_blur(jnp.asarray(luma[::-1]), 1.5)
    np.testing.assert_array_equal(bblur[1].numpy(), np.asarray(jb1))
    np.testing.assert_array_equal(bresp[1].numpy(),
                                  np.asarray(jfront.hessian_response(jb1)))


def test_fused_frontend_matches_jax_kernel(data_dir):
    """Against the compiled JAX kernel: the tolerances of its own test
    against its ops chain (blur 1e-6, response 1e-7). Padded form: shapes,
    zero response on the border and in all padding, tile minima within
    2e-6 of the response scale; ``emit_resp=False`` and a pre-padded input
    with ``true_shape`` give the same planes."""
    luma = _jax_luma(_scene(data_dir, "EuRoC"))
    h, w = luma.shape
    jb, jr = jpal.fused_frontend(jnp.asarray(luma), 1.5, interpret=True)
    blur, resp = fused_frontend(torch.from_numpy(luma), 1.5)
    np.testing.assert_allclose(blur.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(resp.numpy(), np.asarray(jr), rtol=0, atol=1e-7)

    jbp, jrp, jtmin = jpal.fused_frontend(jnp.asarray(luma)[None], 1.5,
                                          interpret=True, crop=False)
    bp, rp, tmin = fused_frontend(torch.from_numpy(luma)[None], 1.5, crop=False)
    assert bp.shape == rp.shape == (1, 512, 768) == np.asarray(jbp).shape
    assert tmin.shape == (1, 8)
    np.testing.assert_array_equal(bp[0, :h, :w].numpy(), blur.numpy())
    np.testing.assert_array_equal(rp[0, :h, :w].numpy(), resp.numpy())
    np.testing.assert_allclose(bp.numpy(), np.asarray(jbp), rtol=0, atol=1e-6)
    inner = np.zeros((512, 768), bool)
    inner[1 : h - 1, 1 : w - 1] = True
    assert not rp[0].numpy()[~inner].any()
    jt = np.asarray(jtmin)[0, :, 0, 0]
    np.testing.assert_allclose(tmin[0].numpy(), jt, rtol=0,
                               atol=2e-6 * float(np.abs(jt).max()))
    np.testing.assert_array_equal(
        tmin[0].numpy(), rp[0].numpy().reshape(8, -1).min(-1))

    b2, t2 = fused_frontend(torch.from_numpy(luma)[None], 1.5, crop=False,
                            emit_resp=False)
    np.testing.assert_array_equal(b2.numpy(), bp.numpy())
    np.testing.assert_array_equal(t2.numpy(), tmin.numpy())
    # a pre-padded plane (edge replicas, as gray_kernel emits) with true_shape
    padded = np.pad(luma, ((0, 512 - h), (0, 768 - w)), mode="edge")
    b3, r3, t3 = fused_frontend(torch.from_numpy(padded)[None], 1.5, crop=False,
                                true_shape=(h, w))
    np.testing.assert_array_equal(b3.numpy(), bp.numpy())
    np.testing.assert_array_equal(r3.numpy(), rp.numpy())
    np.testing.assert_array_equal(t3.numpy(), tmin.numpy())


def test_fused_frontend_checks_its_arguments():
    with pytest.raises(TypeError, match="float32"):
        fused_frontend(torch.zeros((4, 64, 128), dtype=torch.float64))
    with pytest.raises(ValueError, match="emit_resp"):
        fused_frontend(torch.zeros((1, 64, 128)), emit_resp=False)
    with pytest.raises(ValueError, match="does not hold"):
        fused_frontend(torch.zeros((1, 64, 128)), crop=False, true_shape=(65, 100))


# -- gray_kernel --------------------------------------------------------------


@pytest.mark.parametrize("key", sorted(SCENES))
def test_gray_kernel_matches_jax(data_dir, key):
    """Against the compiled JAX kernel: luma8 equal everywhere, padding
    included (both planes carry edge replicas there), f32 luma within 2e-7
    (its reciprocal divides). Against the JAX ``to_luma`` on the true
    region: luma8 equal; f32 luma bit-equal for gray input and within 2e-7
    for RGB, where the kernels evaluate a multiply-add chain."""
    img = _scene(data_dir, key)
    h, w = img.shape[:2]
    jlf, jl8 = (np.asarray(a) for a in jpal.gray_kernel(jnp.asarray(img)[None],
                                                         interpret=True))
    lf, l8 = gray_kernel(torch.from_numpy(img)[None])
    assert lf.shape == l8.shape == jlf.shape
    assert lf.dtype == torch.float32 and l8.dtype == torch.uint8
    np.testing.assert_array_equal(l8.numpy(), jl8)
    np.testing.assert_allclose(lf.numpy(), jlf, rtol=0, atol=2e-7)
    lf0 = lf[0].numpy()
    np.testing.assert_array_equal(lf0[h:], np.broadcast_to(lf0[h - 1], lf0[h:].shape))
    np.testing.assert_array_equal(lf0[:, w:], np.broadcast_to(lf0[:, w - 1 : w],
                                                              lf0[:, w:].shape))
    rf, r8 = j_luma(jnp.asarray(img))
    np.testing.assert_array_equal(l8[0, :h, :w].numpy(), np.asarray(r8))
    if img.ndim == 2:
        np.testing.assert_array_equal(lf0[:h, :w], np.asarray(rf))
    else:
        np.testing.assert_allclose(lf0[:h, :w], np.asarray(rf), rtol=0, atol=2e-7)


def test_gray_kernel_rejects_unfolded_modes():
    with pytest.raises(TypeError, match="gray_kernel"):
        gray_kernel(torch.zeros((1, 8, 8, 3), dtype=torch.uint16))
    with pytest.raises(TypeError, match="gray_kernel"):
        gray_kernel(torch.zeros((1, 8, 8), dtype=torch.float32))


# -- front_kernel(emit_blur=True) ----------------------------------------------


def test_front_kernel_emit_blur_matches_jax(data_dir):
    """The blur plane as third output: on the true region bit-equal to the
    JAX ops chain's blur of the same luma, and within 1e-6 of the compiled
    JAX kernel's (the bar of ``fused_frontend`` against the ops chain: the
    compiled kernel contracts multiply-adds, measured 3e-7 here); luma8
    equal, minima within 2e-6 of the response scale; luma8 and minima
    equal to the ``emit_blur=False`` outputs."""
    img = _scene(data_dir, "rgb_crop")
    h, w = img.shape[:2]
    jblur, jl8, jtmin = jpal.front_kernel(jnp.asarray(img)[None], 1.5, interpret=True)
    raw, _, _, ch, u16 = pad_raw(torch.from_numpy(img)[None])
    blur, l8, tmin = front_kernel(raw, 1.5, (h, w), ch, u16, emit_blur=True)
    assert blur.shape == np.asarray(jblur).shape and blur.is_contiguous()
    np.testing.assert_allclose(blur[0, :h, :w].numpy(), np.asarray(jblur)[0, :h, :w],
                               rtol=0, atol=1e-6)
    lf, _ = gray_kernel(torch.from_numpy(img)[None])
    np.testing.assert_array_equal(
        blur[0, :h, :w].numpy(),
        np.asarray(jfront.gaussian_blur(jnp.asarray(lf[0, :h, :w].numpy()), 1.5)))
    np.testing.assert_array_equal(l8.numpy(), np.asarray(jl8))
    jt = np.asarray(jtmin)[0, :, 0, 0]
    np.testing.assert_allclose(tmin[0].numpy(), jt, rtol=0,
                               atol=2e-6 * float(np.abs(jt).max()))
    l8b, tminb = front_kernel(raw, 1.5, (h, w), ch, u16)
    assert torch.equal(l8, l8b) and torch.equal(tmin, tminb)


# -- cluster_rochade and the split chain --------------------------------------


def test_cluster_rochade_plain_matches_jax_kernel(data_dir):
    """The blur-fed cluster kernel on EuRoC, fed by ``fused_frontend``'s
    padded form in both packages: counts equal, the accepted set equal
    after the label sort, x, y within 1e-3 px (the JAX package's own
    kernel-vs-oracle bar)."""
    img = _scene(data_dir, "EuRoC")
    h, w = img.shape
    luma = _jax_luma(img)
    jbp, jtmin = jpal.fused_frontend(jnp.asarray(luma)[None], 1.5, interpret=True,
                                     crop=False, emit_resp=False)
    jthr = jnp.min(jtmin, axis=(1, 2, 3)) * JCONSTS.response_threshold_ratio
    jf, jc = jpcl.cluster_rochade(jbp, jthr, h, w, 4, 1.0, interpret=True)
    js = jax.vmap(jpcl.saddles_from_candidates)(jf)

    bp, tmin = fused_frontend(torch.from_numpy(luma)[None], 1.5, crop=False,
                              emit_resp=False)
    thr = tmin.amin(-1) * CONSTANTS.response_threshold_ratio
    f, c = cluster_rochade(bp, thr, h, w)
    s = saddles_from_candidates(f)

    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    jv, tv = np.asarray(js.valid[0]), s.valid[0].numpy()
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 150
    jfa = np.asarray(jf)[0]
    np.testing.assert_array_equal(
        np.sort(f[0, :, 7].numpy()[f[0, :, 6].numpy() > 0.5]),
        np.sort(jfa[jfa[:, 6] > 0.5, 7]),
    )
    np.testing.assert_allclose(s.p[0].numpy()[tv], np.asarray(js.p[0])[jv], atol=1e-3)
    np.testing.assert_allclose(s.theta[0].numpy()[tv], np.asarray(js.theta[0])[jv],
                               atol=1e-3)


@pytest.mark.parametrize("key", sorted(SCENES))
def test_split_chain_equals_fused_chain(data_dir, key):
    """``gray_kernel -> fused_frontend(crop=False, emit_resp=False) ->
    cluster_rochade`` and ``front_kernel(emit_blur=True) ->
    cluster_rochade`` reproduce ``front_kernel -> cluster_rochade_raw``
    bit for bit (u8, u16 and RGB input), as the JAX package demands of its
    kernels."""
    img = _scene(data_dir, key)
    h, w = img.shape[:2]
    frames = torch.from_numpy(img)[None]
    raw, _, _, ch, u16 = pad_raw(frames)
    l8, tmin = front_kernel(raw, 1.5, (h, w), ch, u16)
    thr = tmin.amin(-1) * CONSTANTS.response_threshold_ratio
    f, c = cluster_rochade_raw(raw, thr, h, w, ch, u16)
    assert c[0, 0] > 20

    lf, g8 = gray_kernel(frames)
    bp, smin = fused_frontend(lf, 1.5, crop=False, true_shape=(h, w), emit_resp=False)
    assert torch.equal(g8, l8) and torch.equal(smin, tmin)
    sf, sc = cluster_rochade(bp, thr, h, w)
    assert torch.equal(sc, c) and torch.equal(sf, f)

    eb, e8, emin = front_kernel(raw, 1.5, (h, w), ch, u16, emit_blur=True)
    assert torch.equal(eb, bp) and torch.equal(e8, l8) and torch.equal(emin, tmin)
    ef, ec = cluster_rochade(eb, thr, h, w)
    assert torch.equal(ec, c) and torch.equal(ef, f)


def test_cluster_rochade_checks_its_arguments():
    thr = torch.zeros(1)
    with pytest.raises(ValueError, match="128"):
        cluster_rochade(torch.zeros((1, 64, 100)), thr, 60, 90)
    with pytest.raises(ValueError, match="f32 plane"):
        cluster_rochade(torch.zeros((1, 64, 128), dtype=torch.float64), thr, 60, 90)
    meta = torch.device("meta")
    mthr = torch.empty((1,), device=meta)
    with pytest.raises(ValueError, match="plane path"):
        cluster_rochade(torch.empty((1, 64, 2**16 + 128), device=meta), mthr, 60, 2**16)
    with pytest.raises(ValueError, match="plane path"):
        cluster_rochade(torch.empty((1, 4096, 4096), device=meta), mthr, 4096, 4096)
    raw = torch.empty((1, 4096 + 16, 4096), dtype=torch.uint8, device=meta)
    with pytest.raises(ValueError, match="plane path"):
        cluster_rochade_raw(raw, mthr, 4096, 4096)


# -- capacity-bound clustering ------------------------------------------------


def _resp_batch(seed, shape=(2, 61, 83)):
    rng = np.random.default_rng(seed)
    resp = np.where(rng.random(shape) < 0.42, -rng.random(shape), 0.0)
    return resp.astype(np.float32)


@pytest.mark.parametrize("rounds", [1, 2, 64])
def test_label_components_round_cap_matches_jax(rounds):
    mask = _resp_batch(5) < -0.05
    got = tcluster.label_components(torch.from_numpy(mask), rounds)
    assert got.dtype == torch.int32
    for i in range(mask.shape[0]):
        ref = jcluster.label_components(jnp.asarray(mask[i]), max_rounds=rounds)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))


@pytest.mark.parametrize("caps", [(4096, 98304, 64), (8, 64, 1), (8, 98304, 64),
                                  (4096, 64, 64)],
                         ids=["default", "small", "few_clusters", "few_masked"])
def test_cluster_centroids_bounded_matches_jax(caps):
    """The truncations are part of the function: the first ``max_clusters``
    roots, the first ``max_masked`` masked pixels, ``max_rounds`` rounds."""
    resp = _resp_batch(11)
    got = tcluster.cluster_centroids_bounded(torch.from_numpy(resp), 0.05, *caps)
    assert got.centers.shape == (2, caps[0], 2) and got.valid.shape == (2, caps[0])
    for i in range(resp.shape[0]):
        ref = jcluster.cluster_centroids(jnp.asarray(resp[i]), 0.05, *caps)
        rv = np.asarray(ref.valid)
        assert rv.sum() > 4
        np.testing.assert_array_equal(got.valid[i].numpy(), rv)
        np.testing.assert_allclose(got.centers[i].numpy()[rv],
                                   np.asarray(ref.centers)[rv], rtol=0, atol=1e-6)


# -- the plane path as a whole ------------------------------------------------


def _assert_saddles_match(ts, js):
    jv, tv = np.asarray(js.valid), ts.valid.numpy()
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 20
    np.testing.assert_allclose(ts.p.numpy()[tv], np.asarray(js.p)[jv], rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts.theta.numpy()[tv], np.asarray(js.theta)[jv],
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("decimate", [False, True], ids=["exact", "turbo"])
@pytest.mark.parametrize("key", ["EuRoC", "rgb_crop"])
def test_planes_frontend_batch_matches_jax(data_dir, key, decimate):
    """``planes_frontend_batch`` against the JAX package's statement of
    the same path (``saddle_frontend_batch(use_pallas=False)``): valid
    masks and order equal, positions within 1e-3 px, angles within 1e-3
    deg, luma8 and counters equal."""
    img = _scene(data_dir, key)
    frames = np.stack([img, img[::-1].copy()])
    js, jl8, jcnt = jpipe.saddle_frontend_batch(
        jnp.asarray(frames), JPARAMS, JCONSTS, JCAPS, use_pallas=False,
        with_counters=True, decimate=decimate,
    )
    ts, l8, cnt = tpipe.planes_frontend_batch(
        torch.from_numpy(frames), DEFAULT_PARAMS, CONSTANTS, DEFAULT_CAPACITIES,
        decimate,
    )
    assert l8.shape == frames.shape[:3]
    for i in range(2):
        _assert_saddles_match(type(ts)(*(t[i] for t in ts)),
                              jax.tree.map(lambda a: a[i], js))
    np.testing.assert_array_equal(l8.numpy(), np.asarray(jl8))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


@pytest.mark.parametrize("decimate", [False, True], ids=["exact", "turbo"])
def test_saddle_frontend_matches_jax(data_dir, decimate):
    img = _scene(data_dir, "tum_crop")
    js, jl8 = jpipe.saddle_frontend(jnp.asarray(img), JPARAMS, JCONSTS, JCAPS,
                                    decimate=decimate)
    ts, l8 = tpipe.saddle_frontend(torch.from_numpy(img), DEFAULT_PARAMS, CONSTANTS,
                                   DEFAULT_CAPACITIES, decimate)
    assert ts.p.shape == (DEFAULT_CAPACITIES.max_saddles, 2)
    _assert_saddles_match(ts, js)
    np.testing.assert_array_equal(l8.numpy(), np.asarray(jl8))


def test_to_luma_batch_matches_per_frame(data_dir):
    from aprilgrid_tpu_torch.ops.gray import to_luma

    img = torch.from_numpy(_scene(data_dir, "rgb_crop"))
    frames = torch.stack([img, img.flip(0)])
    lf, l8 = to_luma_batch(frames)
    for i in range(2):
        rf, r8 = to_luma(frames[i])
        assert torch.equal(lf[i], rf) and torch.equal(l8[i], r8)


@pytest.mark.parametrize("decimate", [False, True], ids=["exact", "turbo"])
def test_planes_frontend_batch_goes_in_pieces(data_dir, monkeypatch, decimate):
    """A batch beyond ``PLANE_PIXELS`` goes through in pieces and comes
    out as the whole batch does (here: three frames, one per piece)."""
    img = torch.from_numpy(_scene(data_dir, "rgb_crop"))
    frames = torch.stack([img, img.flip(0), img.flip(1)])
    args = (DEFAULT_PARAMS, CONSTANTS, DEFAULT_CAPACITIES, decimate)
    want = tpipe.planes_frontend_batch(frames, *args)
    monkeypatch.setattr(tpipe, "PLANE_PIXELS", img.shape[0] * img.shape[1])
    got = tpipe.planes_frontend_batch(frames, *args)
    assert got[0].valid.shape == want[0].valid.shape
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_label_components_states_its_limit():
    """int32 labels: a mask of 2^31 pixels raises before anything is
    allocated (a shape-only tensor stands in for it)."""
    mask = torch.empty((2, 2**15, 2**15), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="fewer than 2\\^31"):
        tcluster.label_components(mask)


# -- the domain rule and the facade -------------------------------------------


def test_fused_path_ok_is_the_label_domain():
    """The JAX rule without its sweep-window clause: small frames stay on
    the fused path, 8K-class frames leave it (turbo: at half resolution)."""
    for h, w in [(1080, 1920), (2160, 3840), (4095, 4096), (240, 320), (64, 128)]:
        assert tpipe.fused_path_ok(h, w) and tpipe.fused_path_ok(h, w, True), (h, w)
    for h, w in [(4096, 4096), (4320, 7680), (8, 2**16)]:
        assert not tpipe.fused_path_ok(h, w), (h, w)
    assert tpipe.fused_path_ok(4096, 4096, True) and tpipe.fused_path_ok(4320, 7680, True)
    assert not tpipe.fused_path_ok(8192, 8192, True)
    assert not tpipe.fused_path_ok(8, 2**16, True)
    # inside the window clause the two packages agree
    for h, w in [(1080, 1920), (4096, 4096), (4320, 7680), (8200, 8200),
                 (1024, 2**17 + 64)]:
        assert tpipe.fused_path_ok(h, w) == jpipe._pallas_cluster_ok(h, w), (h, w)
        assert tpipe.fused_path_ok(h, w, True) == jpipe.turbo_fast_path_ok(h, w), (h, w)


@pytest.mark.parametrize("decimate", [False, True], ids=["exact", "turbo"])
def test_out_of_domain_frames_take_the_plane_path(data_dir, monkeypatch, decimate):
    """A frame outside ``fused_path_ok`` is routed to
    ``planes_frontend_batch`` with one RuntimeWarning per shape (the domain
    is shrunk here so that a small frame leaves it)."""
    img = _scene(data_dir, "rgb_crop")
    frames = torch.from_numpy(img)[None]
    args = (DEFAULT_PARAMS, CONSTANTS, DEFAULT_CAPACITIES)
    want = tpipe.planes_frontend_batch(frames, *args, decimate)
    monkeypatch.setattr(tpipe, "fused_path_ok", lambda h, w, decimate=False: False)
    tpipe._warn_plane_path.cache_clear()
    with pytest.warns(RuntimeWarning, match="plane path"):
        got = tpipe.saddle_frontend_batch(frames, *args, decimate=decimate)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the second call of a shape is silent
        tpipe.saddle_frontend_batch(frames, *args, decimate=decimate)
    tpipe._warn_plane_path.cache_clear()
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[1].shape == (1, *img.shape[:2])


def test_blank_16mp_frame_warns_and_finds_nothing():
    """4096 x 4096 has h*w = 2^24, outside the label domain: the detector
    warns and detects through the plane path instead of raising."""
    tpipe._warn_plane_path.cache_clear()
    det = TagDetector("t36h11", device="cpu")
    with pytest.warns(RuntimeWarning, match="4096x4096"):
        assert det.detect(np.full((4096, 4096), 128, np.uint8)) == {}


def test_two_boards_on_a_16mp_canvas_matches_oracle(data_dir):
    """End to end through the facade on a frame outside the label domain:
    the oracle's ID set (72 tags), corners < 0.1 px from it."""
    img = R.load_image(str(data_dir / "two_boards.png"))
    canvas = np.full((4096, 4096, 3), 128, np.uint8)
    canvas[1500 : 1500 + img.shape[0], 1000 : 1000 + img.shape[1]] = img
    ref = R.TagDetector("t36h11").detect(canvas)
    tpipe._warn_plane_path.cache_clear()
    with pytest.warns(RuntimeWarning, match="plane path"):
        got = TagDetector("t36h11", device="cpu").detect(canvas)
    assert len(got) == 72 and set(got) == set(ref)
    for tid in got:
        assert np.abs(np.asarray(got[tid]) - np.asarray(ref[tid])).max() < 0.1, tid


@pytest.mark.parametrize("key", ["EuRoC", "rgb_crop"])
def test_refined_saddle_points_match_jax_facade_and_oracle(data_dir, key):
    img = _scene(data_dir, key)
    got = TagDetector("t36h11", device="cpu").refined_saddle_points(img)
    jref = JaxDetector("t36h11", use_pallas=False).refined_saddle_points(img)
    oref = R.refined_saddle_points(img)
    assert len(got) == len(jref) == len(oref) > 20
    gp = np.array([s.p for s in got])
    np.testing.assert_allclose(gp, np.array([s.p for s in jref]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(gp, np.array([s.p for s in oref]), rtol=0, atol=1e-3)
    np.testing.assert_allclose([s.theta for s in got], [s.theta for s in jref],
                               rtol=0, atol=1e-3)
