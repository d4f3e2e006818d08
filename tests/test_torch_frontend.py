"""The PyTorch port's gray conversion, input folding, padding and front
kernel held against the JAX package on the CPU.

Same numpy inputs go through both packages. The front kernel's plain
version (what a CPU tensor runs) must give the JAX front kernel's luma8
bit for bit, and a global response minimum bit-equal to the JAX ops chain
(ops/gray.py -> ops/frontend.py, evaluated op by op) on the same luma.
The compiled JAX kernel (interpret mode) contracts some multiply-adds and
divides by constant reciprocals, so it is not bit-equal to its own ops
chain either (its tests allow 1e-9 abs); against it the minima agree to
2e-6 of the frame's response scale.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aprilgrid_tpu.oracle.numpy_ref import load_image
from aprilgrid_tpu.ops import frontend as jfront
from aprilgrid_tpu.ops import gray as jgray
from aprilgrid_tpu.pallas import frontend as jpal
from aprilgrid_tpu.pipeline import normalize_raw_batch as j_normalize
from aprilgrid_tpu_torch.kernels.frontend import front_kernel, front_kernel_decimate, pad_raw
from aprilgrid_tpu_torch.ops.frontend import gaussian_blur, hessian_response
from aprilgrid_tpu_torch.ops.gray import to_luma
from aprilgrid_tpu_torch.pipeline import normalize_raw_batch
from conftest import make_stress_scene
from tile_model import T as _T, stage_model, stencil_model, u8_lut


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _modes():
    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    u16 = rng.integers(0, 65536, (37, 53)).astype(np.uint16)
    rgb = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    return {
        "u8": u8,
        "u16": u16,
        "rgb": rgb,
        "rgba": np.concatenate([rgb, u8[..., None]], -1),
        "la": np.stack([u8, u8[::-1]], -1),
        "rgb16": rng.integers(0, 65536, (37, 53, 3)).astype(np.uint16),
        "f32": rng.random((37, 53)).astype(np.float32),
        "rgbf32": rng.random((37, 53, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("mode", sorted(_modes()))
def test_to_luma_matches_jax(mode):
    img = _modes()[mode]
    jf, j8 = jgray.to_luma(jnp.asarray(img))
    tf, t8 = to_luma(_t(img))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(t8.numpy().astype(np.int32),
                                  np.asarray(j8).astype(np.int32))


@pytest.mark.parametrize("mode", sorted(_modes()))
def test_normalize_raw_batch_matches_jax(mode):
    img = _modes()[mode][None]
    ref = np.asarray(j_normalize(jnp.asarray(img)))
    got = _np(normalize_raw_batch(_t(img)))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["u8", "u16", "rgb", "rgba"])
def test_pad_raw_matches_jax(mode):
    img = _modes()[mode][None]
    jraw, jh, jw, jch, ju16 = jpal.pad_raw(jnp.asarray(img))
    raw, h, w, ch, u16 = pad_raw(_t(img))
    assert (h, w, ch, u16) == (jh, jw, jch, ju16)
    np.testing.assert_array_equal(_np(raw), np.asarray(jraw))


def test_pad_raw_rejects_unfolded_modes():
    with pytest.raises(TypeError):
        pad_raw(_t(_modes()["rgb16"][None]))


def test_blur_and_response_bit_equal_to_jax_ops(data_dir):
    img = load_image(str(data_dir / "EuRoC.png"))
    jl, _ = jgray.to_luma(jnp.asarray(img))
    tl, _ = to_luma(_t(img))
    jb = jfront.gaussian_blur(jl, 1.5)
    tb = gaussian_blur(tl, 1.5)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        hessian_response(tb).numpy(), np.asarray(jfront.hessian_response(jb))
    )


def _scene(kind):
    if kind == "EuRoC":
        from conftest import DATA_DIR

        return load_image(str(DATA_DIR / "EuRoC.png"))
    # a 256-row band of an 820^2 stress scene keeps the interpret run short
    return make_stress_scene(1, kind=kind)[300:556]


def _jax_luma_f32(img):
    """The JAX front kernel's f32 luma, evaluated eagerly: IEEE divides
    for gray, the deinterleave matmul for RGB."""
    x = jnp.asarray(img).astype(jnp.float32)
    if img.ndim == 3:
        mf, _ = jpal._deinterleave_chunk(128)
        flat = x.reshape(x.shape[0], -1)
        w = img.shape[1]
        chunks = []
        for col in range(0, w, 128):
            cw = min(128, w - col)
            chunks.append(jnp.dot(flat[:, 3 * col : 3 * (col + cw)],
                                  jnp.asarray(mf[: 3 * cw, :cw])))
        return jnp.concatenate(chunks, axis=1)
    return x / (65535.0 if img.dtype == np.uint16 else 255.0)


@pytest.mark.parametrize("kind", ["EuRoC", "u16", "rgb"])
def test_front_kernel_plain_matches_jax(kind):
    img = _scene(kind)
    h, w = img.shape[:2]
    raw, _, _, ch, u16 = pad_raw(_t(img)[None])
    l8, tile_min = front_kernel(raw, 1.5, (h, w), ch, u16)

    jraw, _, _, jch, ju16 = jpal.pad_raw(jnp.asarray(img)[None])
    jl8, jtmin = jpal.front_kernel(
        jraw, 1.5, interpret=True, emit_blur=False, pre_padded=True,
        true_shape=(h, w), channels=jch, u16=ju16,
    )
    np.testing.assert_array_equal(l8.numpy(), np.asarray(jl8))
    assert tile_min.shape == (1, np.asarray(jtmin).shape[1])
    # the compiled kernel's contractions move a minimum by a few ulps of
    # the frame's response scale; the global minimum sets the threshold
    jt = np.asarray(jtmin)[0, :, 0, 0]
    scale = float(np.abs(jt).max())
    np.testing.assert_allclose(tile_min.numpy()[0], jt, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(float(tile_min.min()), float(jt.min()), rtol=2e-6)
    # op-by-op JAX chain on the same luma: bit-equal global minimum
    resp = jfront.hessian_response(jfront.gaussian_blur(_jax_luma_f32(img), 1.5))
    assert float(tile_min.min()) == float(jnp.min(resp))


# ---- numpy model of csrc/frontend.cu::front_tile_kernel -----------------
#
# The CUDA kernel runs only on the card; these tests pin its premises on
# the CPU: a numpy walk over its blocks with its index maps (tile_model.py,
# the passes of csrc/tile.cuh, which cluster.cu shares: staged quads,
# clamped columns, 16-output horizontal windows of 24 staged columns and a
# 2-output tail window of columns 64..71, 7-row vertical windows over runs
# of 6 rows, 3-row Hessian windows over runs of 4 rows, 16-byte blur rows,
# the border test only in blocks that hold a border pixel, one minimum per
# 64 x 64 block) gives front_kernel_plain's bits.

# (h, w): no multiple of 64 rows, 64 or 128 columns; narrower than a strip
_RAGGED = [(100, 200), (64, 130), (37, 50), (129, 257)]


def _front_tile_model(raw, channels, u16, true_shape, taps, aligned=True):
    """(luma8 (B, Hp, Wp), blur (B, Hp, Wp), tile_min (B, Hp/64)) as the
    kernel's blocks compute them."""
    lum, l8q = stage_model(raw, channels, u16, true_shape[1], aligned)
    b, n_t, n_s = lum.shape[:3]
    hp, wp = n_t * _T, n_s * _T
    blurred, strip_min = stencil_model(lum, true_shape, taps)
    # the blurred tile's own pixels, 16-byte rows from the Hessian pass
    blur = blurred[..., 1:65, 1:65].transpose(0, 1, 3, 2, 4).reshape(b, hp, wp)

    # luma8: quads 1..16 of staged rows 4..67, one 4-byte store each
    own = l8q[:, :, :, 4:68, 1:17].reshape(b, n_t, n_s, _T, _T)
    luma8 = own.transpose(0, 1, 3, 2, 4).reshape(b, hp, wp)
    return luma8, blur, strip_min.min(-1)


@pytest.mark.parametrize("shape", _RAGGED)
@pytest.mark.parametrize("mode", ["u8", "u16", "rgb"])
def test_front_tile_model_equals_plain(mode, shape):
    """On the frames the smoke holds the kernel to on the card."""
    import chip_smoke
    from aprilgrid_tpu_torch.kernels.frontend import front_kernel_plain
    from aprilgrid_tpu_torch.ops.frontend import gaussian_kernel

    assert tuple(_RAGGED) == chip_smoke.FRONT_SHAPES
    h, w = shape
    img = chip_smoke.synthetic_raw_frames(mode, h, w, 2, seed=h * w)
    top = 65535 if mode == "u16" else 255
    assert img.shape[:3] == (2, h, w) and img.max() == top and img.min() == 0
    raw, _, _, ch, u16 = pad_raw(_t(img))
    l8, blur, tmin = _front_tile_model(_np(raw), ch, u16, shape, gaussian_kernel(1.5))
    pblur, pl8, ptmin = front_kernel_plain(raw, 1.5, shape, ch, u16, emit_blur=True)
    np.testing.assert_array_equal(l8, pl8.numpy())
    np.testing.assert_array_equal(blur, pblur.numpy())
    np.testing.assert_array_equal(tmin, ptmin.numpy())
    if shape == _RAGGED[0]:     # an unaligned frame: every quad per element
        l8u, bu, tu = _front_tile_model(_np(raw), ch, u16, shape,
                                        gaussian_kernel(1.5), aligned=False)
        np.testing.assert_array_equal(l8u, l8)
        np.testing.assert_array_equal(bu, blur)
        np.testing.assert_array_equal(tu, tmin)


def test_u8_luma_table_is_ieee_div():
    from aprilgrid_tpu_torch.ops.gray import ieee_div

    want = ieee_div(torch.arange(256, dtype=torch.float32), 255.0).numpy()
    np.testing.assert_array_equal(u8_lut().view(np.int32), want.view(np.int32))


def _fma32(a, b, c):
    """Correctly rounded f32 fma(a, b, c) of f32 arrays: the product is
    exact in f64, TwoSum gives the sum's f64 rounding s and its exact
    error, and the f32 rounding of s moves one step where s + err lies past
    half a step (ties to even)."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    f = s.astype(np.float32)
    d = (s - f.astype(np.float64)) + err
    up, dn = np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))
    hu, hd = (up.astype(np.float64) - f) / 2, (f.astype(np.float64) - dn) / 2
    odd = (f.view(np.int32) & 1) == 1
    f = np.where((d > hu) | ((d == hu) & odd), up, f)
    return np.where((d < -hd) | ((d == -hd) & odd), dn, f)


def test_u16_luma_helpers_are_exact():
    """The kernels' u16 helpers (csrc/frontend.cu) on every u16 value:
    gray16_f32, a product with the f32 reciprocal and one FMA correction,
    equals the IEEE divide x / 65535 of luma_f32 and ops/gray.py; gray16_u8,
    an integer quotient, equals luma_u8's floor of the f32 quotient."""
    from aprilgrid_tpu_torch.ops.gray import ieee_div

    x = np.arange(65536).astype(np.float32)
    inv = np.float32(1.0 / 65535.0)
    q = x * inv
    got = _fma32(_fma32(-q, np.float32(65535.0), x), inv, q)
    want = ieee_div(torch.from_numpy(x), 65535.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (q != want).sum() > 0          # the plain product alone is not exact
    xi = np.arange(65536, dtype=np.int64)
    l8 = np.floor((x * np.float32(255.0) + np.float32(32767.0)) / np.float32(65535.0))
    np.testing.assert_array_equal((xi * 255 + 32767) // 65535, l8.astype(np.int64))


def test_fma32_model_rounds_once():
    """_fma32 against exact rational arithmetic on products cancelled to a
    few ulps, where a second rounding would show."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    a = rng.standard_normal(400).astype(np.float32)
    b = rng.standard_normal(400).astype(np.float32)
    c = (-(a.astype(np.float64) * b)).astype(np.float32)
    c = c * np.float32(1.0) + np.float32(1e-7) * rng.standard_normal(400).astype(np.float32)
    got = _fma32(a, b, c)
    for ai, bi, ci, g in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        cands = [g, np.nextafter(g, np.float32(np.inf)), np.nextafter(g, np.float32(-np.inf))]
        dist = [abs(Fraction(float(v)) - exact) for v in cands]
        assert dist[0] <= min(dist[1:])


# ---- the row-sharding mode (row_off/global_h) ----------------------------
#
# A frame cut into two bands, as the row-sharded front-ends cut it: window 0
# starts above the frame (row offset -48, its top rows replicas of the
# frame's first row), window 1 inside it (a positive offset). Both go to the
# JAX kernel in interpret mode and to the plain version as one batch.


def _windows(data_dir, turbo):
    from aprilgrid_tpu_torch.parallel.sharding import row_windows

    img = load_image(str(data_dir / "EuRoC.png"))[:, :384]
    wins, roff, local_h, gh = row_windows(torch.from_numpy(img), 2, turbo=turbo)
    assert roff[0] < 0 < roff[1]
    return wins, roff, local_h, img.shape[1], gh


def test_front_kernel_row_off_matches_jax(data_dir):
    """luma8 equal to the JAX kernel's; tile minima within the documented
    ulps of the response scale, with the frame's border and the rows past
    the window's own zeroed as the JAX kernel zeroes them."""
    wins, roff, local_h, w, gh = _windows(data_dir, turbo=False)
    l8, tmin = front_kernel(wins, 1.5, (local_h, w), 1, False, row_off=roff, global_h=gh)
    jl8, jtmin = jpal.front_kernel(
        jnp.asarray(wins.numpy()), 1.5, interpret=True, emit_blur=False,
        pre_padded=True, true_shape=(local_h, w), channels=1, u16=False,
        row_off=jnp.asarray(roff.numpy()), global_h=gh,
    )
    np.testing.assert_array_equal(l8.numpy(), np.asarray(jl8))
    jt = np.asarray(jtmin)[:, :, 0, 0]
    scale = float(np.abs(jt).max())
    np.testing.assert_allclose(tmin.numpy(), jt, rtol=0, atol=2e-6 * scale)
    # the gates of the mode moved a minimum (the rows past the frame's end)
    assert not torch.equal(tmin, front_kernel(wins, 1.5, (local_h, w), 1, False)[1])


def test_front_kernel_decimate_row_off_matches_jax(data_dir):
    """The decimating kernel on the turbo path's windows (half-row offsets,
    edge rows alternated in window 0): luma8 equal to the JAX kernel's,
    half planes within the documented 1.2e-7, half-resolution minima
    (per 64 half rows here, per 32 there) within the documented ulps, the
    frame's half border and the window's 4-row inset zeroed in both."""
    wins, roff, local_h, w, gh = _windows(data_dir, turbo=True)
    hh, wh = local_h // 2, w // 2
    l8, half_p, tmin = front_kernel_decimate(wins, 1.5, (local_h, w), 1, False,
                                             row_off=roff, global_h=gh)
    jl8, jhalf, jtmin = (np.asarray(a) for a in jpal.front_kernel_decimate(
        jnp.asarray(wins.numpy()), 1.5, pre_padded=True, true_shape=(local_h, w),
        channels=1, u16=False, row_off=jnp.asarray(roff.numpy()), global_h=gh,
        interpret=True,
    ))
    np.testing.assert_array_equal(l8.numpy(), jl8)
    np.testing.assert_allclose(half_p.numpy()[:, : 8 + hh, :wh], jhalf[:, : 8 + hh, :wh],
                               rtol=0, atol=1.2e-7)
    jt = jtmin[:, :, 0, 0]
    scale = float(np.abs(jt).max())
    for j in range(tmin.shape[1]):
        np.testing.assert_allclose(tmin.numpy()[:, j], jt[:, 2 * j : 2 * j + 2].min(1),
                                   rtol=0, atol=2e-6 * scale)
    assert not torch.equal(tmin, front_kernel_decimate(wins, 1.5, (local_h, w), 1, False)[2])
