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
from aprilgrid_tpu_torch.kernels.frontend import front_kernel, pad_raw
from aprilgrid_tpu_torch.ops.frontend import gaussian_blur, hessian_response
from aprilgrid_tpu_torch.ops.gray import to_luma
from aprilgrid_tpu_torch.pipeline import normalize_raw_batch
from conftest import make_stress_scene


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
