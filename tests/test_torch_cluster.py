"""The PyTorch port's clustering, ROCHADE refinement and cluster kernel
held against the JAX package on the CPU (same numpy inputs)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aprilgrid_tpu.config import CONSTANTS
from aprilgrid_tpu.oracle import numpy_ref as R
from aprilgrid_tpu.ops import cluster as jcluster
from aprilgrid_tpu.ops import rochade as jrochade
from aprilgrid_tpu.ops.frontend import gaussian_blur as j_blur
from aprilgrid_tpu.ops.gray import to_luma as j_luma
from aprilgrid_tpu.pallas import cluster as jpcl
from aprilgrid_tpu.pallas.frontend import front_kernel as j_front, pad_raw as j_pad
from aprilgrid_tpu_torch.kernels.cluster import (
    cluster_from_blur_plain,
    cluster_rochade_raw,
    saddles_from_candidates,
)
from aprilgrid_tpu_torch.kernels.frontend import front_kernel, pad_raw
from aprilgrid_tpu_torch.ops import cluster as tcluster
from aprilgrid_tpu_torch.ops import rochade as trochade


@pytest.fixture(scope="module")
def euroc(data_dir):
    return R.load_image(str(data_dir / "EuRoC.png"))


def test_cluster_rochade_raw_plain_matches_jax_kernel(euroc):
    """Counts equal; the accepted set equal after the label sort; x, y
    within 1e-3 px (the JAX package's own kernel-vs-oracle bar)."""
    h, w = euroc.shape
    jraw, _, _, ch, u16 = j_pad(jnp.asarray(euroc)[None])
    _, jtmin = j_front(jraw, 1.5, interpret=True, emit_blur=False,
                       pre_padded=True, true_shape=(h, w), channels=ch, u16=u16)
    jthr = jnp.min(jtmin, axis=(1, 2, 3)) * CONSTANTS.response_threshold_ratio
    jf, jc = jpcl.cluster_rochade_raw(jraw, jthr, h, w, channels=ch, u16=u16,
                                      interpret=True)
    js = jax.vmap(jpcl.saddles_from_candidates)(jf)

    raw, _, _, ch, u16 = pad_raw(torch.from_numpy(euroc)[None])
    _, tmin = front_kernel(raw, 1.5, (h, w), ch, u16)
    thr = tmin.amin(-1) * CONSTANTS.response_threshold_ratio
    f, c = cluster_rochade_raw(raw, thr, h, w, ch, u16)
    s = saddles_from_candidates(f)

    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    jv = np.asarray(js.valid[0])
    tv = s.valid[0].numpy()
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 150
    # the same clusters (label = scan index + 1 of the root pixel)
    jfa = np.asarray(jf)[0]
    np.testing.assert_array_equal(
        np.sort(f[0, :, 7].numpy()[f[0, :, 6].numpy() > 0.5]),
        np.sort(jfa[jfa[:, 6] > 0.5, 7]),
    )
    np.testing.assert_allclose(s.p[0].numpy()[tv], np.asarray(js.p[0])[jv], atol=1e-3)
    np.testing.assert_allclose(s.theta[0].numpy()[tv], np.asarray(js.theta[0])[jv],
                               atol=1e-3)


def test_oversized_blob_is_one_cluster_and_no_drop():
    """Twin of the JAX blob-size-cap test: blur = r*c makes the response
    -1 at every interior pixel, one blob spanning the frame. The JAX
    kernel drops it at its member-scan cap and counts the drop; the port
    labels globally, so it is one cluster, nothing is dropped, and the
    counter says so."""
    h = w = 256
    r = torch.arange(h, dtype=torch.float32)[:, None]
    c = torch.arange(w, dtype=torch.float32)[None, :]
    blur = (r * c)[None]
    fields, counts = cluster_from_blur_plain(blur, torch.tensor([-0.05]))
    assert float(counts[0, 1]) == 0
    assert float(counts[0, 0]) <= 1
    mask = torch.zeros(h, w, dtype=torch.bool)
    mask[1:-1, 1:-1] = True
    root, centers = tcluster.cluster_centroids(mask)
    assert root.tolist() == [w + 1]
    np.testing.assert_allclose(centers.numpy(), [[127.5, 127.5]])


def test_label_components_matches_jax():
    rng = np.random.default_rng(5)
    mask = rng.random((61, 83)) < 0.45
    ref = np.asarray(jcluster.label_components(jnp.asarray(mask), max_rounds=1000))
    got = tcluster.label_components(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_cluster_centroids_match_jax(euroc):
    lf, _ = j_luma(jnp.asarray(euroc))
    from aprilgrid_tpu.ops.frontend import hessian_response

    resp = hessian_response(j_blur(lf, 1.5))
    ref = jcluster.cluster_centroids(resp, 0.05, 4096, 98304, 64)
    mask = torch.from_numpy(np.asarray(resp < jnp.min(resp) * 0.05))
    root, centers = tcluster.cluster_centroids(mask)
    rv = np.asarray(ref.valid)
    assert root.numel() == rv.sum()
    np.testing.assert_allclose(centers.numpy(), np.asarray(ref.centers)[rv], atol=1e-4)


def test_rochade_refine_matches_jax(euroc):
    """Rank-1 fit (the kernel's op order) vs the JAX dense pinv fit on the
    EuRoC candidates: same accept decisions, positions within 1e-4 px."""
    lf, _ = j_luma(jnp.asarray(euroc))
    blur = j_blur(lf, 1.5)
    refs = R.refined_saddle_points(euroc)
    rng = np.random.default_rng(0)
    pts = np.array([s.p for s in refs], np.float32)
    centers = np.concatenate([pts, pts + rng.uniform(-0.6, 0.6, pts.shape)]).astype(np.float32)
    centers = np.concatenate([centers, [[1.0, 1.0], [740.0, 470.0]]]).astype(np.float32)
    valid = np.ones(len(centers), bool)
    js = jrochade.rochade_refine(blur, jnp.asarray(centers), jnp.asarray(valid))
    ts = trochade.rochade_refine(torch.from_numpy(np.asarray(blur)),
                                 torch.from_numpy(centers), torch.from_numpy(valid))
    jv = np.asarray(js.valid)
    np.testing.assert_array_equal(ts.valid.numpy(), jv)
    assert jv.sum() >= len(refs)
    for name in ("p", "k", "theta", "phi"):
        np.testing.assert_allclose(getattr(ts, name).numpy()[jv],
                                   np.asarray(getattr(js, name))[jv], atol=1e-4)


def test_filter_and_compact_matches_jax():
    rng = np.random.default_rng(2)
    n = 300
    p = rng.uniform(0, 500, (n, 2)).astype(np.float32)
    k = rng.uniform(0, 1, n).astype(np.float32)
    theta = rng.uniform(-90, 90, n).astype(np.float32)
    phi = rng.uniform(20, 70, n).astype(np.float32)
    valid = rng.random(n) < 0.7
    js = jrochade.filter_and_compact(
        jrochade.Saddles(*map(jnp.asarray, (p, k, theta, phi, valid))),
        128, 0.1, 30.0, 60.0,
    )
    ts = trochade.filter_and_compact(
        trochade.Saddles(*(torch.from_numpy(a)[None] for a in (p, k, theta, phi, valid))),
        128, 0.1, 30.0, 60.0,
    )
    for name in ("p", "k", "theta", "phi", "valid"):
        np.testing.assert_array_equal(getattr(ts, name)[0].numpy(),
                                      np.asarray(getattr(js, name)))


def test_saddles_from_candidates_matches_jax():
    rng = np.random.default_rng(4)
    f = np.zeros((64, 8), np.float32)
    n = 40
    f[:n, 0:2] = rng.uniform(0, 100, (n, 2))
    f[:n, 3:6] = rng.normal(0, 0.1, (n, 3))
    f[:n, 6] = rng.random(n) < 0.8
    f[:n, 7] = rng.permutation(1000)[:n] + 1
    js = jpcl.saddles_from_candidates(jnp.asarray(f))
    ts = saddles_from_candidates(torch.from_numpy(f)[None])
    jv = np.asarray(js.valid)
    np.testing.assert_array_equal(ts.valid[0].numpy(), jv)
    np.testing.assert_array_equal(ts.p[0].numpy()[jv], np.asarray(js.p)[jv])
    for name in ("k", "theta", "phi"):
        np.testing.assert_allclose(getattr(ts, name)[0].numpy()[jv],
                                   np.asarray(getattr(js, name))[jv], atol=1e-4)
