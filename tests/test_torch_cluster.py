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
    _scratch,
    candidate_rows_plain,
    cluster_from_blur_plain,
    cluster_rochade,
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


# -- the CUDA kernels' list launches (csrc/cluster.cu), modelled in numpy --


def _list_launches_model(mask: np.ndarray, seed: int):
    """The kernels' launches, one list entry at a time in a shuffled order:
    first labels = the start of each pixel's run inside its aligned
    32-column segment (the dense launch), min-index links over the
    masked-pixel list for the links that leaves open, the root list with
    -(slot + 2) left in the label plane, integer member sums per root
    slot. The width must be a multiple of 32, as the kernels' planes are.
    Returns {root index: (count, row sum, column sum)}."""
    h, w = mask.shape
    assert w % 32 == 0
    lab = np.full(h * w, -1)
    for i in np.flatnonzero(mask):        # scan order: the left pixel is done
        lab[i] = lab[i - 1] if i % 32 and lab[i - 1] >= 0 else i
    plist = np.flatnonzero(mask)
    np.random.default_rng(seed).shuffle(plist)

    def find(x):                          # with path halving
        while True:
            p = lab[x]
            if p == x or lab[p] == p:
                return p
            lab[x] = min(lab[x], lab[p])  # atomicMin
            x = lab[p]

    def unite(a, b):
        while True:
            a, b = find(a), find(b)
            if a == b:
                return
            if a < b:
                a, b = b, a
            old = lab[a]
            lab[a] = min(old, b)   # atomicMin
            if old == a:
                return
            a = old

    for i in plist:                       # unite_kernel
        first, me, left, up = i % 32 == 0, lab[i], lab[i - 1], lab[i - w]
        if first and left >= 0:
            unite(me, left)
        if up >= 0 and (first or left < 0 or lab[i - w - 1] < 0):
            unite(me, up)
    rlist = []
    for i in plist:                       # roots_kernel
        if lab[i] == i:
            lab[i] = -(len(rlist) + 2)
            rlist.append(i)
    sums = np.zeros((len(rlist), 3), np.int64)
    for i in plist:                       # stats_kernel: a run at a time
        if i % 32 and lab[i - 1] != -1:
            continue
        n = 1
        while (i + n) % 32 and lab[i + n] != -1:
            n += 1
        p = lab[i]
        while p >= 0:
            p = lab[p]
        sums[-p - 2] += (n, n * (i // w), n * (i % w) + n * (n - 1) // 2)
    return {int(r): tuple(int(v) for v in s) for r, s in zip(rlist, sums)}


def _synthetic_masks():
    """Small versions of the smoke's synthetic planes (spiral, comb,
    checkerboard, whole interior, empty, saddle lattice, noise) as masks,
    and two seeded random masks."""
    import chip_smoke
    from aprilgrid_tpu_torch.ops.frontend import hessian_response

    names, planes, thr = chip_smoke.synthetic_blur_planes(70, 96, seed=1)
    resp = hessian_response(torch.from_numpy(planes)).numpy()
    masks = {n: resp[i] < thr[i] for i, n in enumerate(names)}
    rng = np.random.default_rng(11)
    masks["random sparse"] = rng.random((70, 96)) < 0.15
    masks["random dense"] = rng.random((70, 96)) < 0.6
    for m in masks.values():              # the kernels mask inside the border
        m[0] = m[-1] = False
        m[:, 0] = m[:, -1] = False
    return masks


_SHAPES = ("spiral", "comb", "checkerboard", "whole", "empty", "lattice", "noise",
           "random sparse", "random dense")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", _SHAPES)
def test_list_launches_model_matches_labeling(shape, seed):
    """Whatever the order of the masked-pixel list: the roots are the
    components' minimum linear indices and the member counts and integer
    sums are those of ``label_components`` / ``cluster_centroids``."""
    mask = _synthetic_masks()[shape]
    h, w = mask.shape
    got = _list_launches_model(mask, seed)
    lab = tcluster.label_components(torch.from_numpy(mask)).numpy()
    want = {}
    for i in np.flatnonzero(mask):
        n, sr, sc = want.get(int(lab.flat[i]), (0, 0, 0))
        want[int(lab.flat[i])] = (n + 1, sr + i // w, sc + i % w)
    assert got == want
    root, centers = tcluster.cluster_centroids(torch.from_numpy(mask))
    assert root.tolist() == sorted(got)
    sums = np.array([got[r] for r in root.tolist()], np.int64).reshape(-1, 3)
    cntf = sums[:, 0].astype(np.float32)
    np.testing.assert_array_equal(
        centers.numpy(),
        np.stack([sums[:, 2].astype(np.float32) / cntf,
                  sums[:, 1].astype(np.float32) / cntf], -1),
    )
    assert 2 * len(got) <= h * w          # the root list's capacity


def test_synthetic_masks_have_their_shapes():
    masks = _synthetic_masks()
    roots = {n: len(_list_launches_model(m, 0)) for n, m in masks.items()}
    assert roots["spiral"] == roots["comb"] == roots["whole"] == 1
    assert masks["whole"][1:-1, 1:-1].all()
    assert roots["checkerboard"] == masks["checkerboard"].sum() > 1000
    assert roots["empty"] == 0 and not masks["empty"].any()
    assert masks["spiral"].sum() > 1000 and masks["comb"].sum() > 1000
    assert roots["lattice"] > 50 and roots["noise"] > 200


def test_cluster_scratch_contract():
    """The list launches' scratch: a pixel list entry per pixel, a root
    slot per two pixels, three zeroed cursors per frame."""
    labels, plist, rlist, cnt, sums, ctr, fields = _scratch(torch.zeros((3, 16, 128)))
    assert labels.shape == plist.shape == (3, 16, 128)
    assert rlist.shape == cnt.shape == (3, 1024) and sums.shape == (3, 1024, 2)
    assert {t.dtype for t in (labels, plist, rlist, cnt, ctr)} == {torch.int32}
    assert sums.dtype == torch.int64 and fields.dtype == torch.float32
    assert ctr.shape == (3, 3) and not ctr.any()
    assert fields.shape == (3, 1024, 8) and not fields.any()


@pytest.mark.parametrize("bad", ["hp2", "domain", "thr shape", "thr dtype", "layout"])
def test_cluster_wrappers_still_raise(bad):
    blur = torch.zeros((2, 16, 128))
    thr = torch.zeros(2)
    kw = dict(h=12, w=100)
    if bad == "hp2":
        kw["hp2"] = 2
    elif bad == "domain":
        kw.update(h=16, w=2**16)
    elif bad == "thr shape":
        thr = torch.zeros(3)
    elif bad == "thr dtype":
        thr = thr.double()
    else:
        blur = torch.zeros((2, 12, 100))
    with pytest.raises(ValueError):
        cluster_rochade(blur, thr, **kw)


def test_candidate_rows_plain_is_the_uncut_plain_version():
    """The plain version's rows before the capacity cut: on a plane with
    more accepted roots than rows the cut keeps the first 1024 in scan
    order and the counter says 1024."""
    import chip_smoke

    names, planes, thr = chip_smoke.synthetic_blur_planes()
    i = names.index("lattice")
    blur, t = torch.from_numpy(planes[i]), torch.from_numpy(thr[i : i + 1])
    rows = candidate_rows_plain(blur, t[0])
    assert rows.shape[0] > 1024 and (rows[1:, 7] > rows[:-1, 7]).all()
    fields, counts = cluster_from_blur_plain(blur[None], t)
    assert counts.tolist() == [[1024.0, 0.0]]
    np.testing.assert_array_equal(fields[0].numpy(), rows[:1024].numpy())


# ---- the row-sharding mode (row_off/global_h) ----------------------------


def _claimed(fields, w, lo, hi):
    """The accepted rows whose root row (label) lies in [lo, hi), by label."""
    f = fields[fields[:, 6] > 0.5]
    root_row = (f[:, 7].astype(np.int64) - 1) // w
    f = f[(root_row >= lo) & (root_row < hi)]
    return f[np.argsort(f[:, 7])]


@pytest.mark.parametrize("luma_f32", [False, True], ids=["raw", "luma_f32"])
def test_cluster_row_off_matches_jax(data_dir, luma_f32):
    """The row-sharding mode on a frame cut into two bands (window 0 starts
    48 rows above the frame, window 1 inside it), against the JAX kernel in
    interpret mode on the same windows and threshold: on the rows each
    window claims, the same accepted labels, x and the frame-row y within
    1e-4 px. ``luma_f32``: the turbo path's half planes (half-row offsets),
    the JAX kernel at its turbo window without its pre-filter."""
    from aprilgrid_tpu_torch.kernels.frontend import front_kernel_decimate
    from aprilgrid_tpu_torch.parallel.sharding import CTX, row_windows

    img = R.load_image(str(data_dir / "EuRoC.png"))[:, :384]
    wins, roff, local_h, gh = row_windows(torch.from_numpy(img), 2, turbo=luma_f32)
    w, h = img.shape[1], local_h
    jkw = {}
    if luma_f32:
        _, wins, tmin = front_kernel_decimate(wins, 1.5, (local_h, w), 1, False,
                                              row_off=roff, global_h=gh)
        w, h = w // 2, local_h // 2
        jkw = dict(luma_f32=True, prefilter=False, win=160)
    else:
        tmin = front_kernel(wins, 1.5, (local_h, w), 1, False, row_off=roff, global_h=gh)[1]
    thr = tmin.amin().expand(2) * CONSTANTS.response_threshold_ratio
    f, _ = cluster_rochade_raw(wins, thr, h, w, luma_f32=luma_f32, row_off=roff, global_h=gh)
    jf, _ = jpcl.cluster_rochade_raw(
        jnp.asarray(wins.numpy()), jnp.asarray(thr.numpy()), h, w, channels=1,
        u16=False, interpret=True, row_off=jnp.asarray(roff.numpy()), global_h=gh, **jkw,
    )
    band = gh // 2
    for i in range(2):
        got = _claimed(f[i].numpy(), w, CTX, CTX + band)
        want = _claimed(np.asarray(jf)[i], w, CTX, CTX + band)
        assert len(got) > 15
        np.testing.assert_array_equal(got[:, 7], want[:, 7])
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=1e-4)
        # y counts the frame's rows: row r of window i is row r + roff[i]
        lab_row = (got[:, 7].astype(np.int64) - 1) // w
        assert np.abs(got[:, 1] - (lab_row + int(roff[i]))).max() < 30


# ---- numpy model of launch (a) of csrc/cluster.cu (blur_mask_kernel) ----
#
# The kernel's blocks stage and blur as front_tile_kernel's do (the passes
# of csrc/tile.cuh, modelled in tile_model.py), then walk the Hessian rows
# in the same thread layout and emit the mask: a warp's four ballots a row
# step, each octet's 32 segment bits, each masked pixel's run start within
# its aligned 32-column segment, 16-byte blur and label rows, the masked
# pixels into the frame's list. The model's planes must be the plain
# chain's: its blur, its mask, labels by the run-start definition, the
# list the set of masked pixels.


def _bit_length(v):
    """32 - clz of uint64 values below 2^32."""
    return sum(((v >> np.uint64(k)) != 0).astype(np.int64) for k in range(32))


def _launch_a_model(raw, channels, u16, true_shape, thr, aligned=True, ro=None, gh=None):
    """(blur (B, Hp, Wp), labels (B, Hp, Wp), listed pixel indices per
    frame) as launch (a)'s blocks compute them."""
    from aprilgrid_tpu_torch.ops.frontend import gaussian_kernel
    from tile_model import RRUN, T, hessian_rows, stage_model, stencil_model

    h, w = true_shape
    lum, _ = stage_model(raw, channels, u16, w, aligned)
    b, n_t, n_s = lum.shape[:3]
    hp, wp = n_t * T, n_s * T
    blurred, _ = stencil_model(lum, true_shape, gaussian_kernel(1.5))
    v = hessian_rows(blurred)                                     # (B, T, S, 64, 64)

    # the mask: Rows{h, ro, gh, inset=1}, columns in [1, w - 1), resp < t;
    # a block with no border pixel in a frame of its own tests resp alone
    ro = np.zeros(b, np.int64) if ro is None else np.asarray(ro, np.int64)
    gh = h if gh is None else gh
    rr = (T * np.arange(n_t)[:, None] + np.arange(T))[None, :, None, :, None]
    cc = (T * np.arange(n_s)[:, None] + np.arange(T))[None, None, :, None, :]
    g = rr + ro[:, None, None, None, None]
    inside = ((rr < h) & (g > 0) & (g < gh - 1) & (rr >= 1) & (rr < h - 1)
              & (cc != 0) & (cc < w - 1))
    ti, si = np.arange(n_t)[:, None], np.arange(n_s)[None, :]
    border = (((ti == 0) | ((ti + 1) * T >= h) | (si == 0) | ((si + 1) * T >= w))[None]
              | (ro != 0)[:, None, None] | (gh != h))                # (B, T, S)
    lt = v < np.asarray(thr, np.float32)[:, None, None, None, None]
    assert (inside | border[..., None, None]).all()
    m = np.where(border[..., None, None], inside & lt, lt)

    # warp k, lane l = 16 half + q: rows 8k + 4 half + r, columns 4q + j;
    # ballot (r, j) holds pixel j of row step r of every lane
    mw = m.reshape(b, n_t, n_s, 8, 2, RRUN, 16, 4).transpose(0, 1, 2, 3, 5, 7, 4, 6)
    mw = mw.reshape(b, n_t, n_s, 8, RRUN, 4, 32)
    lane = np.arange(32, dtype=np.uint64)
    bal = (mw.astype(np.uint64) << lane).sum(-1)                  # (..., r, j)
    x = (bal[..., None] >> (lane & np.uint64(24))) & np.uint64(0xFF)  # (..., r, j, lane)
    for shift, keep in ((12, 0x000F000F), (6, 0x03030303), (3, 0x11111111)):
        x = (x | (x << np.uint64(shift))) & np.uint64(keep)
    seg = np.bitwise_or.reduce(x << np.arange(4, dtype=np.uint64)[:, None], axis=-2)
    pos = 4 * (lane & np.uint64(7))
    # label - pixel index of pixel j: run_start(seg, pos + j) - pos - j
    off = np.stack([
        _bit_length(~seg & ((np.uint64(1) << (pos + np.uint64(j))) - np.uint64(1)))
        - pos.astype(np.int64) - j for j in range(4)], -1)        # (..., r, lane, j)
    off = off.reshape(b, n_t, n_s, 8, RRUN, 2, 16, 4).transpose(0, 1, 2, 3, 5, 4, 6, 7)
    off = off.reshape(b, n_t, n_s, T, T)
    index = (rr * wp + cc)[0, :, :]                               # (T, S, 64, 64)
    labels = np.where(m, index + off, -1)

    def plane(a):
        return a.transpose(0, 1, 3, 2, 4).reshape(b, hp, wp)

    # each thread's mask bits after the block's reservation: its pixels
    listed = [np.sort(index[m[i]]) for i in range(b)]
    return plane(blurred[..., 1:65, 1:65]), plane(labels), listed


def _run_start_labels(mask):
    """Labels (B, Hp, Wp) by definition: -1 unmasked; a masked pixel's the
    index of the first pixel of its run inside its aligned 32-column
    segment."""
    b, hp, wp = mask.shape
    col = np.arange(wp)
    # where each pixel's run would start: after the last unmasked column
    # before it in its segment, or at the segment's first column
    start = np.where(mask, col // 32 * 32, col + 1).reshape(b, hp, wp // 32, 32)
    start = np.maximum.accumulate(start, axis=-1).reshape(b, hp, wp)
    return np.where(mask, np.arange(hp)[:, None] * wp + start, -1)


def _check_launch_a(raw_p, h, w, ch, u16, luma_f32=False, row_off=None, gh=None,
                    unaligned=False):
    from aprilgrid_tpu_torch.kernels.cluster import candidate_mask_plain, raw_blur_plain
    from aprilgrid_tpu_torch.ops.frontend import hessian_response

    blur = raw_blur_plain(raw_p, h, w, ch, u16, 1.5, luma_f32)
    # a threshold that masks about a quarter of each frame's inner pixels
    thr = torch.stack([torch.quantile(hessian_response(f)[1:-1, 1:-1], 0.25) for f in blur])
    offs = [0] * len(blur) if row_off is None else row_off.tolist()
    want = np.zeros((len(blur), raw_p.shape[1] - 16, raw_p.shape[2] // ch), bool)
    for i in range(len(blur)):
        want[i, :h, :w] = candidate_mask_plain(blur[i], thr[i], offs[i], gh).numpy()
    assert 0.1 < want.sum() / (len(blur) * h * w) < 0.4
    raw = raw_p.view(torch.int16).numpy().view(np.uint16) if u16 else raw_p.numpy()
    runs = [True, False] if unaligned else [True]
    for aligned in runs:
        mblur, labels, listed = _launch_a_model(raw, ch, u16, (h, w), thr.numpy(), aligned,
                                                None if row_off is None else offs, gh)
        np.testing.assert_array_equal(mblur[:, :h, :w], blur.numpy())
        np.testing.assert_array_equal(labels >= 0, want)
        np.testing.assert_array_equal(labels, _run_start_labels(want))
        for i, got in enumerate(listed):
            np.testing.assert_array_equal(got, np.flatnonzero(want[i]))


@pytest.mark.parametrize("shape", [(100, 200), (64, 130), (37, 50), (129, 257)])
@pytest.mark.parametrize("mode", ["u8", "u16", "rgb"])
def test_launch_a_model_equals_plain(mode, shape):
    """Launch (a) on the raw frames the smoke holds it to on the card."""
    import chip_smoke

    assert shape in chip_smoke.FRONT_SHAPES
    h, w = shape
    img = chip_smoke.synthetic_raw_frames(mode, h, w, 2, seed=h + w)
    raw_p, _, _, ch, u16 = pad_raw(torch.from_numpy(img))
    _check_launch_a(raw_p, h, w, ch, u16)


@pytest.mark.parametrize("mode", ["u8", "u16", "rgb"])
def test_launch_a_model_unaligned(mode):
    """An unaligned raw pointer: every quad takes the per-element path."""
    import chip_smoke

    img = chip_smoke.synthetic_raw_frames(mode, 100, 200, 2, seed=3)
    raw_p, _, _, ch, u16 = pad_raw(torch.from_numpy(img))
    _check_launch_a(raw_p, 100, 200, ch, u16, unaligned=True)


@pytest.mark.parametrize("shape", [(100, 200), (129, 257)])
def test_launch_a_model_luma_f32(shape):
    """The f32 half plane (pad_half's layout, the turbo drain's input) of a
    ragged frame, with its 16-byte quads and unaligned."""
    import chip_smoke
    from aprilgrid_tpu_torch.kernels.frontend import front_kernel_decimate_plain

    h, w = shape
    img = chip_smoke.synthetic_raw_frames("u8", h, w, 2, seed=h * w)
    raw_p, _, _, ch, u16 = pad_raw(torch.from_numpy(img))
    _, half_p, _ = front_kernel_decimate_plain(raw_p, 1.5, shape, ch, u16)
    _check_launch_a(half_p, h // 2, w // 2, 1, False, luma_f32=True, unaligned=True)


def test_launch_a_model_row_off():
    """Windows of a frame cut into two bands (row_windows): the frame's
    rows gate the mask as well as the window's."""
    import chip_smoke
    from aprilgrid_tpu_torch.parallel.sharding import row_windows

    img = chip_smoke.synthetic_raw_frames("u8", 120, 200, 1, seed=5)[0]
    wins, roff, local_h, gh = row_windows(torch.from_numpy(img), 2)
    assert roff[0] < 0 < roff[1]
    _check_launch_a(wins, local_h, 200, 1, False, row_off=roff, gh=gh)
