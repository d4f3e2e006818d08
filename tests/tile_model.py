"""A numpy model of the register-blocked tile passes (csrc/tile.cuh) that
the front and cluster kernels' blocks run: staging, blur passes, Hessian
windows, with the kernels' index maps. The CUDA kernels run only on the
card; the tests that import this pin their premises on the CPU."""

import numpy as np

T, QUADS, HGROUP, VQUADS, VRUN, RRUN = 64, 18, 16, 17, 6, 4


def u8_lut():
    """The kernel's u8 gray table: v / 255 as one f32 IEEE divide."""
    return np.arange(256, dtype=np.float32) / np.float32(255.0)


def stage_model(raw, channels, u16, w, aligned):
    """Staged luma (B, T, S, 72, 72) f32 and the luma8 of each staged quad
    (B, T, S, 72, 18, 4), from raw (B, Hp+16, Wp*C) as the kernel reads it:
    staged row y of tile ti is padded row 64 ti + 4 + y; quad k of strip si
    covers columns 64 si - 4 + 4k .. +3, clamped to [0, w) per element
    only where a quad leaves the frame or the frame is unaligned."""
    b, rows, row_elems = raw.shape
    hp, wp = rows - 16, row_elems // channels
    n_t, n_s = hp // T, wp // T
    pr = (T * np.arange(n_t)[:, None] + 4 + np.arange(72)[None, :])      # (T, 72)
    c = (T * np.arange(n_s)[:, None, None] - 4
         + 4 * np.arange(QUADS)[None, :, None] + np.arange(4)[None, None, :])
    vec = ((c[..., :1] >= 0) & (c[..., 3:] < w)) & aligned               # (S, 18, 1)
    cc = np.where(vec, c, np.clip(c, 0, w - 1))
    assert cc.min() >= 0 and cc.max() < wp      # no load leaves the row
    interior = np.ones(n_s, bool)
    interior[0] = False
    interior &= T * np.arange(n_s) + T + 4 <= w
    if aligned:                                  # no clamp inside the frame
        assert vec[interior].all()
    px = raw[:, pr[:, None, :, None, None, None],
             (cc[None, :, None] * channels)[..., None] + np.arange(channels)]
    lf, l8 = luma_model(px, channels, u16)      # (B, T, S, 72, 18, 4)
    return lf.reshape(b, n_t, n_s, 72, 72), l8


def luma_model(px, channels, u16):
    """(f32 luma, luma8) of raw pixels px (..., C) as the kernels convert
    them; an f32 luma plane's values are staged as they are (no luma8)."""
    if px.dtype == np.float32:
        return px[..., 0], np.zeros(px.shape[:-1], np.uint8)
    px = px.astype(np.int64)
    if channels == 3:
        r, g, bl = px[..., 0], px[..., 1], px[..., 2]
        cr, cg, cb = (np.float64(np.float32(v / 255.0)) for v in (0.2126, 0.7152, 0.0722))
        acc = (r.astype(np.float32) * np.float32(cr)).astype(np.float64)
        acc = (g * cg + acc).astype(np.float32).astype(np.float64)
        lf = (bl * cb + acc).astype(np.float32)            # two fused multiply-adds
        l8 = (2126 * r + 7152 * g + 722 * bl) // 10000
    elif u16:
        x = px[..., 0].astype(np.float32)
        lf = x / np.float32(65535.0)
        l8 = np.floor((x * np.float32(255.0) + np.float32(32767.0)) / np.float32(65535.0))
    else:
        lf = u8_lut()[px[..., 0]]
        l8 = px[..., 0]
    return lf, l8.astype(np.uint8)


def hessian_model(up, mid, dn):
    """hessian_of on three rows of a window, every column j the centre of
    j .. j + 2."""
    two = np.float32(2.0)
    lxx = (mid[..., :-2] - two * mid[..., 1:-1]) + mid[..., 2:]
    lyy = (up[..., 1:-1] - two * mid[..., 1:-1]) + dn[..., 1:-1]
    lxy = (((up[..., 2:] - up[..., :-2]) + dn[..., :-2]) - dn[..., 2:]) * np.float32(0.25)
    return lxx * lyy - lxy * lxy


def stencil_model(lum, true_shape, taps):
    """The kernels' passes on staged tiles lum (B, T, S, 72, 72) of an
    image of true shape (h, w): (blurred tiles (B, T, S, 66, 68), entry
    (y, x) the blur at image pixel (64 ti - 1 + y, 64 si - 1 + x); tile
    minima of the response (B, T, S), its border zeroed)."""
    h, w = true_shape
    n_t, n_s = lum.shape[1:3]
    taps = [np.float32(t) for t in taps]

    # horizontal pass: group g = outputs 16g .. 16g + 15 from the window of
    # staged columns 16g .. 16g + 23, the tail = outputs 64, 65 from
    # columns 64..71 (and zeros in 66, 67); each tap accumulated from 0 in
    # order
    tmp = np.empty(lum.shape[:4] + (4 * VQUADS,), np.float32)
    for x0 in range(0, T + 1, HGROUP):
        n_out = HGROUP if x0 < T else 2
        win = lum[..., x0 : x0 + HGROUP + 8]
        assert win.shape[-1] == n_out + 6 + (2 if x0 < T else 0)
        acc = np.zeros(win.shape[:-1] + (n_out,), np.float32)
        for k, t in enumerate(taps):
            acc = acc + win[..., k : k + n_out] * t
        tmp[..., x0 : x0 + n_out] = acc
    tmp[..., 66:68] = 0

    # vertical pass: run of 6 rows from a 7-row window, quads 0..16
    blurred = np.empty(lum.shape[:3] + (66, 4 * VQUADS), np.float32)
    for run in range(66 // VRUN):
        for r in range(run * VRUN, (run + 1) * VRUN):
            acc = np.zeros(lum.shape[:3] + (4 * VQUADS,), np.float32)
            for k, t in enumerate(taps):
                acc = acc + tmp[..., r + k, : 4 * VQUADS] * t
            blurred[..., r, :] = acc

    rr = T * np.arange(n_t)[:, None, None] + np.arange(T)[None, None, :]   # (T, 1, 64)
    cc = T * np.arange(n_s)[None, :, None] + np.arange(T)[None, None, :]   # (1, S, 64)
    col_in = (cc != 0) & (cc < w - 1)
    # blocks that hold no border pixel skip the test: none of theirs is 0
    border = ((np.arange(n_t) == 0) | ((np.arange(n_t) + 1) * T >= h))[:, None] | (
        (np.arange(n_s) == 0) | ((np.arange(n_s) + 1) * T >= w))[None, :]
    inside = ((rr > 0) & (rr < h - 1)).all(-1) & col_in.all(-1)          # (T, S)
    assert (inside | border).all()
    row_in = (rr > 0) & (rr < h - 1)
    resp = np.where(row_in[..., :, None] & col_in[:, :, None, :], hessian_rows(blurred), 0)
    return blurred, resp.min(axis=(-2, -1))


def hessian_rows(blurred):
    """The response (B, T, S, 64, 64) of every block's pixels from its
    blurred tile (B, T, S, 66, 68), border not zeroed: thread (run, quad)
    walks rows 4 run .. 4 run + 3 of columns 4 quad .. 4 quad + 3 with the
    rows above and below (a 3-row window of 6 columns)."""
    resp = np.empty(blurred.shape[:3] + (T, T), np.float32)
    for run in range(T // RRUN):
        for y in range(run * RRUN, (run + 1) * RRUN):
            up, mid, dn = (blurred[..., y + d, :66] for d in range(3))
            resp[..., y, :] = hessian_model(up, mid, dn)
    return resp
