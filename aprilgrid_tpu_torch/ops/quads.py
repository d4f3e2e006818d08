"""Seed-quad hypothesis search (the JAX package's ``ops/quads.py``).

The reference's init_quads (src/detector.rs:543-586) takes the 50 nearest
neighbors of a seed saddle from a kd-tree, splits them into same- and
different-orientation sets, and tests every (s1, {d0, d1}) combination
with is_valid_quad. Here the kd-tree becomes a masked distance sort and
the combination loops one broadcast predicate over an (s1, pair)
enumeration whose flattened order equals the reference's iteration order,
so the candidate order (which breaks best-board ties) is preserved.

Every lane (a frame's seed) carries its own saddles: ``p`` (L, N, 2),
``theta`` (L, N), ``alive`` (L, N), one seed index per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .compact import nonzero_sized, take
from .geometry import cross, degrees, is_valid_quad, radians, theta_distance_degree


class QuadSet(NamedTuple):
    quads: torch.Tensor    # (L, MQ, 4) int32 saddle indices [s0, d0, s1, d1]
    valid: torch.Tensor    # (L, MQ) bool
    overflow: torch.Tensor  # (L,) int32 — cheap-gate survivors dropped at
    #                         the exact-phase capacity (0 on every golden scene)


def nearest_first(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` smallest entries of each row, nearest
    first and the lower index first among equal values (``inf`` entries
    included): the order ``lax.top_k(-d2, k)`` returns, from a stable
    ascending sort (``torch.topk`` orders ties arbitrarily on CUDA)."""
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def init_quads(
    p: torch.Tensor,
    theta: torch.Tensor,
    alive: torch.Tensor,
    s0_idx: torch.Tensor,
    nn: int,
    max_quads: int,
    cheap_cap: int = 2048,
    same_cap: int = 40,
    diff_cap: int = 40,
) -> QuadSet:
    """Candidate quads seeded at ``s0_idx`` (L,) (src/detector.rs:543-586).

    ``alive`` masks the saddles in play (the reference passes an already
    filtered list). Two phases, as in the JAX package: the combination
    sweep over the compacted same/diff sets runs only the trig-free gates
    of is_valid_quad (theta partition, cross-sign convexity, dot
    orientation, the per-s1 white-block angle), written as the same f32
    expressions as is_valid_quad's; the survivors, compacted to
    ``cheap_cap``, pay the exact predicate. ``overflow`` counts set members
    and survivors dropped at a cap."""
    n = p.shape[1]
    k = min(nn, n)
    lanes = torch.arange(p.shape[0], device=p.device)
    s0 = s0_idx.long()
    p0 = p[lanes, s0]            # (L, 2)
    t0 = theta[lanes, s0]        # (L,)

    dx = p[..., 0] - p0[:, None, 0]
    dy = p[..., 1] - p0[:, None, 1]
    d2 = torch.where(alive, dx * dx + dy * dy, torch.inf)
    nd, nn_idx = nearest_first(d2, k)   # ascending distance, self first
    nn_ok = torch.isfinite(nd)

    td = theta_distance_degree(t0[:, None], take(theta, nn_idx))
    # position 0 is the seed itself (distance 0) — excluded (nearest[1..])
    not0 = torch.arange(k, device=p.device) > 0
    same = nn_ok & (td < 5.0) & not0
    diff = nn_ok & (td > 80.0) & not0

    # -- phase 1: trig-free gates on small per-slot tables
    pk = take(p, nn_idx)                 # (L, k, 2) neighbor positions
    v0j = pk - p0[:, None, :]            # v01[d0], v02[s1], v03[d1]
    rad = radians(t0)
    vtx, vty = torch.cos(rad)[:, None], torch.sin(rad)[:, None]
    wang = torch.abs(degrees(torch.atan2(
        v0j[..., 0] * vty - v0j[..., 1] * vtx,
        v0j[..., 0] * vtx + v0j[..., 1] * vty,
    )))
    white_ok = (wang >= 60.0) & (wang <= 120.0)   # (L, k) per s1

    # compact the same/diff sets before enumerating combos; compaction is
    # order-preserving, so the (s1, pair) enumeration over compacted slots
    # is the reference's iteration order (src/detector.rs:563-570)
    sc = min(same_cap, k)
    dc = min(diff_cap, k)
    s_sel = nonzero_sized(same, sc, k)
    d_sel = nonzero_sized(diff, dc, k)
    s_live = s_sel < k
    d_live = d_sel < k
    set_overflow = (same.sum(-1) - s_live.sum(-1)) + (diff.sum(-1) - d_live.sum(-1))
    ss = s_sel.clamp(max=k - 1)
    ds = d_sel.clamp(max=k - 1)
    pk_s, pk_d = take(pk, ss), take(pk, ds)     # (L, S, 2), (L, D, 2)
    v0s, v0d = take(v0j, ss), take(v0j, ds)

    # cross/dot tables over the compacted subsets: the same mul, mul, sub
    # sequences as is_valid_quad's c0/c1/c01/c12 and dot gates, so phase 1
    # never rejects a combo phase 2 would accept. cr_ds[d, s] =
    # cross(v0j[d], v0j[s]), cr_sd[s, d] = cross(v0j[s], v0j[d]).
    def xs(v, i):
        return v[:, :, None, i]

    def ys(v, i):
        return v[:, None, :, i]

    cr_ds = xs(v0d, 0) * ys(v0s, 1) - xs(v0d, 1) * ys(v0s, 0)   # (L, D, S)
    cr_sd = xs(v0s, 0) * ys(v0d, 1) - xs(v0s, 1) * ys(v0d, 0)   # (L, S, D)
    dt_ds = xs(v0d, 0) * ys(v0s, 0) + xs(v0d, 1) * ys(v0s, 1)
    # edge tables e[a, b] = p[b] - p[a] (v12 at [d0, s1], v23 at [s1, d1])
    ex_ds = ys(pk_s, 0) - xs(pk_d, 0)   # (L, D, S)
    ey_ds = ys(pk_s, 1) - xs(pk_d, 1)
    ex_sd = ys(pk_d, 0) - xs(pk_s, 0)   # (L, S, D)
    ey_sd = ys(pk_d, 1) - xs(pk_s, 1)
    c01_ds = xs(v0d, 0) * ey_ds - xs(v0d, 1) * ex_ds

    def tr(x):
        return x.transpose(1, 2)

    # per-combo gates on the (s1, d0, d1) cube of compacted slots; the
    # i < j triangle over ascending-compacted diff slots is combinations
    # order over the original slots
    tri = torch.arange(dc, device=p.device)
    cand_ok = (
        s_live[:, :, None, None]
        & d_live[:, None, :, None]
        & d_live[:, None, None, :]
        & (tri[:, None] < tri[None, :])[None, None]
    )
    # c12 = cross(v12, v23) = x12*y23 - y12*x23 (op order as cross):
    # x12 = ex[d_i, s], y23 = ey[s, d_j]
    c12_cube = (
        tr(ex_ds)[:, :, :, None] * ey_sd[:, :, None, :]
        - tr(ey_ds)[:, :, :, None] * ex_sd[:, :, None, :]
    )  # (L, S, D, D)
    cheap_ok = (
        cand_ok
        & take(white_ok, ss)[:, :, None, None]
        & (tr(cr_ds)[:, :, :, None] * cr_sd[:, :, None, :] >= 0.0)
        & (tr(c01_ds)[:, :, :, None] * c12_cube >= 0.0)
        & (tr(dt_ds)[:, :, :, None] >= 0.0)
        & (tr(dt_ds)[:, :, None, :] >= 0.0)
    )

    # -- phase 2: exact predicate on the compacted survivors
    flat_cheap = cheap_ok.reshape(p.shape[0], -1)
    total = flat_cheap.shape[1]
    cap = min(cheap_cap, total)
    surv = nonzero_sized(flat_cheap, cap, total)
    p2_live = surv < total
    s_safe = surv.clamp(max=total - 1)
    overflow = set_overflow + (flat_cheap.sum(-1) - p2_live.sum(-1))
    s1_g = take(nn_idx, take(ss, s_safe // (dc * dc)))
    d0_g = take(nn_idx, take(ds, (s_safe // dc) % dc))
    d1_g = take(nn_idx, take(ds, s_safe % dc))
    p_d0, p_s1, p_d1 = take(p, d0_g), take(p, s1_g), take(p, d1_g)
    geom_ok = is_valid_quad(
        p0[:, None, :], t0[:, None],
        p_d0, take(theta, d0_g),
        p_s1,
        p_d1, take(theta, d1_g),
    )
    ok = p2_live & geom_ok

    # CCW/CW orientation: swap d0/d1 when cross(v01, v02) <= 0
    pos = cross(p_d0 - p0[:, None, :], p_s1 - p0[:, None, :]) > 0.0
    qa = torch.where(pos, d0_g, d1_g)
    qb = torch.where(pos, d1_g, d0_g)
    quads_c = torch.stack([s0[:, None].expand_as(qa), qa, s1_g, qb], dim=-1)
    # (L, cap, 4), in flat (s1-major, pair-minor) order = reference order

    # final selection: first max_quads valid, preserving order
    sel = nonzero_sized(ok, max_quads, cap)
    return QuadSet(
        quads=take(quads_c, sel.clamp(max=cap - 1)).to(torch.int32),
        valid=sel < cap,
        overflow=overflow.to(torch.int32),
    )
