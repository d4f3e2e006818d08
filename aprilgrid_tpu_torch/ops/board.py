"""Board growth: associate saddles into a Kalibr AprilGrid (the JAX
package's ``ops/board.py``).

The reference grows a board from a seed quad by recursive depth-first
expansion over grid cells, extrapolating each quad edge outward by
(1 + spacing_ratio) and validating 3-nearest-neighbor candidate corners
(Board::try_expand / try_expand_one / find_closest_potential_saddle_idxs,
src/board.rs:114-234), then repairs interior holes from opposite
neighbors (try_fix_missing, src/board.rs:52-112).

The recursion becomes a parallel frontier: every (placed cell, direction)
pair on the frontier proposes an expansion each sweep, conflicts (two
proposals claiming the same target cell or the same saddle) are resolved
by proposal order, and sweeps repeat until no placement happens. The
geometric predicates match the reference exactly, so on clean data the
board is identical; only the traversal order differs.

Every function takes a leading frame axis B, each frame with its own
saddles (``p`` (B, N, 2), ``theta`` (B, N)). A loop runs while any frame's
condition holds and freezes the frames whose condition no longer holds,
as a vmapped ``lax.while_loop`` does, so each frame's result equals the
per-frame JAX function. The loop reads its condition on the host once a
sweep (``SYNCS`` counts those reads).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .compact import device_table, nonzero_sized, take
from .geometry import degrees, is_valid_quad_idx, radians, theta_distance_degree
from .quads import nearest_first

# direction -> (dx, dy) of the target cell, in reference order
# (src/board.rs:120-128): 0:+x, 1:-y, 2:-x, 3:+y
_DIRS = ((1, 0), (0, -1), (-1, 0), (0, 1))

# host reads of a loop condition, by loop: what the device search costs in
# host round trips. The caller zeroes and reads them around one detect on
# one thread: concurrent detects (the threads of detect_batch_sharded's xla
# branch) add into the same counts.
SYNCS = {"grow_sweep": 0, "search_group": 0, "grow_board_sweep": 0}


class BoardState(NamedTuple):
    cell_quad: torch.Tensor  # (..., G2, 4) int32 saddle indices, -1 if empty
    placed: torch.Tensor     # (..., G2) bool
    failed: torch.Tensor     # (..., G2) bool — attempted but not (yet) placed
    active: torch.Tensor     # (..., N) bool — saddles still claimable
    score: torch.Tensor      # (...) int32 — number of placed cells
    pruned: torch.Tensor     # (...) int32 — expansion attempts whose k-NN
    #                          pool may have missed a true 3-NN (an audit
    #                          counter, see propose_expansions)


def _select(keep: torch.Tensor, new, old):
    """Per frame: ``new``'s fields where ``keep`` (B,) holds, else ``old``'s."""
    return type(old)(*(
        torch.where(keep.view(-1, *([1] * (o.ndim - 1))), nw, o)
        for nw, o in zip(new, old)
    ))


def _any(x: torch.Tensor, counter: str) -> bool:
    """The host's read of a loop condition (one device sync)."""
    SYNCS[counter] += 1
    return bool(x.any())


@functools.lru_cache(maxsize=None)
def _neighbor_arrays(grid_radius: int) -> tuple[np.ndarray, np.ndarray]:
    """Static target-cell index map (G2, 4) plus in-grid mask."""
    g = 2 * grid_radius + 1
    g2 = g * g
    cells = np.arange(g2, dtype=np.int32)
    cx = cells % g
    cy = cells // g
    tgt = np.empty((g2, 4), np.int32)
    ok = np.empty((g2, 4), bool)
    for d, (dx, dy) in enumerate(_DIRS):
        tx = cx + dx
        ty = cy + dy
        inside = (tx >= 0) & (tx < g) & (ty >= 0) & (ty < g)
        tgt[:, d] = np.where(inside, ty * g + tx, g2)
        ok[:, d] = inside
    return tgt, ok


def _neighbors(grid_radius: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``_neighbor_arrays`` on ``device``, the target map as int64."""
    tgt, ok = device_table(_neighbor_arrays, (grid_radius,), device)
    return tgt.long(), ok


def knn_table(p: torch.Tensor, alive: torch.Tensor, k: int = 64) -> torch.Tensor:
    """(B, N, k) int32 nearest-neighbor index table over each frame's alive
    saddles (the reference rebuilds its kd-tree per round over the
    surviving list, src/detector.rs:592-595): a stable sort of the squared
    distances, so equal distances and dead saddles (``inf``) keep index
    order, as ``lax.top_k`` orders them.

    Expansion targets lie within ~2.3 tag-edge lengths of a source corner,
    so a target's true 3-NN is in the source's k-NN list at any realistic
    board density (see propose_expansions)."""
    dx = p[:, :, None, 0] - p[:, None, :, 0]
    dy = p[:, :, None, 1] - p[:, None, :, 1]
    d2 = torch.where(alive[:, None, :], dx * dx + dy * dy, torch.inf)
    return nearest_first(d2, k)[1].to(torch.int32)


def propose_expansions(
    p: torch.Tensor,
    theta: torch.Tensor,
    knn: torch.Tensor,
    alive: torch.Tensor,
    quads: torch.Tensor,
    active: torch.Tensor,
    spacing_ratio: float,
    act_off: torch.Tensor | None = None,
):
    """Batched try_expand_one (src/board.rs:153-234).

    ``quads``: (B, P, 4) rotated source quads [s0, s1, s2, s3]. Returns
    (new_quads (B, P, 4), valid (B, P), pool_overflow (B, P)) — the first
    valid candidate combo per proposal, in reference nesting order.
    Candidate search is pruned to the k-NN list of the edge endpoint
    nearest each extrapolated target.

    ``act_off``: optional (B, P) offsets into a flat ``active`` (B, M) of
    several concatenated per-board masks (grow_boards_joint); ``None``
    keeps one mask per frame.
    """
    bsz, n_p = quads.shape[:2]
    pq = take(p, quads)        # (B, P, 4, 2)
    t = take(theta, quads)     # (B, P, 4)
    ratio = 1.0 + spacing_ratio

    # edge s0->s1 extrapolates for new corners 0,1; edge s3->s2 for 3,2
    v01 = pq[:, :, 1] - pq[:, :, 0]
    v32 = pq[:, :, 2] - pq[:, :, 3]
    r01 = 0.5 * (v01[..., 0] * v01[..., 0] + v01[..., 1] * v01[..., 1])
    r32 = 0.5 * (v32[..., 0] * v32[..., 0] + v32[..., 1] * v32[..., 1])
    targets = torch.stack(
        [pq[:, :, 0] + v01 * ratio, pq[:, :, 1] + v01 * ratio,
         pq[:, :, 2] + v32 * ratio, pq[:, :, 3] + v32 * ratio],
        dim=2,
    )  # (B, P, 4, 2)
    radius_sq = torch.stack([r01, r01, r32, r32], dim=2)   # (B, P, 4)

    # candidate pools: corners 0/1 search s1's k-NN list, 2/3 s2's; each
    # pool is gathered once and broadcast to its two corners
    pool2 = torch.stack([take(knn, quads[..., 1]), take(knn, quads[..., 2])], dim=2)
    pool2_p = take(p, pool2)          # (B, P, 2, K, 2)
    pool2_alive = take(alive, pool2)  # (B, P, 2, K)

    def corners(x):  # pools (0, 1) -> corners (0, 0, 1, 1)
        return x[:, :, :, None].expand(*x.shape[:3], 2, *x.shape[3:]).flatten(2, 3)

    pool = corners(pool2)             # (B, P, 4, K)
    pool_p = corners(pool2_p)
    ex = pool_p[..., 0] - targets[:, :, :, None, 0]
    ey = pool_p[..., 1] - targets[:, :, :, None, 1]
    # the reference tree holds the round's surviving saddles (board-
    # consumed ones included — those are gated by `active` afterwards)
    d2 = torch.where(corners(pool2_alive), ex * ex + ey * ey, torch.inf)
    # 3-NN by three masked first-argmin passes (lax.top_k's order)
    slots, dists = [], []
    dcur = d2
    kk = torch.arange(d2.shape[-1], device=p.device)
    for _ in range(3):
        s = torch.argmin(dcur, dim=-1)
        slots.append(s)
        dists.append(torch.gather(dcur, -1, s[..., None])[..., 0])
        dcur = torch.where(kk == s[..., None], torch.inf, dcur)
    slot = torch.stack(slots, dim=-1)           # (B, P, 4, 3) nearest-first
    dist_sq = torch.stack(dists, dim=-1)
    idx = torch.gather(pool, -1, slot)
    t_cand = take(theta, idx)                   # (B, P, 4, 3)
    p_cand = torch.gather(pool_p, 3, slot[..., None].expand(*slot.shape, 2))
    if act_off is None:
        act = take(active, idx)
    else:
        act = take(active, idx + act_off[:, :, None, None])
    ok = (
        torch.isfinite(dist_sq)
        & (dist_sq <= radius_sq[..., None])
        & act
        & (theta_distance_degree(t[..., None], t_cand) < 5.0)
    )

    # Density-assumption audit: the pruned query equals the reference's
    # global 3-NN when no un-pooled saddle can displace one of the 3 picks
    # — every point closer to the target than the 3rd pick is in the pool
    # when dist(endpoint, target) + d3 <= pool radius, or when the pool
    # holds every alive saddle. Uncertified attempts are counted.
    endpoints2 = torch.stack([pq[:, :, 1], pq[:, :, 2]], dim=2)   # (B, P, 2, 2)
    ux = pool2_p[..., 0] - endpoints2[..., None, 0]
    uy = pool2_p[..., 1] - endpoints2[..., None, 1]
    r_pool = corners(torch.sqrt(torch.where(pool2_alive, ux * ux + uy * uy, 0.0).amax(-1)))
    et = targets - corners(endpoints2)
    d_et = torch.sqrt(et[..., 0] * et[..., 0] + et[..., 1] * et[..., 1])
    d3 = torch.sqrt(torch.clamp(dist_sq[..., 2], max=1e30))
    everyone = (alive.sum(-1) <= pool.shape[-1])[:, None, None]
    covered = (d_et + d3 <= r_pool) | everyone
    pool_overflow = (~covered).any(-1)          # (B, P)

    # compact each 3-candidate list (the reference iterates passing
    # entries in distance order, src/board.rs:197-232)
    order = torch.argsort((~ok).to(torch.uint8), dim=-1, stable=True)
    idx = torch.gather(idx, -1, order)
    ok = torch.gather(ok, -1, order)
    t_cand = torch.gather(t_cand, -1, order)
    p_cand = torch.gather(p_cand, 3, order[..., None].expand(*order.shape, 2))

    # -- is_valid_quad over the 3^4 candidate combos, decomposed: every
    # gate term depends on at most 3 of the 4 corners, so each is
    # evaluated once on a (3, 3[, 3]) slot table with is_valid_quad's f32
    # op sequences (bit-identical) and the 81 combos AND the tables. From
    # here on proposals are independent: frames and proposals share one
    # axis Q. New quad = [s0, d0, s1, d1] = candidate corners [0, 1, 2, 3],
    # combo axes (i, j, k, l) for corners 0..3.
    nq = bsz * n_p
    p_cand = p_cand.reshape(nq, 4, 3, 2)
    t_cand = t_cand.reshape(nq, 4, 3)
    ok = ok.reshape(nq, 4, 3)
    idx = idx.reshape(nq, 4, 3)
    p0c, p1c, p2c, p3c = (p_cand[:, c] for c in range(4))   # (Q, 3, 2)

    def edge(pa_, pb_):  # pb[b] - pa[a] -> (Q, a, b, 2)
        return pb_[:, None, :, :] - pa_[:, :, None, :]

    e01 = edge(p0c, p1c)  # axes (i, j)
    e02 = edge(p0c, p2c)  # (i, k)
    e03 = edge(p0c, p3c)  # (i, l)
    e12 = edge(p1c, p2c)  # (j, k)
    e23 = edge(p2c, p3c)  # (k, l)
    e30 = edge(p3c, p0c)  # (l, i)

    def crs(u, v):
        """cross over chained edge tables: u (Q, a, s, 2), v (Q, s, b, 2)
        -> (Q, a, s, b), the mul/mul/sub sequence of geometry.cross."""
        return (u[:, :, :, None, 0] * v[:, None, :, :, 1]
                - u[:, :, :, None, 1] * v[:, None, :, :, 0])

    def dt_(u, v):
        return (u[:, :, :, None, 0] * v[:, None, :, :, 0]
                + u[:, :, :, None, 1] * v[:, None, :, :, 1])

    def ang(c, d):
        return degrees(torch.atan2(c, d))

    def swap12(x):  # (Q, a, b, ...) -> (Q, b, a, ...)
        return x.transpose(1, 2)

    # c0 = cross(v01, v02): both edges start at corner 0, so feed v01
    # with axes swapped to (j, i) and swap back -> (Q, i, j, k)
    c0x = swap12(crs(swap12(e01), e02))
    c1x = swap12(crs(swap12(e02), e03))      # cross(v02, v03) -> (Q, i, k, l)
    c01x = crs(e01, e12)                     # (Q, i, j, k): share j
    c12x = crs(e12, e23)                     # (Q, j, k, l): share k
    a0 = ang(c01x, dt_(e01, e12))            # (Q, i, j, k)
    a1 = ang(c12x, dt_(e12, e23))            # (Q, j, k, l)
    a2 = ang(crs(e23, e30), dt_(e23, e30))   # (Q, k, l, i)
    a3 = ang(crs(e30, e01), dt_(e30, e01))   # (Q, l, i, j)
    dd01 = swap12(dt_(swap12(e01), e02))     # dot(v01, v02) -> (Q, i, j, k)
    dd30 = swap12(dt_(swap12(e03), e02))     # dot(v03, v02) -> (Q, i, l, k)

    # theta gate (d0 vs d1) -> (Q, j, l)
    th9 = theta_distance_degree(t_cand[:, 1, :, None], t_cand[:, 3, None, :]) <= 5.0
    # white-block: |angle(v02, theta-dir(s0))| in [60, 120] -> (Q, i, k)
    rad = radians(t_cand[:, 0])              # (Q, 3)
    vtx, vty = torch.cos(rad)[:, :, None], torch.sin(rad)[:, :, None]
    wang = torch.abs(ang(e02[..., 0] * vty - e02[..., 1] * vtx,
                         e02[..., 0] * vtx + e02[..., 1] * vty))
    w9 = (wang >= 60.0) & (wang <= 120.0)

    # combine on (Q, i, j, k, l); row-major flattening = the reference's
    # idx0-outermost..idx3-innermost nesting (src/board.rs:160-163)
    ok_q = (
        th9[:, None, :, None, :]
        & w9[:, :, None, :, None]
        & (c0x[..., None] * c1x[:, :, None, :, :] >= 0.0)
        & (c01x[..., None] * c12x[:, None, :, :, :] >= 0.0)
        & (torch.abs(a0[..., None] - a2.permute(0, 3, 1, 2)[:, :, None]) <= 10.0)
        & (torch.abs(a1[:, None] - a3.permute(0, 2, 3, 1)[:, :, :, None, :]) <= 10.0)
        & (dd01[..., None] >= 0.0)
        & (dd30.permute(0, 1, 3, 2)[:, :, None] >= 0.0)
        & ok[:, 0, :, None, None, None]
        & ok[:, 1, None, :, None, None]
        & ok[:, 2, None, None, :, None]
        & ok[:, 3, None, None, None, :]
    )
    cand_ok = ok_q.reshape(nq, 81)

    first = torch.argmax(cand_ok.to(torch.uint8), dim=-1)   # first valid combo
    picks = torch.stack([first // 27, (first // 9) % 3, (first // 3) % 3, first % 3], -1)
    new_quads = torch.gather(idx, -1, picks[..., None])[..., 0]
    return (new_quads.reshape(bsz, n_p, 4), cand_ok.any(-1).reshape(bsz, n_p),
            pool_overflow)


def resolve_conflicts(
    tgt: torch.Tensor,
    quad: torch.Tensor,
    valid: torch.Tensor,
    n: int,
    g2: int,
) -> torch.Tensor:
    """Order-priority conflict resolution per frame: a valid proposal is
    deferred when any EARLIER valid proposal shares its target cell or a
    saddle (the reference's sequential expansion order,
    src/board.rs:114-152). ``tgt`` (B, P) in [0, g2], ``quad`` (B, P, 4)
    in [0, n).

    Scatter-min "claims": each valid proposal stamps its index onto its 4
    saddles and its target cell (invalid ones onto sink slots n and g2);
    proposal i is blocked iff one of its resources carries a claim < i.
    The accept set of the pairwise formulation
    (``resolve_conflicts_dense``) at O(P) cost."""
    bsz, n_p = tgt.shape
    p_idx = torch.arange(n_p, device=tgt.device).expand(bsz, n_p)
    quad = quad.long()
    claim_s = torch.full((bsz, n + 1), n_p, dtype=torch.int64, device=tgt.device)
    claim_s.scatter_reduce_(
        1, torch.where(valid[..., None], quad, n).reshape(bsz, -1),
        p_idx[..., None].expand(bsz, n_p, 4).reshape(bsz, -1), "amin")
    claim_t = torch.full((bsz, g2 + 1), n_p, dtype=torch.int64, device=tgt.device)
    claim_t.scatter_reduce_(1, torch.where(valid, tgt.long(), g2), p_idx, "amin")
    blocked = (take(claim_s, quad).amin(-1) < p_idx) | (
        take(claim_t, tgt.long().clamp(max=g2)) < p_idx
    )
    return valid & ~blocked


def resolve_conflicts_dense(
    tgt: torch.Tensor, quad: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """The O(P^2) pairwise formulation, kept as the equivalence oracle of
    ``resolve_conflicts``."""
    same_tgt = tgt[:, :, None] == tgt[:, None, :]
    share = (quad[:, :, None, :, None] == quad[:, None, :, None, :]).any(-1).any(-1)
    p_idx = torch.arange(tgt.shape[1], device=tgt.device)
    earlier = (p_idx[None, :] < p_idx[:, None])[None] & valid[:, None, :]
    blocked = (earlier & (same_tgt | share)).any(-1)
    return valid & ~blocked


def _scatter_set(x: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """Per frame: a copy of ``x`` (B, M, *rest) with ``x[b, idx[b, i]] =
    value[b, i]`` (or the scalar ``value``). Indices may repeat only where
    they write equal values, or a sink slot the caller discards."""
    bsz = x.shape[0]
    flat_idx = idx.reshape(bsz, -1).long()
    if x.ndim == 3:
        flat_idx = flat_idx[..., None].expand(-1, -1, x.shape[2])
    out = x.clone()
    if isinstance(value, torch.Tensor):
        return out.scatter_(1, flat_idx, value.reshape(flat_idx.shape).to(x.dtype))
    return out.scatter_(1, flat_idx, value)


class _Growth(NamedTuple):
    cell_quad: torch.Tensor   # (B, MB*G2 + 1, 4) int32, the last row a sink
    placed: torch.Tensor      # (B, MB*G2 + 1) bool
    failed: torch.Tensor      # (B, MB*G2 + 1) bool
    active: torch.Tensor      # (B, MB*N + 1) bool
    progressed: torch.Tensor  # (B,) bool
    it: torch.Tensor          # (B,) int32 sweeps taken
    audit: torch.Tensor       # (B,) int32


def grow_board(
    p: torch.Tensor,
    theta: torch.Tensor,
    knn: torch.Tensor,
    alive: torch.Tensor,
    seed_quad: torch.Tensor,
    seed_valid: torch.Tensor,
    active_in: torch.Tensor,
    spacing_ratio: float,
    grid_radius: int,
    max_attempts: int = 64,
    max_sweeps: int = 32,
) -> BoardState:
    """Grow one board per frame from a seed quad (Board::new,
    src/board.rs:27-48): ``seed_quad`` (B, 4), ``seed_valid`` (B,). The
    per-board formulation, kept as the oracle of ``grow_boards_joint``.
    Its sweeps run in lockstep until every board has quiesced."""
    g = 2 * grid_radius + 1
    g2 = g * g
    center = grid_radius * g + grid_radius
    bsz, n = alive.shape
    dev = p.device
    tgt_map, tgt_ok = _neighbors(grid_radius, dev)
    tgt_all = tgt_map.reshape(-1)
    tgt_safe = tgt_map.clamp(max=g2 - 1)

    # one sink row past each array, which scatters of dropped entries hit
    cell_quad = torch.full((bsz, g2 + 1, 4), -1, dtype=torch.int32, device=dev)
    cell_quad[:, center] = seed_quad.to(torch.int32)
    placed = torch.zeros(bsz, g2 + 1, dtype=torch.bool, device=dev)
    placed[:, center] = seed_valid
    failed = torch.zeros_like(placed)
    # seed consumes quad[1:] only (src/board.rs:34-36)
    used = torch.where(seed_valid[:, None], seed_quad[:, 1:].long(), n)
    active = _scatter_set(torch.cat([active_in, active_in[:, :1]], 1), used, False)

    def sweep(st: _Growth) -> _Growth:
        # frontier attempts: placed cell x direction with an untried
        # target, cell-major / direction-minor; failed cells are never
        # retried (src/board.rs:148)
        pl, fl = st.placed[:, :g2], st.failed[:, :g2]
        attempt = (pl[:, :, None] & tgt_ok & ~pl[:, tgt_safe] & ~fl[:, tgt_safe])
        attempt = attempt.reshape(bsz, -1)
        total = attempt.shape[1]
        sel = nonzero_sized(attempt, max_attempts, total)
        live = sel < total
        safe = sel.clamp(max=total - 1)
        tgt = torch.where(live, tgt_all[safe], g2)
        cell = safe // 4
        d = safe % 4
        four = torch.arange(4, device=dev)
        rot = torch.gather(take(st.cell_quad, cell), -1, (d[..., None] + four) % 4)
        # a dead slot may read an empty cell's -1 quad: clamp for safe
        # gathers (its validity is masked off below)
        new_q, valid, pool_ovf = propose_expansions(
            p, theta, knn, alive, rot.clamp(min=0), st.active[:, :n], spacing_ratio)
        valid = valid & live
        audit = st.audit + (pool_ovf & live).sum(-1).to(torch.int32)
        quad = torch.gather(new_q, -1, (four - d[..., None]) % 4)
        accept = resolve_conflicts(tgt, quad, valid, n, g2)
        scatter_tgt = torch.where(accept, tgt, g2)
        cq = _scatter_set(st.cell_quad, scatter_tgt, quad)
        pl2 = _scatter_set(st.placed, scatter_tgt, True)
        act = _scatter_set(st.active, torch.where(accept[..., None], quad, n), False)
        new_failed = _scatter_set(st.failed, torch.where(live & ~valid, tgt, g2), True)
        progressed = accept.any(-1) | (new_failed[:, :g2] != st.failed[:, :g2]).any(-1)
        return _Growth(cq, pl2, new_failed, act, progressed, st.it + 1, audit)

    zero = torch.zeros(bsz, dtype=torch.int32, device=dev)
    st = _Growth(cell_quad, placed, failed, active, seed_valid.clone(), zero, zero)
    while True:
        run = st.progressed & (st.it < max_sweeps)
        if not _any(run, "grow_board_sweep"):
            break
        st = _select(run, sweep(st), st)
    pl = st.placed[:, :g2]
    return BoardState(
        cell_quad=st.cell_quad[:, :g2],
        placed=pl,
        failed=st.failed[:, :g2] & ~pl,
        active=st.active[:, :n],
        score=pl.sum(-1).to(torch.int32),
        pruned=st.audit,
    )


def grow_boards_joint(
    p: torch.Tensor,
    theta: torch.Tensor,
    knn: torch.Tensor,
    alive: torch.Tensor,
    seed_quads: torch.Tensor,
    seed_ok: torch.Tensor,
    active_in: torch.Tensor,
    spacing_ratio: float,
    grid_radius: int,
    loop_attempts: int = 256,
    max_sweeps: int = 160,
    running: torch.Tensor | None = None,
):
    """Grow MB candidate boards per frame JOINTLY through one shared
    compacted frontier (Board::new semantics per board,
    src/board.rs:27-48): ``seed_quads`` (B, MB, 4), ``seed_ok`` (B, MB).

    Every sweep compacts the live (board, cell, dir) attempts of all
    boards of a frame into one proposal axis: sweep 1 at full width 4*MB
    (each candidate attempts its center cell's four directions), later
    sweeps at ``loop_attempts`` width. Overflow defers attempts to the
    next sweep (a failure mark keeps the loop alive); attempts still live
    when ``max_sweeps`` fires are dropped and counted into the audit.
    Boards stay independent: per-board claim keys in the conflict
    resolution, per-board active masks (flat (MB*N,) with per-proposal
    offsets). With no loop-width overflow every board equals
    ``grow_board``'s, bit for bit.

    ``running`` (B,), where given, marks the frames whose result the caller
    keeps: the others stop sweeping (their result is then not the
    function's).

    Returns (BoardState with (B, MB) leading axes and zeroed pruned, audit
    (B,) int32: kNN-pool prunes over live proposals + attempts dropped at
    the sweep bound)."""
    g = 2 * grid_radius + 1
    g2 = g * g
    center = grid_radius * g + grid_radius
    bsz, n = alive.shape
    mb = seed_quads.shape[1]
    dev = p.device
    tgt_map, tgt_ok = _neighbors(grid_radius, dev)
    tgt_map_flat = tgt_map.reshape(-1)
    tgt_safe = tgt_map.clamp(max=g2 - 1)
    boards = torch.arange(mb, device=dev)

    # flat per-frame state with one trailing sink slot
    cell_quad = torch.full((bsz, mb * g2 + 1, 4), -1, dtype=torch.int32, device=dev)
    cell_quad[:, boards * g2 + center] = seed_quads.to(torch.int32)
    placed = torch.zeros(bsz, mb * g2 + 1, dtype=torch.bool, device=dev)
    placed[:, boards * g2 + center] = seed_ok
    failed = torch.zeros_like(placed)
    # seed consumes quad[1:] only (src/board.rs:34-36)
    active = torch.cat([active_in.repeat(1, mb), active_in.new_zeros(bsz, 1)], 1)
    seed_used = torch.where(seed_ok[..., None], boards[:, None] * n + seed_quads[..., 1:].long(),
                            mb * n)
    active = _scatter_set(active, seed_used, False)

    def process(st: _Growth, b, cell, d, live) -> _Growth:
        """One sweep's proposal batch (B, P): propose + conflicts + apply.
        (b, cell, d) in board-major / cell-major / dir-minor order — each
        board's priority order is grow_board's."""
        tgt_local = torch.where(live, tgt_map_flat[cell * 4 + d], g2)
        four = torch.arange(4, device=dev)
        src = take(st.cell_quad, torch.where(live, b * g2 + cell, mb * g2))
        rot = torch.gather(src, -1, (d[..., None] + four) % 4)
        # dead slots carry -1 quads; clamp for safe gathers (their
        # validity is masked off below)
        new_q, valid, pool_ovf = propose_expansions(
            p, theta, knn, alive, rot.clamp(min=0), st.active, spacing_ratio,
            act_off=b * n)
        valid = valid & live & (rot >= 0).all(-1)
        audit = st.audit + (pool_ovf & live).sum(-1).to(torch.int32)
        quad = torch.gather(new_q, -1, (four - d[..., None]) % 4).long()
        in_grid = tgt_local < g2
        # per-board claim keys: boards never contend with each other
        accept = resolve_conflicts(
            torch.where(in_grid, b * g2 + tgt_local, mb * g2),
            b[..., None] * n + quad, valid, mb * n, mb * g2)
        scatter_tgt = torch.where(accept, b * g2 + tgt_local, mb * g2)
        cq = _scatter_set(st.cell_quad, scatter_tgt, quad)
        pl = _scatter_set(st.placed, scatter_tgt, True)
        act = _scatter_set(
            st.active, torch.where(accept[..., None], b[..., None] * n + quad, mb * n), False)
        fail_t = torch.where(live & ~valid & in_grid, b * g2 + tgt_local, mb * g2)
        new_failed = _scatter_set(st.failed, fail_t, True)
        progressed = accept.any(-1) | (new_failed != st.failed).any(-1)
        return _Growth(cq, pl, new_failed, act, progressed, st.it + 1, audit)

    def attempts(placed, failed):
        pl = placed[:, : mb * g2].reshape(bsz, mb, g2)
        fl = failed[:, : mb * g2].reshape(bsz, mb, g2)
        return (pl[..., None] & tgt_ok & ~pl[:, :, tgt_safe] & ~fl[:, :, tgt_safe]
                ).reshape(bsz, -1)

    # -- sweep 1 at full width: all centers x 4 directions
    b1 = boards.repeat_interleave(4).expand(bsz, -1)
    cell1 = torch.full_like(b1, center)
    d1 = torch.arange(4, device=dev).repeat(mb).expand(bsz, -1)
    zero = torch.zeros(bsz, dtype=torch.int32, device=dev)
    st = _Growth(cell_quad, placed, failed, active, seed_ok.any(-1), zero + 1, zero)
    st = process(st, b1, cell1, d1, take(seed_ok, b1))

    # -- remaining sweeps on the compacted live frontier
    total = mb * g2 * 4
    while True:
        run = st.progressed & (st.it < max_sweeps)
        if running is not None:
            run = run & running
        if not _any(run, "grow_sweep"):
            break
        sel = nonzero_sized(attempts(st.placed, st.failed), loop_attempts, total)
        live = sel < total
        safe = sel.clamp(max=total - 1)
        rem = safe % (g2 * 4)
        st = _select(run, process(st, safe // (g2 * 4), rem // 4, rem % 4, live), st)
    # attempts still live when the sweep bound fired are dropped work; a
    # quiesced frame has none
    audit = st.audit + attempts(st.placed, st.failed).sum(-1).to(torch.int32)

    placed2 = st.placed[:, : mb * g2].reshape(bsz, mb, g2)
    return BoardState(
        cell_quad=st.cell_quad[:, : mb * g2].reshape(bsz, mb, g2, 4),
        placed=placed2,
        failed=st.failed[:, : mb * g2].reshape(bsz, mb, g2) & ~placed2,
        active=st.active[:, : mb * n].reshape(bsz, mb, n),
        score=placed2.sum(-1).to(torch.int32),
        pruned=torch.zeros(bsz, mb, dtype=torch.int32, device=dev),
    ), audit


def fix_missing(p: torch.Tensor, theta: torch.Tensor, board: BoardState,
                alive: torch.Tensor, grid_radius: int):
    """Repair holes whose opposite neighbors are both placed
    (try_fix_missing, src/board.rs:52-112), per frame: ``board``'s fields
    with a leading (B,) axis. Returns (board, overflow (B,) int32: fixable
    holes beyond the 32-cell repair capacity)."""
    g = 2 * grid_radius + 1
    g2 = g * g
    bsz = alive.shape[0]
    present = board.placed | board.failed
    tgt_map, tgt_ok = _neighbors(grid_radius, p.device)

    def nb(d):
        return tgt_map[:, d].clamp(max=g2 - 1), tgt_ok[:, d]

    t_px, ok_px = nb(0)   # +x
    t_mx, ok_mx = nb(2)   # -x
    t_py, ok_py = nb(3)   # +y
    t_my, ok_my = nb(1)   # -y

    hole = board.failed
    h_present = ok_px & present[:, t_px] & ok_mx & present[:, t_mx]
    h_ok = h_present & board.placed[:, t_px] & board.placed[:, t_mx]
    v_present = ok_py & present[:, t_py] & ok_my & present[:, t_my]
    v_ok = v_present & board.placed[:, t_py] & board.placed[:, t_my]
    # reference elif: horizontal presence shadows the vertical branch
    use_h = hole & h_present & h_ok
    use_v = hole & ~h_present & v_present & v_ok
    fix = use_h | use_v

    # compact the fixable holes (a real board repairs a handful); an
    # overflow drops the excess repairs and is counted
    cap = 32
    cells = nonzero_sized(fix, cap, g2)
    live = cells < g2
    safe = cells.clamp(max=g2 - 1)
    overflow = (fix.sum(-1) - live.sum(-1)).to(torch.int32)

    h = take(use_h, safe)
    b0 = torch.where(h, t_px[safe], t_py[safe])
    b1 = torch.where(h, t_mx[safe], t_my[safe])
    q0 = take(board.cell_quad, b0).long()   # (B, cap, 4)
    q1 = take(board.cell_quad, b1).long()
    mid = (take(p, q0.clamp(min=0)) + take(p, q1.clamp(min=0))) / 2.0

    # 1-NN over the round's alive saddles — the reference queries the
    # kd-tree without the board-active gate (src/board.rs:88)
    dx = p[:, None, None, :, 0] - mid[..., None, 0]
    dy = p[:, None, None, :, 1] - mid[..., None, 1]
    d2 = torch.where(alive[:, None, None, :], dx * dx + dy * dy, torch.inf)
    nearest = torch.argmin(d2, dim=-1)   # (B, cap, 4)

    good = live & is_valid_quad_idx(p, theta, nearest)
    tgt_cells = torch.where(good, safe, g2)

    def put(x, value):
        sink = torch.cat([x, x[:, :1]], 1)
        return _scatter_set(sink, tgt_cells, value)[:, :g2]

    return board._replace(
        cell_quad=put(board.cell_quad, nearest),
        placed=put(board.placed, True),
        failed=put(board.failed, False),
    ), overflow
