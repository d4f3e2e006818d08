"""Best-board search: seed selection + grouped board growth (the JAX
package's ``ops/search.py``).

The reference's try_find_best_board (src/detector.rs:588-639) histograms
saddle orientations, seeds from the largest bucket (popped back-to-front,
at most 30 seeds), grows a Board from every candidate quad of each seed,
keeps the first strictly-best score, and early-exits at score >= 36.

"First strictly-greater score" over an ordered candidate stream equals
"first maximum", so seeds go in small groups: all candidate quads of a
group grow jointly (``grow_boards_joint``) and the group loop early-exits
as the reference's seed loop does. Every frame of the batch runs its own
loop; the loop runs while any frame's does and freezes the others.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .board import BoardState, _any, _select, fix_missing, grow_boards_joint, knn_table
from .compact import nonzero_sized, take
from .geometry import rust_round
from .quads import init_quads


class SearchResult(NamedTuple):
    board: BoardState   # fields with a leading (B,) axis
    found: torch.Tensor  # (B,) bool


def _seed_order(theta: torch.Tensor, alive: torch.Tensor, max_seeds: int):
    """Seeds = members of the largest integer-theta histogram bucket,
    consumed from the back (src/detector.rs:601-617).

    Returns (seed_idx (B, max_seeds) int32, seed_ok (B, max_seeds))."""
    bsz, n = alive.shape
    bucket = (rust_round(theta).to(torch.int32) + 90).clamp(0, 180).long()
    counts = torch.zeros(bsz, 182, dtype=torch.int32, device=theta.device)
    counts.scatter_add_(1, torch.where(alive, bucket, 181),
                        torch.ones_like(bucket, dtype=torch.int32))
    best_bucket = torch.argmax(counts[:, :181], dim=-1)   # first maximum
    member = alive & (bucket == best_bucket[:, None])
    # descending index order: the first set entries of the reversed mask
    rev_idx = nonzero_sized(member.flip(-1), max_seeds, n)
    seed_ok = rev_idx < n
    seed_idx = torch.where(seed_ok, n - 1 - rev_idx, 0)
    return seed_idx.to(torch.int32), seed_ok


def find_best_board(
    p: torch.Tensor,
    theta: torch.Tensor,
    alive: torch.Tensor,
    spacing_ratio: float,
    grid_radius: int,
    nn: int,
    max_quads: int,
    max_boards: int,
    seeds_per_group: int,
    max_attempts: int,
    max_seeds: int,
    early_exit_score: int,
    knn_pool: int = 64,
) -> SearchResult:
    """try_find_best_board (src/detector.rs:588-639) on fixed-capacity
    tensors, per frame: ``p`` (B, N, 2), ``theta`` (B, N), ``alive`` (B, N)
    (the role of the re-filtered refined list)."""
    bsz, n = alive.shape
    dev = p.device
    g2 = (2 * grid_radius + 1) ** 2
    spg = seeds_per_group

    seed_idx, seed_ok = _seed_order(theta, alive, max_seeds)
    num_groups = -(-max_seeds // spg)
    knn = knn_table(p, alive, knn_pool)
    lanes_p = p.repeat_interleave(spg, 0)
    lanes_t = theta.repeat_interleave(spg, 0)

    best = BoardState(
        cell_quad=torch.full((bsz, g2, 4), -1, dtype=torch.int32, device=dev),
        placed=torch.zeros(bsz, g2, dtype=torch.bool, device=dev),
        failed=torch.zeros(bsz, g2, dtype=torch.bool, device=dev),
        active=alive,
        score=torch.zeros(bsz, dtype=torch.int32, device=dev),
        pruned=torch.zeros(bsz, dtype=torch.int32, device=dev),
    )
    gi = torch.zeros(bsz, dtype=torch.int64, device=dev)
    audit = torch.zeros(bsz, dtype=torch.int32, device=dev)
    frames = torch.arange(bsz, device=dev)

    while True:
        more = (gi < num_groups) & seed_ok[frames, (gi * spg).clamp(max=max_seeds - 1)]
        run = more & (best.score < early_exit_score)
        if not _any(run, "search_group"):
            break
        s_slots = gi[:, None] * spg + torch.arange(spg, device=dev)   # (B, spg)
        s_clip = s_slots.clamp(max=max_seeds - 1)
        s_ok = take(seed_ok, s_clip) & (s_slots < max_seeds)
        s_idx = take(seed_idx, s_clip)

        # candidate quads of all seeds in the group, seed-major order
        qs = init_quads(
            lanes_p, lanes_t, (alive[:, None] & s_ok[..., None]).reshape(bsz * spg, n),
            s_idx.reshape(-1).clamp(max=n - 1), nn, max_quads)
        flat_q = qs.quads.reshape(bsz, spg * max_quads, 4)
        flat_ok = (qs.valid.reshape(bsz, spg, max_quads) & s_ok[..., None]).reshape(bsz, -1)
        total = flat_ok.shape[1]
        sel = nonzero_sized(flat_ok, max_boards, total)
        b_ok = sel < total
        sel_safe = sel.clamp(max=total - 1)
        boards, grow_audit = grow_boards_joint(
            p, theta, knn, alive, take(flat_q, sel_safe), b_ok, alive, spacing_ratio,
            grid_radius, loop_attempts=max(256, max_attempts), running=run)
        # density audits accumulate over every candidate grown, not just
        # the winner; init_quads' compaction overflow rides the same channel
        audit_new = (audit + grow_audit
                     + torch.where(s_ok, qs.overflow.reshape(bsz, spg), 0).sum(-1)
                     ).to(torch.int32)
        scores = torch.where(b_ok, boards.score, 0)
        # the reference checks the early-exit score after each SEED's
        # candidate loop: restrict the argmax to candidates up to and
        # including the first seed whose running best crosses it
        # (src/detector.rs:622-630)
        seed_of = sel_safe // max_quads
        reached = torch.cummax(scores, dim=-1).values >= early_exit_score
        s_star = take(seed_of, torch.argmax(reached.to(torch.uint8), dim=-1))
        in_cut = torch.where(reached.any(-1, keepdim=True), seed_of <= s_star[:, None], True)
        j = torch.argmax(torch.where(in_cut, scores, -1), dim=-1)   # first max in cut
        cand = BoardState(*(x[frames, j] for x in boards))
        better = take(scores, j) > best.score
        best_new = _select(better, cand, best)
        best = _select(run, best_new, best)
        audit = torch.where(run, audit_new, audit)
        gi = torch.where(run, gi + 1, gi)

    found = best.score > 0
    best, fm_overflow = fix_missing(p, theta, best, alive, grid_radius)
    return SearchResult(board=best._replace(pruned=audit + fm_overflow), found=found)
