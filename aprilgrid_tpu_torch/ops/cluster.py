"""Connected-component saddle clustering (plain version).

The reference flood-fills each below-threshold response region with a
destructive stack BFS (pixel_bfs, src/image_util.rs:208-236; driver
src/detector.rs:171-187) and takes per-cluster centroids
(src/detector.rs:421-429). Here:

1. each masked pixel is labelled with its linear index and relaxed to the
   component minimum by 4-neighbour min-propagation plus pointer jumping,
   to a fixpoint;
2. the component roots (pixels whose label is their own index) come out
   in ascending linear order, which equals the reference's scan-order
   cluster ordering (first cluster pixel met = minimum linear index);
3. centroid = integer sums of the member rows and columns over the member
   count, divided in f32 — independent of summation order.

These are the building blocks of ``kernels/cluster.py``'s plain version;
the CUDA kernel computes the same labels by union-find.

``cluster_centroids_bounded`` is the plane path's clustering (the JAX
package's capacity-bound ``cluster_centroids``): the same labels and
centroids at fixed capacities — the first ``max_clusters`` roots, the
first ``max_masked`` masked pixels, at most ``max_rounds`` labeling
rounds — over a whole (B, H, W) batch at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Clusters(NamedTuple):
    centers: torch.Tensor  # (B, MC, 2) float32 (x, y) centroids
    valid: torch.Tensor    # (B, MC) bool


def _min_neighbors(lab: torch.Tensor, big: int) -> torch.Tensor:
    pad = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=big)
    up, down = pad[..., :-2, 1:-1], pad[..., 2:, 1:-1]
    left, right = pad[..., 1:-1, :-2], pad[..., 1:-1, 2:]
    return torch.minimum(
        torch.minimum(torch.minimum(up, down), torch.minimum(left, right)), lab
    )


def label_components(mask: torch.Tensor, max_rounds: int | None = None) -> torch.Tensor:
    """Min-index labels of the 4-connected components of ``mask``, (H, W)
    or (B, H, W) — one loop labels every frame of a batch.

    A masked pixel carries the smallest linear index ``row * W + col`` of
    its component, a non-mask pixel the sentinel ``H*W``. Each round does
    three neighbour min-sweeps then one pointer jump; rounds repeat until
    a fixpoint, or ``max_rounds`` of them (``None``: no cap, as the
    kernel's union-find has none). The labels are int32: the whole mask
    must hold fewer than 2^31 pixels (``ValueError`` beyond)."""
    h, w = mask.shape[-2:]
    hw = h * w
    total = mask.numel()
    if total >= 2**31:
        raise ValueError(
            f"label_components: {tuple(mask.shape)} holds {total} pixels, int32 "
            "labels take fewer than 2^31; label fewer frames at a time"
        )
    # one index space over the whole batch: frame b owns [b*hw, (b+1)*hw),
    # the sweeps stay inside a frame, so no component crosses frames
    idx = torch.arange(total, device=mask.device, dtype=torch.int32).reshape(mask.shape)
    big = torch.full_like(idx, total)
    lab = torch.where(mask, idx, big)
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        new = lab
        for _ in range(3):
            new = torch.where(mask, _min_neighbors(new, total), big)
        flat = new.reshape(-1)
        jumped = flat.index_select(0, torch.clamp(flat, max=total - 1)).reshape(mask.shape)
        new = torch.where(mask, torch.minimum(new, jumped), big)
        rounds += 1
        if torch.equal(new, lab):
            break
        lab = new
    frame0 = idx.reshape(-1, hw)[:, :1].reshape(mask.shape[:-2] + (1, 1))
    return torch.where(mask, lab - frame0, torch.full_like(lab, hw))


def cluster_centroids(mask: torch.Tensor):
    """Roots and centroids of the 4-connected components of an (H, W)
    ``mask``, in ascending root order (= the reference's scan-order
    cluster enumeration).

    Returns (root (K,) int64 linear indices, centers (K, 2) f32 (x, y)).
    The centroid is the plain mean: int64 sums over the f32 count."""
    h, w = mask.shape
    lab = label_components(mask)
    flat_mask = mask.reshape(-1)
    flat_lab = lab.reshape(-1).to(torch.int64)
    idx = torch.arange(h * w, device=mask.device)
    root = torch.nonzero(flat_mask & (flat_lab == idx)).reshape(-1)
    slot_of = torch.full((h * w,), -1, dtype=torch.int64, device=mask.device)
    slot_of[root] = torch.arange(root.numel(), device=mask.device)
    members = torch.nonzero(flat_mask).reshape(-1)
    slot = slot_of[flat_lab[members]]
    k = root.numel()
    zeros = torch.zeros(k, dtype=torch.int64, device=mask.device)
    cnt = zeros.index_add(0, slot, torch.ones_like(members))
    sum_r = zeros.index_add(0, slot, members // w)
    sum_c = zeros.index_add(0, slot, members % w)
    cntf = cnt.to(torch.float32)
    centers = torch.stack(
        [sum_c.to(torch.float32) / cntf, sum_r.to(torch.float32) / cntf], -1
    )
    return root, centers


def _first_nonzero(flags: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """(B, N) bool -> (B, size) int64: per row the indices of the first
    ``size`` set flags in ascending order, the rest ``fill``."""
    bi, ii = torch.nonzero(flags, as_tuple=True)  # row-major: ascending per row
    counts = flags.sum(1)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(bi.numel(), device=flags.device) - start[bi]
    keep = rank < size
    out = torch.full((flags.shape[0], size), fill, dtype=torch.int64, device=flags.device)
    out[bi[keep], rank[keep]] = ii[keep]
    return out


def component_centroids_bounded(mask: torch.Tensor, lab: torch.Tensor,
                                max_clusters: int, max_masked: int,
                                row_range: tuple[int, int] | None = None) -> Clusters:
    """Per-component centroids from (B, H, W) labels at fixed capacities,
    in ascending root order: the first ``max_clusters`` roots get a slot,
    and only the first ``max_masked`` masked pixels (scan order)
    contribute — a pixel whose root has no slot is dropped. The sums are
    integers, converted to f32 for the divide (equal to f32 accumulation
    while a sum stays below 2^24). ``row_range=(lo, hi)`` keeps only the
    components whose root row lies in [lo, hi): a row-sharded window
    claims the blobs whose root (topmost pixel) is in its own band."""
    b, h, w = mask.shape
    hw = h * w
    dev = mask.device
    flat_mask = mask.reshape(b, hw)
    flat_lab = lab.reshape(b, hw).to(torch.int64)
    idx = torch.arange(hw, device=dev)
    root = flat_mask & (flat_lab == idx)
    if row_range is not None:
        root &= (idx // w >= row_range[0]) & (idx // w < row_range[1])
    root_idx = _first_nonzero(root, max_clusters, hw)
    masked_idx = _first_nonzero(flat_mask, max_masked, hw)
    pixel_valid = masked_idx < hw
    safe_idx = torch.clamp(masked_idx, max=hw - 1)
    pix_lab = torch.gather(flat_lab, 1, safe_idx)

    # map each pixel's root label to its compact cluster slot
    slot = torch.clamp(torch.searchsorted(root_idx, pix_lab), max=max_clusters - 1)
    hit = pixel_valid & (torch.gather(root_idx, 1, slot) == pix_lab)
    slot = torch.where(hit, slot, torch.full_like(slot, max_clusters))  # misses

    one = hit.to(torch.int64)
    sums = torch.zeros((b, max_clusters + 1, 3), dtype=torch.int64, device=dev)
    vals = torch.stack([(safe_idx % w) * one, (safe_idx // w) * one, one], -1)
    sums.scatter_add_(1, slot[..., None].expand(-1, -1, 3), vals)
    sums = sums[:, :max_clusters].to(torch.float32)
    cnt = torch.clamp(sums[..., 2], min=1.0)
    centers = torch.stack([sums[..., 0] / cnt, sums[..., 1] / cnt], -1)
    return Clusters(centers=centers, valid=(root_idx < hw) & (sums[..., 2] > 0))


def cluster_centroids_bounded(resp: torch.Tensor, threshold_ratio: float,
                              max_clusters: int, max_masked: int,
                              max_rounds: int) -> Clusters:
    """Centroids of the {resp < ratio * min(resp)} components of (B, H, W)
    response planes, each frame against its own minimum
    (src/detector.rs:414-429), at fixed capacities."""
    thr = resp.amin((-2, -1), keepdim=True) * threshold_ratio
    mask = resp < thr
    lab = label_components(mask, max_rounds)
    return component_centroids_bounded(mask, lab, max_clusters, max_masked)
