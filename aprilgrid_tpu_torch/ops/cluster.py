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
"""

from __future__ import annotations

import torch


def _min_neighbors(lab: torch.Tensor, big: int) -> torch.Tensor:
    pad = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=big)
    up, down = pad[..., :-2, 1:-1], pad[..., 2:, 1:-1]
    left, right = pad[..., 1:-1, :-2], pad[..., 1:-1, 2:]
    return torch.minimum(
        torch.minimum(torch.minimum(up, down), torch.minimum(left, right)), lab
    )


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """Min-index labels of 4-connected components of an (H, W) ``mask``.

    Non-mask pixels carry the sentinel ``H*W``. Each round does three
    neighbour min-sweeps then one pointer jump; rounds repeat until a
    fixpoint (no cap: the kernel's union-find has none either)."""
    h, w = mask.shape
    hw = h * w
    idx = torch.arange(hw, device=mask.device).reshape(h, w)
    big = torch.full_like(idx, hw)
    lab = torch.where(mask, idx, big)
    while True:
        new = lab
        for _ in range(3):
            new = torch.where(mask, _min_neighbors(new, hw), big)
        flat = new.reshape(-1)
        jumped = flat[torch.clamp(flat, max=hw - 1)].reshape(h, w)
        new = torch.where(mask, torch.minimum(new, jumped), big)
        if torch.equal(new, lab):
            return lab
        lab = new


def cluster_centroids(mask: torch.Tensor):
    """Roots and centroids of the 4-connected components of an (H, W)
    ``mask``, in ascending root order (= the reference's scan-order
    cluster enumeration).

    Returns (root (K,) int64 linear indices, centers (K, 2) f32 (x, y)).
    The centroid is the plain mean: int64 sums over the f32 count."""
    h, w = mask.shape
    lab = label_components(mask)
    flat_mask = mask.reshape(-1)
    flat_lab = lab.reshape(-1)
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
