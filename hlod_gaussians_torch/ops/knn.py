"""Approximate k-nearest-neighbor mean squared distance for scale init
(port of hlod_gaussians_tpu/ops/knn.py; replaces the reference's
`distCUDA2`, scene/gaussian_model.py:848-852).

The same shifted space-filling-curve scheme as the JAX package: sort the
points along `shifts` translated Morton curves and take the k best among
the +/- `window` rank-neighbors on every curve.
"""

from __future__ import annotations

import torch

from hlod_gaussians_torch.ops.morton import morton_argsort


def knn_mean_sq_dist(points, k: int = 3, window: int = 16, shifts: int = 3):
    """[N, 3] float32 -> [N] mean squared distance to the k nearest
    candidates (distCUDA2 semantics)."""
    n = points.shape[0]
    dev = points.device
    lo = points.min(dim=0).values
    hi = points.max(dim=0).values
    extent = torch.clamp_min(hi - lo, 1e-12)

    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])
    self_idx = torch.arange(n, device=dev)

    cand_list = []
    for s in range(shifts):
        # translate the points but keep the grid anchored at `lo`, so each
        # pass sees different cell boundaries
        shift = (s * 0.38196601) * extent
        # each axis's largest point stays in the last cell: the reference's
        # quantization sends it to code 0 on every curve, far from all of
        # its neighbours, and the JAX package reports a distance of whole
        # scene units for those points (their Gaussians cover the frame)
        perm = morton_argsort(points + shift, lo=lo, hi=hi + shift)
        inv = torch.empty_like(perm)
        inv[perm] = self_idx
        pos = inv[:, None] + offs[None, :]
        ok = (pos >= 0) & (pos < n)
        cand = perm[pos.clamp(0, n - 1)]
        cand_list.append(torch.where(ok, cand, torch.full_like(cand, n)))

    cand = torch.sort(torch.cat(cand_list, dim=1), dim=1).values
    dup = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=dev),
                     cand[:, 1:] == cand[:, :-1]], dim=1)
    valid = (cand < n) & ~dup

    nbrs = points[cand.clamp(0, n - 1)]
    d2 = torch.sum((nbrs - points[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    mean_sq = torch.mean(torch.topk(d2, k, dim=1, largest=False).values, dim=-1)
    return torch.where(torch.isfinite(mean_sq), mean_sq,
                       torch.full_like(mean_sq, 1e-8))
