"""Granularity-driven LOD cut + interpolation weights (port of the dynamic
path of hlod_gaussians_tpu/hierarchy/cut.py; reference
runtime_switching.cu:165-233,533-582,640-684).

Dense masked tensor ops over the flat node table: one gather per relation,
no pointer chasing. Ported in this slice: the dynamic size metric
(max(scale) / distance), the crude frustum test, `expand_to_size_dynamic`
without a parent cache, and the parent interpolation of render_post. The
box metric, `ParentCache` and `InterpTable` come with the rest of LOD.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hlod_gaussians_torch.models.gaussians import (NODE_CHILD_COUNT,
                                                   NODE_DEPTH, NODE_PARENT)
from hlod_gaussians_torch.ops import gather_rows


def node_size_dynamic(pos, max_scale, viewpoint):
    """Projected size metric (computeSizeGPUDynamic,
    runtime_switching.cu:222-233): max(scale) / ||viewpoint - pos||."""
    d = viewpoint[None, :] - pos
    dist = torch.sqrt(torch.sum(d * d, dim=1))
    return max_scale / torch.clamp_min(dist, 1e-12)


def in_frustum_crude(pos, viewpoint, zdir):
    """Crude frustum test (is_in_frustum, runtime_switching.cu:165-187):
    keep a node when the cosine between normalize(viewpoint - pos) and the
    camera forward axis is < -0.5."""
    diff = viewpoint[None, :] - pos
    norm = torch.sqrt(torch.sum(diff * diff, dim=1))
    cos_angle = torch.sum(diff * zdir[None, :], dim=1) / torch.clamp_min(
        norm, 1e-12)
    return cos_angle < -0.5


class CutResult(NamedTuple):
    render_mask: torch.Tensor  # [C] bool — node is in the cut
    size: torch.Tensor         # [C] projected size per node
    ts: torch.Tensor           # [C] interpolation weight (valid where mask)
    kids: torch.Tensor         # [C] int32 number of siblings


def _ts_kids(has_parent, parent_size, size, target_size, p_kids):
    """Interpolation weight + sibling count (computeTsIndexedDynamic,
    runtime_switching.cu:640-684): t = 1 for roots or while the parent is
    still oversized (> 2*target); else t = max(1 - max(0, target - start)
    / diff, 0) with start = max(parent/2, size), diff = parent - start."""
    start = torch.maximum(0.5 * parent_size, size)
    diff = parent_size - start
    tdiff = torch.clamp_min(target_size - start, 0.0)
    one = torch.ones_like(size)
    t_inner = torch.where(
        diff <= 0, one,
        torch.clamp_min(1.0 - tdiff / torch.where(diff <= 0, one, diff), 0.0))
    ts = torch.where(~has_parent | (parent_size > 2.0 * target_size), one,
                     t_inner)
    kids = torch.clamp_min(torch.where(has_parent, p_kids,
                                       torch.ones_like(p_kids)), 1)
    return ts, kids.to(torch.int32)


def expand_to_size_dynamic(
    nodes: torch.Tensor,       # [C,6] int32
    pos: torch.Tensor,         # [C,3]
    max_scale: torch.Tensor,   # [C]
    alive: torch.Tensor,       # [C] bool
    viewpoint: torch.Tensor,   # [3]
    zdir: torch.Tensor,        # [3] camera forward (world space)
    target_size,
    *,
    use_frustum: bool = True,
) -> CutResult:
    """Dynamic hierarchy cut + interpolation weights in one pass
    (markNodesForSizeDynamic runtime_switching.cu:533-582 +
    computeTsIndexedDynamic :640-684)."""
    c = nodes.shape[0]
    parent = nodes[:, NODE_PARENT]
    has_parent = parent >= 0
    parent_c = torch.clamp(parent, 0, c - 1).long()

    size = node_size_dynamic(pos, max_scale, viewpoint)
    p_size, p_kids = gather_rows([size, nodes[:, NODE_CHILD_COUNT]], parent_c)
    parent_size = torch.where(has_parent, p_size,
                              torch.full_like(p_size, float("inf")))

    is_leaf = nodes[:, NODE_CHILD_COUNT] == 0
    mask = alive & (nodes[:, NODE_DEPTH] >= 0)
    if use_frustum:
        mask = mask & in_frustum_crude(pos, viewpoint, zdir)
    sel = (size >= target_size) & is_leaf
    sel = sel | (has_parent & (parent_size >= target_size)
                 & (size < target_size))
    mask = mask & sel

    ts, kids = _ts_kids(has_parent, parent_size, size, target_size, p_kids)
    return CutResult(render_mask=mask, size=size, ts=ts, kids=kids)


def interpolate_with_parents(
    params: dict,             # activated: means3d, scales, quats, opacities, shs
    render_idx: torch.Tensor,  # [M] node indices (padded)
    parent_idx: torch.Tensor,  # [M] parent node indices (root: any, t=1)
    ts: torch.Tensor,          # [M]
) -> dict:
    """render_post's python interpolation (gaussian_renderer/__init__.py
    :304-339): child/parent lerp of mean, scale, opacity and SH; rotation
    lerped after the sign fix (dot < 0 flips the parent quaternion).
    Returns gathered + interpolated tensors of length M."""
    k = params["shs"].shape[1]
    c = params["means3d"].shape[0]
    feats = torch.cat([
        params["means3d"],                         # 0:3
        params["scales"],                          # 3:6
        params["quats"],                           # 6:10
        params["opacities"][:, None],              # 10
        params["shs"].reshape(c, k * 3),           # 11:11+3k
    ], dim=1)                                      # [C, 11+3k]
    g_c = feats[render_idx]
    g_p = feats[parent_idx]

    t = ts[:, None]
    q_c, q_p = g_c[:, 6:10], g_p[:, 6:10]
    dots = torch.sum(q_c * q_p, dim=1, keepdim=True)
    q_p = torch.where(dots < 0, -q_p, q_p)

    lin_c = torch.cat([g_c[:, :6], q_c, g_c[:, 10:]], dim=1)
    lin_p = torch.cat([g_p[:, :6], q_p, g_p[:, 10:]], dim=1)
    out = t * lin_c + (1.0 - t) * lin_p            # [M, D]

    m = render_idx.shape[0]
    return dict(
        means3d=out[:, 0:3],
        scales=out[:, 3:6],
        quats=out[:, 6:10],                        # renderer normalizes
        opacities=out[:, 10],
        shs=out[:, 11:11 + 3 * k].reshape(m, k, 3),
    )
