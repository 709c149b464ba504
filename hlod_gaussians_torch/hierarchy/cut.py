"""Granularity-driven LOD cuts + interpolation weights (port of
hlod_gaussians_tpu/hierarchy/cut.py; reference runtime_switching.cu).

Dense masked tensor ops over the flat node table, one gather per relation,
no pointer chasing. Both size metrics of the reference:

* box (upstream ``expandToSize`` / ``computeTsIndexed``,
  runtime_switching.cu:495-684): longest AABB side / distance(viewpoint,
  box), infinite inside the box;
* dynamic (fork ``expandToSizeDynamic`` / ``computeTsIndexedDynamic``,
  runtime_switching.cu:222-233,533-582,640-684): max(scale) /
  distance(viewpoint, position), with the crude frustum test.

A `ParentCache` (built once per tree) makes the per-frame cut gather-free;
an `InterpTable` (built once per tree and parameters) makes the per-frame
parent interpolation one row gather, or, over the whole tree, one lerp.
Node rows are laid out [C, ...] throughout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hlod_gaussians_torch.models.gaussians import (
    NODE_CHILD_COUNT, NODE_DEPTH, NODE_FIRST_CHILD, NODE_NEXT_SIBLING,
    NODE_PARENT)
from hlod_gaussians_torch.ops import gather_rows


def node_size_dynamic(pos, max_scale, viewpoint):
    """Projected size metric (computeSizeGPUDynamic,
    runtime_switching.cu:222-233): max(scale) / ||viewpoint - pos||."""
    d = viewpoint[None, :] - pos
    dist = torch.sqrt(torch.sum(d * d, dim=1))
    return max_scale / torch.clamp_min(dist, 1e-12)


def node_size_box(box_lo, box_hi, max_side, viewpoint):
    """Upstream box metric (computeSizeGPU, runtime_switching.cu:210-219):
    max_side / distance(viewpoint, box); +inf inside the box."""
    v = viewpoint[None, :]
    d = v - torch.minimum(torch.maximum(v, box_lo), box_hi)
    dist = torch.sqrt(torch.sum(d * d, dim=1))
    return torch.where(dist <= 0.0, torch.full_like(dist, float("inf")),
                       max_side / torch.clamp_min(dist, 1e-12))


def in_frustum_crude(pos, viewpoint, zdir):
    """Crude frustum test (is_in_frustum, runtime_switching.cu:165-187):
    keep a node when the cosine between normalize(viewpoint - pos) and the
    camera forward axis is < -0.5."""
    diff = viewpoint[None, :] - pos
    norm = torch.sqrt(torch.sum(diff * diff, dim=1))
    cos_angle = torch.sum(diff * zdir[None, :], dim=1) / torch.clamp_min(
        norm, 1e-12)
    return cos_angle < -0.5


def frustum_planes(full_proj):
    """The 4 side planes (left, right, bottom, top) of a row-vector
    view-projection matrix (reference extract_frustum_planes,
    scene/gaussian_model.py:55-78), normalized: [4,4] (a, b, c, d); a point
    p is inside when dot(plane, [p, 1]) >= 0."""
    m = full_proj.T
    planes = torch.stack([m[3] + m[0], m[3] - m[0], m[3] + m[1],
                          m[3] - m[1]])
    n = torch.linalg.norm(planes[:, :3], dim=-1, keepdim=True)
    return planes / torch.clamp_min(n, 1e-12)


def sphere_in_frustum(pos, radius, planes):
    """Sphere-vs-4-plane test (scene/gaussian_model.py:80-103)."""
    d = pos @ planes[:, :3].T + planes[None, :, 3]
    return torch.all(d >= -radius[:, None], dim=-1)


class CutResult(NamedTuple):
    render_mask: torch.Tensor  # [C] bool — node is in the cut
    size: torch.Tensor         # [C] projected size per node
    ts: torch.Tensor           # [C] interpolation weight (valid where mask)
    kids: torch.Tensor         # [C] int32 number of siblings


class ParentCache(NamedTuple):
    """Per-node copies of the parent's cut inputs, built once per tree
    update; the per-frame cut then recomputes the parent's size from them
    without a gather.

    dynamic metric: p_aux = (p_pos [C,3], p_scale [C]);
    box metric:     p_aux = (p_lo [C,3], p_hi [C,3], p_side [C]).
    """
    p_aux: tuple
    p_kids: torch.Tensor       # [C] int32 parent's child count


def _parent_index(nodes):
    return torch.clamp(nodes[:, NODE_PARENT], 0, nodes.shape[0] - 1).long()


def build_parent_cache(nodes, pos, max_scale) -> ParentCache:
    """Dynamic-metric parent cache."""
    parent = _parent_index(nodes)
    return ParentCache(p_aux=(pos[parent], max_scale[parent]),
                       p_kids=nodes[parent, NODE_CHILD_COUNT])


def build_parent_cache_box(nodes, box_lo, box_hi, max_side) -> ParentCache:
    """Box-metric parent cache."""
    parent = _parent_index(nodes)
    return ParentCache(
        p_aux=(box_lo[parent], box_hi[parent], max_side[parent]),
        p_kids=nodes[parent, NODE_CHILD_COUNT])


def _ts_kids(has_parent, parent_size, size, target_size, p_kids):
    """Interpolation weight + sibling count of both metrics
    (computeTsIndexed runtime_switching.cu:588-637 and
    computeTsIndexedDynamic :640-684): t = 1 for roots or while the parent
    is still oversized (> 2*target); else t = max(1 - max(0, target -
    start) / diff, 0) with start = max(parent/2, size), diff = parent -
    start."""
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


def _select(nodes, size, parent_size, has_parent, target_size):
    """The size rule shared by both metrics: a leaf at least target-sized,
    or a node below target whose parent is at least target-sized."""
    is_leaf = nodes[:, NODE_CHILD_COUNT] == 0
    return (((size >= target_size) & is_leaf)
            | (has_parent & (parent_size >= target_size)
               & (size < target_size)))


def expand_to_size_dynamic(
    nodes: torch.Tensor,       # [C,6] int32
    pos: torch.Tensor,         # [C,3]
    max_scale: torch.Tensor,   # [C]
    alive: torch.Tensor,       # [C] bool
    viewpoint: torch.Tensor,   # [3]
    zdir: torch.Tensor,        # [3] camera forward (world space)
    target_size,
    pcache: Optional[ParentCache] = None,
    *,
    use_frustum: bool = True,
) -> CutResult:
    """Dynamic hierarchy cut + interpolation weights in one pass
    (markNodesForSizeDynamic runtime_switching.cu:533-582 +
    computeTsIndexedDynamic :640-684); gather-free with ``pcache``."""
    has_parent = nodes[:, NODE_PARENT] >= 0
    size = node_size_dynamic(pos, max_scale, viewpoint)
    if pcache is not None:
        p_size = node_size_dynamic(*pcache.p_aux, viewpoint)
        p_kids = pcache.p_kids
    else:
        p_size, p_kids = gather_rows([size, nodes[:, NODE_CHILD_COUNT]],
                                     _parent_index(nodes))
    parent_size = torch.where(has_parent, p_size,
                              torch.full_like(p_size, float("inf")))

    mask = alive & (nodes[:, NODE_DEPTH] >= 0)
    if use_frustum:
        mask = mask & in_frustum_crude(pos, viewpoint, zdir)
    mask = mask & _select(nodes, size, parent_size, has_parent, target_size)
    ts, kids = _ts_kids(has_parent, parent_size, size, target_size, p_kids)
    return CutResult(render_mask=mask, size=size, ts=ts, kids=kids)


def expand_to_size_box(
    nodes: torch.Tensor,      # [C,6]
    box_lo: torch.Tensor, box_hi: torch.Tensor, max_side: torch.Tensor,
    alive: torch.Tensor,
    viewpoint: torch.Tensor,
    target_size,
    pcache: Optional[ParentCache] = None,
) -> CutResult:
    """Upstream box-metric cut (markNodesForSize runtime_switching.cu
    :495-529 + computeTsIndexed :588-637); gather-free with ``pcache``
    (build_parent_cache_box). depth >= 0 keeps skybox and padding rows
    out, as in the dynamic metric."""
    has_parent = nodes[:, NODE_PARENT] >= 0
    size = node_size_box(box_lo, box_hi, max_side, viewpoint)
    if pcache is not None:
        p_size = node_size_box(*pcache.p_aux, viewpoint)
        p_kids = pcache.p_kids
    else:
        p_size, p_kids = gather_rows([size, nodes[:, NODE_CHILD_COUNT]],
                                     _parent_index(nodes))
    parent_size = torch.where(has_parent, p_size,
                              torch.full_like(p_size, float("inf")))

    mask = (alive & _select(nodes, size, parent_size, has_parent, target_size)
            & (nodes[:, NODE_DEPTH] >= 0))
    ts, kids = _ts_kids(has_parent, parent_size, size, target_size, p_kids)
    return CutResult(render_mask=mask, size=size, ts=ts, kids=kids)


def node_heights(nodes: torch.Tensor, alive: torch.Tensor,
                 max_depth: int = 64) -> torch.Tensor:
    """Subtree height per node (leaves 0, parent = max(children) + 1, the
    reference's Node.depth, PointbasedKdTreeGenerator.cpp:64), by
    level-synchronous upward scatter-max sweeps; exact for trees up to
    ``max_depth`` deep."""
    c = nodes.shape[0]
    parent = nodes[:, NODE_PARENT].long()
    live = alive & (nodes[:, NODE_DEPTH] >= 0)
    p_safe = torch.where((parent >= 0) & live, parent,
                         torch.full_like(parent, c))
    height = torch.zeros(c, dtype=torch.int32, device=nodes.device)
    for _ in range(max_depth):
        up = torch.zeros(c + 1, dtype=torch.int32, device=nodes.device)
        up = up.scatter_reduce(0, p_safe, height + 1, "amax")[:c]
        height = torch.maximum(height, up)
    return height


def expand_to_target(nodes: torch.Tensor, alive: torch.Tensor,
                     target: int, max_depth: int = 64) -> torch.Tensor:
    """Height-target cut (reference expandToTarget, traversal.cpp:16-44):
    descend while a node's subtree height exceeds ``target``; the first
    node at height <= target on each path is selected. target 0 selects
    every leaf, a target >= the root's height the root. [C] bool mask."""
    parent = nodes[:, NODE_PARENT]
    height = node_heights(nodes, alive, max_depth)
    ph = height[_parent_index(nodes)]
    sel = (height <= target) & ((parent < 0) | (ph > target))
    return sel & alive & (nodes[:, NODE_DEPTH] >= 0)


def bounding_sphere_divergence(nodes, pos, max_scale, alive,
                               generator: torch.Generator,
                               n_samples: int = 1024) -> torch.Tensor:
    """Monte-Carlo share of child bounding spheres (radius 3*max_scale)
    lying outside their parent's (reference
    compute_bounding_sphere_divergence, scene/gaussian_model.py:616-634):
    0 when perfectly nested. The sample directions come from
    ``generator``."""
    has_parent = ((nodes[:, NODE_PARENT] >= 0) & alive
                  & (nodes[:, NODE_DEPTH] >= 0))
    p_idx = _parent_index(nodes)
    r_child = 3.0 * max_scale
    r_parent = 3.0 * max_scale[p_idx]
    dirs = torch.randn((n_samples, 3), generator=generator,
                       device=generator.device).to(pos.device)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1,
                                    keepdim=True).clamp_min(1e-12)
    pts = pos[:, None, :] + r_child[:, None, None] * dirs[None, :, :]
    d_parent = torch.linalg.norm(pts - pos[p_idx][:, None, :], dim=-1)
    outside = (d_parent > r_parent[:, None]).float()
    frac = torch.where(has_parent, outside.mean(dim=1),
                       torch.zeros_like(r_child))
    return torch.sum(frac) / torch.clamp_min(torch.sum(has_parent), 1)


def sanity_check_hierarchy(nodes, alive) -> None:
    """Structural checks (reference sanity_check_hierarchy,
    scene/gaussian_model.py:637-675): one root, parent back-pointers,
    depths growing downwards, every alive node reached exactly once.
    Raises ValueError on a violation. Host-side."""
    nodes = np.asarray(nodes.cpu() if isinstance(nodes, torch.Tensor)
                       else nodes)
    alive = np.asarray(alive.cpu() if isinstance(alive, torch.Tensor)
                       else alive)
    real = alive & (nodes[:, NODE_DEPTH] >= 0)
    roots = np.where(real & (nodes[:, NODE_PARENT] == -1))[0]
    if len(roots) != 1:
        raise ValueError(f"expected 1 root, got {len(roots)}")
    depth, parent, count, first, sibling = (
        nodes[:, col].tolist() for col in (NODE_DEPTH, NODE_PARENT,
                                           NODE_CHILD_COUNT,
                                           NODE_FIRST_CHILD,
                                           NODE_NEXT_SIBLING))
    real_l = real.tolist()
    seen = [False] * nodes.shape[0]
    stack = [int(roots[0])]
    n_seen = 0
    while stack:
        i = stack.pop()
        if seen[i]:
            raise ValueError(f"node {i} reached twice")
        if not real_l[i]:
            raise ValueError(f"node {i} in the tree but not alive")
        seen[i] = True
        n_seen += 1
        c = first[i]
        for _ in range(max(count[i], 0)):
            if parent[c] != i or depth[c] <= depth[i]:
                raise ValueError(f"node {c} is a bad child of {i}")
            stack.append(c)
            c = sibling[c]
    if n_seen != int(real.sum()):
        raise ValueError(f"reachable {n_seen} != alive {int(real.sum())}")


def is_hierarchy_cut(nodes, mask, alive) -> torch.Tensor:
    """True iff ``mask`` is a proper cut: every alive leaf has exactly one
    selected ancestor-or-self (scene/gaussian_model.py:348-350), by
    level-synchronous ancestor counting. Returns a 0-d bool tensor."""
    c = nodes.shape[0]
    parent = nodes[:, NODE_PARENT].long()
    count = mask.to(torch.int32)
    cur = torch.arange(c, device=nodes.device)
    max_depth = int(nodes[:, NODE_DEPTH].max()) if c else 0
    for _ in range(max_depth):
        nxt = torch.where(cur >= 0, parent[cur.clamp(0, c - 1)],
                          torch.full_like(cur, -1))
        count = count + (mask[nxt.clamp(0, c - 1)] & (nxt >= 0)).to(
            torch.int32)
        cur = nxt
    relevant = (alive & (nodes[:, NODE_CHILD_COUNT] == 0)
                & (nodes[:, NODE_DEPTH] >= 0))
    return torch.all(~relevant | (count == 1))


class InterpTable(NamedTuple):
    """Child + parent feature table for LOD interpolation, built once per
    (tree, parameters). Row i holds node i's features [0:D] and its
    parent's [D:2D], the parent quaternion's sign already fixed (the
    child/parent pairing is static, so is dot(q_c, q_p) < 0).
    D = 11 + 3*sh_k: means 0:3, scales 3:6, quats 6:10, opacity 10, SH."""
    feats: torch.Tensor        # [C, 2D]


def _features(params: dict) -> torch.Tensor:
    c, k = params["shs"].shape[:2]
    return torch.cat([params["means3d"], params["scales"], params["quats"],
                      params["opacities"][:, None],
                      params["shs"].reshape(c, k * 3)], dim=1)


def _unpack(out: torch.Tensor) -> dict:
    m, d = out.shape
    return dict(means3d=out[:, 0:3], scales=out[:, 3:6],
                quats=out[:, 6:10],                # renderer normalizes
                opacities=out[:, 10],
                shs=out[:, 11:].reshape(m, (d - 11) // 3, 3))


def build_interp_table(params: dict, nodes: torch.Tensor) -> InterpTable:
    """See InterpTable. ``params`` are activated tensors as in
    interpolate_with_parents."""
    feats = _features(params)
    pfeats = feats[_parent_index(nodes)]
    dots = torch.sum(feats[:, 6:10] * pfeats[:, 6:10], dim=1, keepdim=True)
    pfeats[:, 6:10] = torch.where(dots < 0, -pfeats[:, 6:10],
                                  pfeats[:, 6:10])
    return InterpTable(feats=torch.cat([feats, pfeats], dim=1))


def interpolate_from_table(table: InterpTable, render_idx: torch.Tensor,
                           ts: torch.Tensor) -> dict:
    """Per-frame LOD interpolation through the InterpTable: one row gather
    and a lerp. Bit-identical to interpolate_with_parents for unit
    quaternions (the sign fix commutes with the static pairing)."""
    d = table.feats.shape[1] // 2
    g = table.feats[render_idx]
    t = ts[:, None]
    return _unpack(t * g[:, :d] + (1.0 - t) * g[:, d:])


def interpolate_all_masked(table: InterpTable, ts: torch.Tensor,
                           mask: torch.Tensor) -> dict:
    """LOD-interpolate every node by one elementwise lerp over the
    InterpTable, with no compaction and no gather. Rows outside ``mask``
    take t = 1 (their own parameters), so the math stays finite; the
    renderer culls them through its valid mask."""
    d = table.feats.shape[1] // 2
    t = torch.where(mask, ts, torch.ones_like(ts))[:, None]
    return _unpack(t * table.feats[:, :d] + (1.0 - t) * table.feats[:, d:])


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
    feats = _features(params)
    g_c = feats[render_idx]
    g_p = feats[parent_idx]
    q_c, q_p = g_c[:, 6:10], g_p[:, 6:10]
    dots = torch.sum(q_c * q_p, dim=1, keepdim=True)
    q_p = torch.where(dots < 0, -q_p, q_p)
    lin_c = torch.cat([g_c[:, :6], q_c, g_c[:, 10:]], dim=1)
    lin_p = torch.cat([g_p[:, :6], q_p, g_p[:, 10:]], dim=1)
    t = ts[:, None]
    return _unpack(t * lin_c + (1.0 - t) * lin_p)
