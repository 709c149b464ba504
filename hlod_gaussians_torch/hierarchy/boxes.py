"""Per-node AABBs + upstream `.hier` interop for the box-metric tau path
(port of hlod_gaussians_tpu/hierarchy/boxes.py; numpy, an offline product
like the reference creator's).

The upstream evaluation protocol (render_hierarchy.py:32-141) cuts the
hierarchy on PROJECTED BOX SIZE: every node carries the AABB of its
subtree's leaf Gaussians inflated by 3*max_scale
(PointbasedKdTreeGenerator.cpp:16-33), with the longest AABB side stored in
the box's w component (ClusterMerger.cpp:165-168) and projected size =
longest_side / distance(viewpoint, box), infinite inside the box
(computeSizeGPU, runtime_switching.cu:210-219).

This module computes those boxes for our flat node table, converts between
the fork's `.dhier` (one Gaussian per node) and the upstream `.hier`
node/box layout, and is consumed by render.render_lod(boxes=...) +
eval.eval_views(level_is_tau=True).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from hlod_gaussians_torch.data import dhier as dhier_io
from hlod_gaussians_torch.models.gaussians import (
    NODE_CHILD_COUNT, NODE_DEPTH, NODE_FIRST_CHILD, NODE_NEXT_SIBLING,
    NODE_PARENT)


class NodeBoxes(NamedTuple):
    lo: np.ndarray        # [C,3] f32
    hi: np.ndarray        # [C,3] f32
    max_side: np.ndarray  # [C]   f32 longest AABB side (the box "w")


def compute_node_boxes(nodes: np.ndarray, pos: np.ndarray,
                       max_scale: np.ndarray,
                       alive: Optional[np.ndarray] = None) -> NodeBoxes:
    """Bottom-up subtree AABBs of (leaf position +- 3*max_scale).

    Matches the reference's kd-build bounds: interior boxes cover the LEAF
    Gaussians of the subtree (not the interior merged Gaussians),
    PointbasedKdTreeGenerator.cpp:19-33. Host-side numpy (an offline build
    product, like the C++ creator's).
    """
    nodes = np.asarray(nodes)
    c = nodes.shape[0]
    if alive is None:
        alive = np.ones(c, bool)
    alive = np.asarray(alive) & (nodes[:, NODE_DEPTH] >= 0)

    lo = np.full((c, 3), np.inf, np.float32)
    hi = np.full((c, 3), -np.inf, np.float32)
    is_leaf = alive & (nodes[:, NODE_CHILD_COUNT] == 0)
    r = 3.0 * np.asarray(max_scale)[:, None]
    lo[is_leaf] = pos[is_leaf] - r[is_leaf]
    hi[is_leaf] = pos[is_leaf] + r[is_leaf]

    # sweep depths bottom-up, min/max-scattering child boxes into parents
    depth = np.where(alive, nodes[:, NODE_DEPTH], -1)
    for d in range(int(depth.max()), 0, -1):
        rows = np.where(depth == d)[0]
        if len(rows) == 0:
            continue
        par = nodes[rows, NODE_PARENT]
        ok = par >= 0
        rows, par = rows[ok], par[ok]
        np.minimum.at(lo, par, lo[rows])
        np.maximum.at(hi, par, hi[rows])

    bad = ~np.isfinite(lo).all(1)
    lo[bad] = 0.0
    hi[bad] = 0.0
    max_side = (hi - lo).max(axis=1).astype(np.float32)
    return NodeBoxes(lo=lo.astype(np.float32), hi=hi.astype(np.float32),
                     max_side=max_side)


# upstream 7-column Node layout (types.h / hierarchy_loader.cpp):
U_DEPTH, U_PARENT, U_START, U_CLEAF, U_CMERGED, U_STARTCH, U_COUNTCH = range(7)


def dhier_to_upstream(d: dhier_io.DHier) -> dhier_io.UpstreamHier:
    """Fork `.dhier` (one Gaussian per node) -> upstream `.hier` with boxes.

    Children are contiguous in the upstream layout (start_children +
    count_children); the fork's first_child/next_sibling chains need not be
    contiguous, so Gaussians/nodes are re-ordered depth-first to make them
    so. SH degree is zero-padded to 3 (the .hier always stores 16 coeffs).
    """
    nodes = np.asarray(d.nodes)
    c = nodes.shape[0]

    # reorder so every node's children are contiguous: BFS order
    order = []
    roots = np.where(nodes[:, NODE_PARENT] == -1)[0]
    queue = list(roots)
    while queue:
        nxt = []
        for i in queue:
            order.append(i)
        for i in queue:
            cc = nodes[i, NODE_CHILD_COUNT]
            ch = nodes[i, NODE_FIRST_CHILD]
            for _ in range(int(cc)):
                nxt.append(int(ch))
                ch = nodes[ch, NODE_NEXT_SIBLING]
        queue = nxt
    order = np.asarray(order, np.int32)
    if len(order) != c:
        raise ValueError(f"{c - len(order)} nodes are not reachable from a "
                         "root")
    inv = np.empty(c, np.int32)
    inv[order] = np.arange(c, dtype=np.int32)

    new_nodes = np.zeros((c, 7), np.int32)
    on = nodes[order]
    new_nodes[:, U_PARENT] = np.where(on[:, NODE_PARENT] >= 0,
                                      inv[np.clip(on[:, NODE_PARENT], 0, c - 1)],
                                      -1)
    # upstream Node.depth is the SUBTREE HEIGHT (leaves 0, parent =
    # max(children)+1 — PointbasedKdTreeGenerator.cpp:64), NOT the fork's
    # depth-from-root: the reference consumers branch on it
    # (HierarchyExplicitLoader::buildTreeRec reads depth>0 as "merged
    # node", hierarchy_explicit_loader.cpp:73). Writing from-root depths
    # here made reference tools misread our files (caught by the r05
    # merger oracle).
    height = np.zeros(c, np.int32)
    par_new = new_nodes[:, U_PARENT]
    for i in range(c - 1, 0, -1):
        p = par_new[i]
        if p >= 0 and height[p] < height[i] + 1:
            height[p] = height[i] + 1
    new_nodes[:, U_DEPTH] = height
    new_nodes[:, U_START] = np.arange(c, dtype=np.int32)
    is_leaf = on[:, NODE_CHILD_COUNT] == 0
    new_nodes[:, U_CLEAF] = is_leaf.astype(np.int32)
    new_nodes[:, U_CMERGED] = (~is_leaf).astype(np.int32)
    new_nodes[:, U_COUNTCH] = on[:, NODE_CHILD_COUNT]
    # children of a node are consecutive in BFS order; locate each parent's
    # first child
    first_child = np.full(c, -1, np.int32)
    par = new_nodes[:, U_PARENT]
    for i in range(c - 1, -1, -1):
        p = par[i]
        if p >= 0:
            first_child[p] = i
    new_nodes[:, U_STARTCH] = np.where(new_nodes[:, U_COUNTCH] > 0,
                                       first_child, 0)

    scale = np.exp(np.asarray(d.log_scale))[order]
    boxes_nb = compute_node_boxes(_renum(on, inv, c),
                                  np.asarray(d.pos)[order],
                                  scale.max(axis=1))
    boxes = np.zeros((c, 2, 4), np.float32)
    boxes[:, 0, :3] = boxes_nb.lo
    boxes[:, 1, :3] = boxes_nb.hi
    boxes[:, 0, 3] = boxes_nb.max_side
    boxes[:, 1, 3] = boxes_nb.max_side

    k = d.shs.shape[1]
    shs16 = np.zeros((c, 16, 3), np.float32)
    shs16[:, :k] = np.asarray(d.shs)[order]
    return dhier_io.UpstreamHier(
        pos=np.asarray(d.pos)[order], quat=np.asarray(d.quat)[order],
        log_scale=np.asarray(d.log_scale)[order],
        opacity=np.asarray(d.opacity)[order], shs=shs16,
        nodes=new_nodes, boxes=boxes)


def _renum(on: np.ndarray, inv: np.ndarray, c: int) -> np.ndarray:
    """Renumber a permuted fork node table's child/sibling pointers."""
    out = on.copy()
    for col in (NODE_PARENT, NODE_FIRST_CHILD, NODE_NEXT_SIBLING):
        v = on[:, col]
        out[:, col] = np.where(v >= 0, inv[np.clip(v, 0, c - 1)], v)
    return out


def upstream_to_fork(h: dhier_io.UpstreamHier
                     ) -> Tuple[dhier_io.DHier, NodeBoxes]:
    """Loaded `.hier` -> fork node table + its boxes (for the box-metric
    render path, render_hierarchy.py:58-66). One Gaussian per node, but
    the gaussian ARRAYS are indexed by each node's `start`, which is NOT
    the node index in reference-creator files (placeholder node ids are
    assigned before the DFS fills the arrays) — the parameters are
    permuted so gaussian index == node index afterwards. (Pre-r05 this
    assumed start == index and silently mis-assigned every parameter on
    reference-written files; caught by the oracle render test.)"""
    nodes = np.asarray(h.nodes)
    c = nodes.shape[0]
    start = nodes[:, U_START]
    if np.unique(start).size != c:
        raise ValueError("expected one gaussian per node")
    fork = np.full((c, 6), -1, np.int32)
    # stored upstream depth is the subtree HEIGHT (leaf=0); the fork table
    # wants depth-from-root — recompute from parents (children follow
    # their parent in both our BFS writer and the reference's preorder)
    par_u = nodes[:, U_PARENT]
    depth = np.zeros(c, np.int32)
    for i in range(c):
        if par_u[i] >= 0:
            depth[i] = depth[par_u[i]] + 1
    fork[:, NODE_DEPTH] = depth
    fork[:, NODE_PARENT] = nodes[:, U_PARENT]
    fork[:, NODE_CHILD_COUNT] = nodes[:, U_COUNTCH]
    fork[:, NODE_FIRST_CHILD] = np.where(nodes[:, U_COUNTCH] > 0,
                                         nodes[:, U_STARTCH], -1)
    # siblings: child i's next sibling is start_children + i + 1
    par = fork[:, NODE_PARENT]
    for i in range(c):
        cc = nodes[i, U_COUNTCH]
        if cc > 0:
            s = nodes[i, U_STARTCH]
            for j in range(int(cc) - 1):
                fork[s + j, NODE_NEXT_SIBLING] = s + j + 1
    boxes = NodeBoxes(lo=np.asarray(h.boxes)[:, 0, :3].copy(),
                      hi=np.asarray(h.boxes)[:, 1, :3].copy(),
                      max_side=np.asarray(h.boxes)[:, 0, 3].copy())
    d = dhier_io.DHier(sh_degree=3, pos=np.asarray(h.pos)[start],
                       quat=np.asarray(h.quat)[start],
                       log_scale=np.asarray(h.log_scale)[start],
                       opacity=np.asarray(h.opacity)[start],
                       shs=np.asarray(h.shs)[start], nodes=fork)
    return d, boxes
