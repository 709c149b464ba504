"""Cross-chunk hierarchy consolidation (port of
hlod_gaussians_tpu/pipeline/merge.py).

Equivalent of the reference's `GaussianHierarchyMerger` mode 0
(mainHierarchyMerger.cpp:44-142 + hierarchy_explicit_loader.cpp:22-133): each
chunk's trained hierarchy is re-weighted by a linear opacity falloff around
the equidistance surface between chunk centers, weight-0 nodes are dropped
(their children splice up to the nearest kept ancestor), and all chunk roots
are grafted under one new global root.

Operates on the `.dhier` node-table representation (one Gaussian per node)
with vectorized numpy — this is the offline consolidation step that replaces
the reference's C++ executable + SLURM barrier.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from hlod_gaussians_torch.data.dhier import DHier
from hlod_gaussians_torch.hierarchy.build import ellipse_surface
from hlod_gaussians_torch.models.gaussians import (
    NODE_AUX, NODE_CHILD_COUNT, NODE_DEPTH, NODE_FIRST_CHILD,
    NODE_NEXT_SIBLING, NODE_PARENT)


def chunk_weight(pos: np.ndarray, chunk_id: int,
                 centers: np.ndarray, falloff: float = 0.05) -> np.ndarray:
    """Linear opacity falloff around the chunk equidistance surface
    (getWeight, hierarchy_explicit_loader.cpp:22-52). pos [N,3],
    centers [K,3] -> weights [N] in [0,1]."""
    d_own = np.linalg.norm(pos - centers[chunk_id], axis=-1)
    others = np.delete(np.arange(len(centers)), chunk_id)
    if len(others) == 0:
        return np.ones(pos.shape[0], np.float32)
    # K-loop keeps peak memory O(N): the broadcast [N, K-1, 3] difference
    # tensor is gigabytes for million-node chunks in many-chunk scenes
    d_other = np.full(pos.shape[0], np.inf, np.float32)
    for j in others:
        d_other = np.minimum(d_other,
                             np.linalg.norm(pos - centers[j], axis=-1))

    lo = (1.0 - falloff) * d_other
    hi = (1.0 + falloff) * d_other
    a = -1.0 / (2.0 * falloff * np.maximum(d_other, 1e-12))
    b = (1.0 + falloff) / (2.0 * falloff)
    w = a * d_own + b
    w = np.where(d_own <= lo, 1.0, w)
    w = np.where(d_own > hi, 0.0, w)
    return np.clip(w, 0.0, 1.0).astype(np.float32)


def _splice_dropped(nodes: np.ndarray, keep: np.ndarray):
    """New parent for every kept node: nearest kept proper ancestor
    (buildTreeRec's drop-and-promote, hierarchy_explicit_loader.cpp:120-133).
    Iterates to convergence (bounded by the longest root path, NOT a fixed
    64: a longer dropped chain would silently orphan the subtree)."""
    n = nodes.shape[0]
    parent = nodes[:, NODE_PARENT].astype(np.int64)
    anc = parent.copy()
    for _ in range(n + 1):
        bad = (anc >= 0) & ~keep[np.clip(anc, 0, n - 1)]
        if not bad.any():
            return anc
        anc[bad] = parent[np.clip(anc[bad], 0, n - 1)]
    raise ValueError("parent chain did not converge (cyclic node table?)")


def reweight_chunk(d: DHier, chunk_id: int, centers: np.ndarray,
                   falloff: float = 0.05) -> DHier:
    """Apply the opacity falloff to one chunk hierarchy, dropping weight-0
    nodes and splicing their children upward.

    The chunk ROOT gaussian is repositioned to the chunk center before
    weighting, exactly as the reference loader does (loadExplicit sets
    pos[0] = chunk_centers[chunk_id], hierarchy_explicit_loader.cpp:151)
    — its weight becomes exactly 1 and the merged output carries the
    center as the root's coarse-LOD proxy position. Held to the reference
    merger's output by tests/test_torch_pipeline.py."""
    root = int(np.where(d.nodes[:, NODE_PARENT] == -1)[0][0])
    pos = np.asarray(d.pos).copy()
    pos[root] = centers[chunk_id]
    w = chunk_weight(pos, chunk_id, centers, falloff)
    keep = w > 0.0
    assert keep[root]  # dist 0 -> weight exactly 1

    new_parent = _splice_dropped(d.nodes, keep)

    # canonical order: the ROOT must land at kept-index 0 — downstream,
    # index 0 doubles as the next_sibling/first_child "none" sentinel
    # (inherited from the reference format, where the root is node 0), so
    # no interior node may be referenced as child 0
    kept = np.where(keep)[0]
    ri = int(np.where(kept == root)[0][0])
    if ri != 0:
        kept = np.concatenate([[root], np.delete(kept, ri)])
    remap = np.full(d.nodes.shape[0], -1, np.int64)
    remap[kept] = np.arange(len(kept))

    parent = np.where(new_parent[kept] >= 0,
                      remap[np.clip(new_parent[kept], 0, len(remap) - 1)], -1)
    nodes = rebuild_links(parent)

    return DHier(
        sh_degree=d.sh_degree,
        pos=pos[kept], quat=d.quat[kept], log_scale=d.log_scale[kept],
        opacity=(d.opacity * w)[kept].astype(np.float32),
        shs=d.shs[kept], nodes=nodes)


def rebuild_links(parent: np.ndarray) -> np.ndarray:
    """Node table from a parent array: child_count / first_child /
    next_sibling chains + recomputed depths. Fully vectorized — the
    per-node Python loop cost minutes on million-node chunks."""
    n = parent.shape[0]
    parent = parent.astype(np.int64)
    nodes = np.full((n, 6), 0, np.int32)
    nodes[:, NODE_PARENT] = parent

    # group children by parent; stable sort keeps original index order, so
    # first_child = the lowest-index child and sibling chains ascend —
    # identical to the previous sequential construction
    order = np.argsort(parent, kind="stable")
    ps = parent[order]
    valid = ps >= 0
    nxt = np.zeros(n, np.int64)
    same = np.zeros(n, bool)
    same[:-1] = ps[:-1] == ps[1:]
    nxt[:-1][same[:-1]] = order[1:][same[:-1]]    # 0 = chain-end sentinel
    nodes[order[valid], NODE_NEXT_SIBLING] = nxt[valid]
    starts = np.ones(n, bool)
    starts[1:] = ps[1:] != ps[:-1]
    gs = starts & valid
    nodes[ps[gs], NODE_FIRST_CHILD] = order[gs]
    cc = np.bincount(ps[valid], minlength=n)[:n]
    nodes[:, NODE_CHILD_COUNT] = cc
    nodes[cc == 0, NODE_FIRST_CHILD] = -1          # leaves carry -1

    # depths from the root down (bounded by the longest root path)
    depth = np.full(n, -1, np.int32)
    depth[parent < 0] = 0
    for _ in range(n + 1):
        need = (depth < 0) & (parent >= 0) \
            & (depth[np.clip(parent, 0, n - 1)] >= 0)
        if not need.any():
            break
        depth[need] = depth[parent[need]] + 1
    nodes[:, NODE_DEPTH] = depth
    nodes[:, NODE_AUX] = 0
    return nodes


def merge_hierarchies(chunks: Sequence[DHier], centers: np.ndarray,
                      falloff: float = 0.05) -> DHier:
    """Re-weight every chunk and graft the chunk roots under a new global
    root (mainHierarchyMerger.cpp:93-137)."""
    assert len(chunks) == centers.shape[0]
    parts: List[DHier] = [reweight_chunk(d, i, centers, falloff)
                          for i, d in enumerate(chunks)]

    sh_degree = parts[0].sh_degree
    k = parts[0].shs.shape[1]
    offset = 1  # new root at index 0
    pos, quat, ls, op, shs, node_list = [], [], [], [], [], []
    chunk_root_ids = []
    for p in parts:
        n = p.pos.shape[0]
        nodes = p.nodes.copy()
        root = int(np.where(nodes[:, NODE_PARENT] == -1)[0][0])
        assert root == 0, (
            "chunk root must be node 0 (reweight_chunk canonicalizes "
            "this; index 0 doubles as the link sentinel)")
        # parent: 0 is a REAL index (the chunk root), shift >= 0;
        # first_child: leaves are -1, interior never references index 0;
        # next_sibling: 0 is the chain-end sentinel
        v = nodes[:, NODE_PARENT]
        nodes[:, NODE_PARENT] = np.where(v >= 0, v + offset, v)
        for col in (NODE_FIRST_CHILD, NODE_NEXT_SIBLING):
            v = nodes[:, col]
            nodes[:, col] = np.where(v > 0, v + offset, v)
        nodes[:, NODE_DEPTH] += 1
        nodes[root, NODE_PARENT] = 0
        chunk_root_ids.append(root + offset)
        pos.append(p.pos); quat.append(p.quat); ls.append(p.log_scale)
        op.append(p.opacity); shs.append(p.shs); node_list.append(nodes)
        offset += n

    total = offset
    # sibling chain between chunk roots
    all_nodes = np.concatenate(
        [np.zeros((1, 6), np.int32)] + node_list, axis=0)
    for i, r in enumerate(chunk_root_ids):
        all_nodes[r, NODE_NEXT_SIBLING] = (
            chunk_root_ids[i + 1] if i + 1 < len(chunk_root_ids) else 0)
    all_nodes[0] = [0, -1, len(chunk_root_ids), chunk_root_ids[0], 0, 0]

    # global root gaussian: opacity-surface-weighted merge of the chunk roots
    pos_all = np.concatenate([np.zeros((1, 3), np.float32)] + pos)
    quat_all = np.concatenate([np.tile(np.array([[1, 0, 0, 0]], np.float32),
                                       (1, 1))] + quat)
    ls_all = np.concatenate([np.zeros((1, 3), np.float32)] + ls)
    op_all = np.concatenate([np.zeros((1,), np.float32)] + op)
    shs_all = np.concatenate([np.zeros((1, k, 3), np.float32)] + shs)

    ridx = np.asarray(chunk_root_ids)
    # the builder's surface on float32 CPU tensors, as the JAX package
    # evaluates it in float32
    wts = op_all[ridx] * ellipse_surface(
        torch.from_numpy(np.exp(ls_all[ridx]))).numpy()
    wsum = max(float(wts.sum()), 1e-12)
    a = (wts / wsum)[:, None]
    pos_all[0] = (a * pos_all[ridx]).sum(0)
    shs_all[0] = (a[:, :, None] * shs_all[ridx]).sum(0)
    ls_all[0] = np.log(np.maximum((a * np.exp(ls_all[ridx])).sum(0), 1e-12))
    quat_all[0] = quat_all[ridx[int(np.argmax(wts))]]
    op_all[0] = min(float(op_all[ridx].max()), 1.0)

    return DHier(sh_degree=sh_degree, pos=pos_all, quat=quat_all,
                 log_scale=ls_all, opacity=op_all, shs=shs_all,
                 nodes=all_nodes)
