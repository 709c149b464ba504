"""Appearance filtering, random cuts, and gradient-propagation weights (port
of hlod_gaussians_tpu/hierarchy/filter.py).

* `appearance_filter_mask` — mark the hierarchy nodes that any training
  viewpoint would ever select at a given granularity; everything deeper is
  never-needed detail that the reference's `AppearanceFilter` prunes or
  anchors (appearance_filter.cpp + markVisibleForAllViewpoints,
  runtime_switching.cu:1036-1080). One dynamic cut per viewpoint on the
  device, OR-ed together without a host sync, then the ancestor closure on
  the host.
* `random_cut_mask` — the fork's randomized-coarsening cut used for
  regularization experiments (get_random_cut,
  scene/gaussian_model.py:528-551): start from all leaves, repeatedly
  collapse a random subset of sibling pairs bottom-up. Host numpy.
* `sibling_weights` — opacity*surface weights normalized over sibling pairs
  (recompute_weights, scene/gaussian_model.py:557-568), used to split
  gradients flowing from a parent to its children when gradient
  propagation is enabled.
* `compute_anchors` / `write_anchors` / `read_anchors` — the anchors.bin
  file the reference merger's chunk path writes beside each hierarchy.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from hlod_gaussians_torch.hierarchy import cut as cut_mod
from hlod_gaussians_torch.models.gaussians import (
    NODE_CHILD_COUNT, NODE_DEPTH, NODE_FIRST_CHILD, NODE_NEXT_SIBLING,
    NODE_PARENT)
from hlod_gaussians_torch.ops import drop_index


def _device_of(x, device):
    """``device``, else the device of ``x`` when it is a tensor, else the
    card."""
    if device is not None:
        return torch.device(device)
    return x.device if isinstance(x, torch.Tensor) else torch.device("cuda")


def _tensor(x, device, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), device=device).to(dtype)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def appearance_filter_mask(nodes, pos, max_scale, alive, viewpoints,
                           target_size, *, batch: int = 64,
                           device=None) -> torch.Tensor:
    """[C] bool on the device: node selected by the granularity cut from
    ANY viewpoint, or an ancestor of such a node.

    viewpoints: [V,3]. Nodes never marked can be pruned (their detail is
    unreachable at this granularity from every training camera). Inputs are
    numpy arrays or tensors; the cuts run on ``device`` (by default the
    device of ``nodes`` when it is a tensor, else the card). ``batch`` is
    kept for the JAX signature and unused, as there."""
    dev = _device_of(nodes, device)
    nodes_t = _tensor(nodes, dev, torch.int32)
    pos_t = _tensor(pos, dev, torch.float32)
    ms_t = _tensor(max_scale, dev, torch.float32)
    alive_t = _tensor(alive, dev, torch.bool)
    vps = _tensor(viewpoints, dev, torch.float32).reshape(-1, 3)
    zdir = torch.tensor([0.0, 0.0, 1.0], device=dev)
    pcache = cut_mod.build_parent_cache(nodes_t, pos_t, ms_t)
    seen = torch.zeros((nodes_t.shape[0],), dtype=torch.bool, device=dev)
    for i in range(vps.shape[0]):
        cut = cut_mod.expand_to_size_dynamic(
            nodes_t, pos_t, ms_t, alive_t, vps[i], zdir, target_size,
            pcache, use_frustum=False)
        seen |= cut.render_mask
    # ancestors of seen nodes are implicitly needed too (the JAX package's
    # host closure, 64 rounds at most)
    seen_np = seen.cpu().numpy()
    parent = _host(nodes)[:, NODE_PARENT]
    for _ in range(64):
        p_mask = seen_np & (parent >= 0)
        newly = np.zeros_like(seen_np)
        newly[parent[p_mask]] = True
        grown = newly & ~seen_np
        if not grown.any():
            break
        seen_np |= newly
    return torch.from_numpy(seen_np).to(dev)


def random_cut_mask(nodes, alive, p: float, key) -> np.ndarray:
    """[C] bool random coarsening cut: collapse a fraction ``p`` of leaves
    into their parents, level-synchronously from the deepest level up
    (reference get_random_cut, gaussian_model.py:528-551). Host-side.

    ``key`` is an int, which seeds ``np.random.default_rng`` as the JAX
    package's int key does, or a ``torch.Generator``, from which one seed
    is drawn."""
    nodes = _host(nodes)
    alive = _host(alive)
    real = alive & (nodes[:, NODE_DEPTH] >= 0)
    cut = real & (nodes[:, NODE_CHILD_COUNT] == 0)

    if isinstance(key, torch.Generator):
        key = int(torch.randint(0, 2**31 - 1, (), generator=key,
                                device=key.device))
    rng = np.random.default_rng(key)
    leaves = np.where(cut)[0]
    subset = rng.permutation(leaves)[: int(len(leaves) * p)]
    if len(subset) == 0:
        return cut
    depth = nodes[:, NODE_DEPTH]
    for d in range(int(depth[subset].max()), 0, -1):
        at_d = subset[depth[subset] == d]
        first = at_d[nodes[at_d, NODE_NEXT_SIBLING] > 0]
        sibs = nodes[first, NODE_NEXT_SIBLING]
        ok = cut[sibs]
        first, sibs = first[ok], sibs[ok]
        parents = nodes[first, NODE_PARENT]
        cut[parents] = True
        cut[first] = False
        cut[sibs] = False
        subset = np.concatenate([parents, subset[depth[subset] < d]])
    return cut


def sibling_weights(nodes, log_scale, opacity_logit, alive) -> torch.Tensor:
    """[C] weights: opacity * ellipse surface, normalized so each sibling
    pair sums to 1; roots get 1 (recompute_weights,
    gaussian_model.py:557-568). Drives parent->child gradient splitting.
    Tensors in, on one device; the dropped lanes of the two scatters land
    in a spare row."""
    c = nodes.shape[0]
    scales = torch.exp(log_scale)
    surface = (scales[:, 0] * scales[:, 1] + scales[:, 0] * scales[:, 2]
               + scales[:, 1] * scales[:, 2])
    w = surface * torch.sigmoid(opacity_logit[:, 0])

    first = nodes[:, NODE_FIRST_CHILD].long()
    has_kids = (nodes[:, NODE_CHILD_COUNT] > 0) & alive
    f_c = torch.clamp(first, 0, c - 1)
    sib = torch.clamp(nodes[f_c, NODE_NEXT_SIBLING].long(), 0, c - 1)
    denom = w[f_c] + w[sib]
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))

    norm = torch.ones((c + 1,), dtype=w.dtype, device=w.device)
    none = torch.full_like(f_c, c)
    norm[drop_index(torch.where(has_kids, f_c, none), c)] = w[f_c] / denom
    norm[drop_index(torch.where(has_kids, sib, none), c)] = w[sib] / denom
    return torch.where(alive, norm[:c], torch.zeros_like(w))


def compute_anchors(nodes, pos, max_scale, alive, viewpoints,
                    target_size, device=None) -> np.ndarray:
    """Anchor gaussian indices (AppearanceFilter::writeAnchors,
    appearance_filter.cpp:377-455): the bottom cut of the
    visible-from-any-viewpoint set plus everything below it. Rows above the
    bottom cut are "anchored" detail the filter may prune/freeze. The
    visibility cuts run on ``device`` (as in `appearance_filter_mask`), the
    tree walks on the host."""
    seen = appearance_filter_mask(nodes, pos, max_scale, alive, viewpoints,
                                  target_size, device=device).cpu().numpy()
    nodes_np = _host(nodes)
    c = nodes_np.shape[0]
    parent = nodes_np[:, NODE_PARENT]

    # bottom = seen nodes with no seen child (seen is ancestor-closed)
    has_seen_child = np.zeros(c, bool)
    pm = (parent >= 0) & seen
    has_seen_child[parent[pm]] = True
    bottom = seen & ~has_seen_child

    # anchors = seen nodes + all descendants of bottom nodes
    anchor = seen.copy()
    below = bottom.copy()
    for _ in range(64):
        child_of_below = (parent >= 0) & below[np.clip(parent, 0, c - 1)]
        new = child_of_below & ~below
        if not new.any():
            break
        below |= new
        anchor |= new
    return np.where(anchor)[0].astype(np.int32)


def write_anchors(path: str, indices: np.ndarray) -> None:
    """anchors.bin: [int32 count][int32 indices...] — byte-compatible with
    the reference reader (scene/gaussian_model.py:1004-1013)."""
    idx = np.asarray(indices, np.int32)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(idx)))
        f.write(idx.astype("<i4").tobytes())


def read_anchors(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        n = struct.unpack("<i", f.read(4))[0]
        return np.frombuffer(f.read(4 * n), dtype="<i4").copy()
