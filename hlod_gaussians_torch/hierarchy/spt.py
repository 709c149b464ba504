"""SPT ("SubPointTree") caches: granularity-indexed flat subtrees for
LOD-aware training (port of hlod_gaussians_tpu/hierarchy/spt.py; reference
scene/gaussian_model.py:109-345 + runtime_switching.cu:784-994).

* ``build_spt`` — cut the full tree where prod(scales) > root_volume; the
  nodes above the cut become the re-indexed "upper tree"; each cut node with
  >= min_spt_size descendants becomes an SPT: flat arrays (gaussian index,
  min_distance, max_distance) sorted per SPT by descending max_distance. A
  host numpy sweep over the whole forest, the JAX package's own code; the
  arrays then move to the requested device.
* ``spt_cut`` — per-view working set: frustum-cull the upper tree, then
  select each visible SPT's entries with max_distance > d > min_distance,
  d the camera distance to the SPT root, as one dense masked compare over
  the flat entry arrays.

Scatters of the JAX package's ``mode="drop"`` write through one spare row
past the end of the target (index C takes every dropped lane), so no
per-view step syncs the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hlod_gaussians_torch.hierarchy.cut import frustum_planes, sphere_in_frustum
from hlod_gaussians_torch.models.gaussians import (
    NODE_AUX, NODE_CHILD_COUNT, NODE_FIRST_CHILD, NODE_NEXT_SIBLING,
    NODE_PARENT)
from hlod_gaussians_torch.ops import gather_rows, mark_rows

_FAR = 1e12


class SPTForest(NamedTuple):
    """Flat SPT arrays + re-indexed upper tree (tensors on one device)."""

    # flat entries over ALL SPTs
    entry_gid: torch.Tensor      # [E] int32 global gaussian index
    entry_min: torch.Tensor      # [E] f32
    entry_max: torch.Tensor      # [E] f32
    entry_spt: torch.Tensor      # [E] int32 owning SPT id
    # per-SPT
    spt_root_global: torch.Tensor  # [S] int32 root's global index
    spt_root_xyz: torch.Tensor     # [S,3]
    # upper tree (local indexing; AUX column = global index map)
    ut_nodes: torch.Tensor       # [U,6] int32
    ut_xyz: torch.Tensor         # [U,3]
    ut_max_scale: torch.Tensor   # [U] activated max scale
    ut_spt_id: torch.Tensor      # [U] int32 SPT id for SPT leaves, -1 else
    ut_bound: torch.Tensor       # [U] bounding radius for frustum culls

    @property
    def n_spts(self) -> int:
        return self.spt_root_global.shape[0]


def _ellipse_min_distance(scales, target_granularity, is_leaf):
    """sqrt(s0*s1 + s0*s2 + s1*s2)/granularity; leaves -> -1e9
    (reference get_min_distance, gaussian_model.py:331-345)."""
    surf = (scales[:, 0] * scales[:, 1] + scales[:, 0] * scales[:, 2]
            + scales[:, 1] * scales[:, 2])
    md = np.sqrt(np.maximum(surf, 0.0)) / target_granularity
    md[is_leaf] = -1e9
    return md


def build_spt(
    nodes: np.ndarray,          # [C,6] int32
    xyz: np.ndarray,            # [C,3]
    scales: np.ndarray,         # [C,3] ACTIVATED (linear)
    alive: np.ndarray,          # [C] bool
    root: int,
    *,
    root_volume: float,
    target_granularity: float,
    min_spt_size: int = 100,
    max_depth: int = 64,
    use_bounding_spheres: bool = True,
    device=torch.device("cuda"),
) -> SPTForest:
    """Host-side vectorized build (numpy level sweeps, no per-SPT loops);
    the forest's tensors land on `device`.

    ``use_bounding_spheres`` selects exact subtree spheres for the frustum
    bound (build_hierarchical_SPT's use_bounding_spheres,
    gaussian_model.py:184-304); False keeps the node's own 3*max_scale."""
    c = nodes.shape[0]
    is_leaf = nodes[:, NODE_CHILD_COUNT] == 0
    cond = (np.prod(scales, axis=-1) > root_volume) & ~is_leaf & alive

    # descend from root through `cond` nodes: visited = cond-ancestor chain
    parent = nodes[:, NODE_PARENT]
    in_walk = np.zeros(c, bool)      # reached by the walk
    in_walk[root] = True
    for _ in range(max_depth):
        # children of (in_walk & cond) nodes join the walk
        p_ok = np.zeros(c, bool)
        valid_parent = (parent >= 0) & alive
        p_idx = np.clip(parent, 0, c - 1)
        p_ok[valid_parent] = in_walk[p_idx[valid_parent]] \
            & cond[p_idx[valid_parent]]
        new = p_ok & ~in_walk
        if not new.any():
            break
        in_walk |= new

    cut_mask = in_walk & ~cond                 # cut nodes (walked, condition fails)
    upper_interior = in_walk & cond            # stays in the upper tree

    # SPT root of every node: nearest cut ancestor-or-self
    spt_root_of = np.full(c, -1, np.int64)
    spt_root_of[cut_mask] = np.where(cut_mask)[0]
    below = ~in_walk & alive                   # strictly below the cut
    for _ in range(max_depth):
        need = below & (spt_root_of < 0) & (parent >= 0)
        if not need.any():
            break
        spt_root_of[need] = spt_root_of[np.clip(parent[need], 0, c - 1)]

    in_spt = (spt_root_of >= 0) & alive
    # subtree sizes per cut node
    sizes = np.bincount(spt_root_of[in_spt], minlength=c)

    # real SPT roots: cut nodes with children and enough descendants
    spt_root_mask = cut_mask & ~is_leaf & (sizes >= min_spt_size)
    spt_roots = np.where(spt_root_mask)[0]
    n_spt = len(spt_roots)
    spt_id_of_root = np.full(c, -1, np.int64)
    spt_id_of_root[spt_roots] = np.arange(n_spt)

    member = in_spt & spt_root_mask[np.clip(spt_root_of, 0, c - 1)]

    # min/max distance windows, top-down (gaussian_model.py:212-246)
    raw_min = _ellipse_min_distance(scales, target_granularity, is_leaf)
    root_center = np.zeros((c, 3), np.float32)
    root_center[member] = xyz[spt_root_of[member]]
    center_dist = np.linalg.norm(xyz - root_center, axis=-1)

    e_min = np.zeros(c, np.float32)
    e_max = np.zeros(c, np.float32)
    # roots: min = raw_min, max = FAR
    e_min[spt_root_mask] = raw_min[spt_root_mask]
    e_max[spt_root_mask] = _FAR
    done = spt_root_mask.copy()
    for _ in range(max_depth):
        need = member & ~done & done[np.clip(parent, 0, c - 1)] & (parent >= 0)
        if not need.any():
            break
        pm = e_min[np.clip(parent[need], 0, c - 1)]
        mn = raw_min[need] + center_dist[need]
        e_min[need] = np.minimum(mn, pm)
        e_max[need] = pm
        done |= need

    # flat entries sorted by (spt, -max)  [per-SPT descending max]
    members = np.where(member)[0]
    spt_of = spt_id_of_root[spt_root_of[members]]
    order = np.lexsort((-e_max[members], spt_of))
    members = members[order]
    spt_of = spt_of[order]

    # --- upper tree: interior walk nodes + ALL cut nodes; small SPTs'
    # descendants are merged in (gaussian_model.py:262-264)
    small_member = in_spt & ~member
    ut_mask = upper_interior | cut_mask | small_member
    ut_global = np.sort(np.where(ut_mask)[0])
    u = len(ut_global)
    local = np.full(c, -1, np.int64)
    local[ut_global] = np.arange(u)

    ut_nodes = nodes[ut_global].copy()
    ut_nodes[:, NODE_AUX] = ut_global.astype(np.int32)
    # remap parent / first_child / next_sibling into local indices
    p = ut_nodes[:, NODE_PARENT]
    ut_nodes[:, NODE_PARENT] = np.where(p >= 0, local[np.clip(p, 0, c - 1)], -1)
    ut_nodes[local[np.clip(root, 0, c - 1)], NODE_PARENT] = -1

    is_spt_leaf = spt_root_mask[ut_global]
    fc = ut_nodes[:, NODE_FIRST_CHILD]
    fc_mapped = np.where(fc > 0, local[np.clip(fc, 0, c - 1)], -1)
    ut_nodes[:, NODE_FIRST_CHILD] = fc_mapped.astype(np.int32)
    ut_nodes[:, NODE_CHILD_COUNT] = np.where(
        is_spt_leaf | (fc_mapped < 0), 0, ut_nodes[:, NODE_CHILD_COUNT])
    ns = ut_nodes[:, NODE_NEXT_SIBLING]
    ut_nodes[:, NODE_NEXT_SIBLING] = np.where(
        ns > 0, local[np.clip(ns, 0, c - 1)], 0).astype(np.int32)

    ut_spt_id = np.where(is_spt_leaf,
                         spt_id_of_root[ut_global], -1).astype(np.int32)

    ut_max_scale = scales[ut_global].max(-1)
    # bounding radius: own 3*max_scale; SPT leaves take the subtree sphere
    bound = 3.0 * ut_max_scale.copy()
    if n_spt and use_bounding_spheres:
        # radius of each SPT = max over members of center_dist + 3*max_scale
        reach = center_dist + 3.0 * scales.max(-1)
        spt_reach = np.zeros(n_spt, np.float32)
        np.maximum.at(spt_reach, spt_id_of_root[spt_root_of[member.nonzero()[0]]],
                      reach[member])
        bound[is_spt_leaf] = np.maximum(bound[is_spt_leaf],
                                        spt_reach[ut_spt_id[is_spt_leaf]])
    # upward propagation (gaussian_model.py:300-318)
    utp = ut_nodes[:, NODE_PARENT]
    for _ in range(max_depth if use_bounding_spheres else 0):
        valid = utp >= 0
        if not valid.any():
            break
        d = np.linalg.norm(xyz[ut_global] - xyz[ut_global[np.clip(utp, 0, u - 1)]],
                           axis=-1)
        cand = np.zeros(u, np.float32)
        np.maximum.at(cand, np.clip(utp, 0, u - 1),
                      np.where(valid, bound + d, 0.0))
        grew = cand > bound
        if not grew.any():
            break
        bound = np.maximum(bound, cand)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                               device=device)

    return SPTForest(
        entry_gid=dev(members, np.int32),
        entry_min=dev(e_min[members], np.float32),
        entry_max=dev(e_max[members], np.float32),
        entry_spt=dev(spt_of, np.int32),
        spt_root_global=dev(spt_roots, np.int32),
        spt_root_xyz=dev(xyz[spt_roots], np.float32),
        ut_nodes=dev(ut_nodes, np.int32),
        ut_xyz=dev(xyz[ut_global], np.float32),
        ut_max_scale=dev(ut_max_scale, np.float32),
        ut_spt_id=dev(ut_spt_id, np.int32),
        ut_bound=dev(bound, np.float32),
    )


class SPTCut(NamedTuple):
    gaussian_mask: torch.Tensor   # [C] bool — global working-set mask
    spt_selected: torch.Tensor    # [S] bool
    spt_distance: torch.Tensor    # [S] f32 camera distance per SPT
    n_selected: torch.Tensor      # 0-d int64 — |working set|


def _distance(points, campos):
    """Euclidean distance of [..., 3] points to campos, summed x, y, z in
    order as XLA reduces the JAX package's norm."""
    d = points - campos
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])


def _entry_selection(forest: SPTForest, dist, spt_sel):
    """Entries whose SPT is selected and whose window holds its distance:
    max > d AND min < d."""
    d_e, sel_e = gather_rows([dist, spt_sel], forest.entry_spt.long())
    return sel_e & (forest.entry_max > d_e) & (forest.entry_min < d_e)


def spt_cut(
    forest: SPTForest,
    capacity: int,
    campos: torch.Tensor,               # [3]
    full_proj: torch.Tensor,            # [4,4]
    distance_multiplier=1.0,
    use_frustum: bool = True,
) -> SPTCut:
    """Per-view working set over `capacity` rows (reference get_SPT_cut,
    gaussian_model.py:109-181 + getSPTCut runtime_switching.cu:878-994), as
    dense masked selects."""
    c = capacity
    dev = forest.ut_nodes.device
    u = forest.ut_nodes.shape[0]

    if use_frustum:
        visible = sphere_in_frustum(forest.ut_xyz, forest.ut_bound,
                                    frustum_planes(full_proj))
    else:
        visible = torch.ones((u,), dtype=torch.bool, device=dev)

    # the reference's coarse LOD condition is disabled (gaussian_model.py:125
    # overrides it with all-true), so the coarse cut = all frustum-visible
    # upper-tree leaves; interior nodes contribute only through their leaves
    is_ut_leaf = forest.ut_nodes[:, NODE_CHILD_COUNT] == 0
    cut_leaf = visible & is_ut_leaf

    # non-SPT leaves render directly (their global index)
    plain_leaf = cut_leaf & (forest.ut_spt_id < 0)
    mask = mark_rows(c, torch.where(plain_leaf, forest.ut_nodes[:, NODE_AUX],
                                    c))

    # selected SPTs + camera distances to their roots
    s = forest.n_spts
    spt_sel = mark_rows(s, torch.where(cut_leaf & (forest.ut_spt_id >= 0),
                                       forest.ut_spt_id, s))
    dist = _distance(forest.spt_root_xyz, campos) * distance_multiplier

    sel_e = _entry_selection(forest, dist, spt_sel)
    mask = mask | mark_rows(c, torch.where(sel_e, forest.entry_gid, c))
    return SPTCut(gaussian_mask=mask, spt_selected=spt_sel,
                  spt_distance=dist, n_selected=torch.sum(mask))


def spt_cut_cached(
    forest: SPTForest,
    capacity: int,
    campos: torch.Tensor,
    full_proj: torch.Tensor,
    prev_selected: torch.Tensor,    # [S] bool — previous view's SPT set
    prev_distance: torch.Tensor,    # [S] f32 — distances the prev cut used
    rtol,                           # PostConfig.reuse_spt_tolerance
    distance_multiplier=1.0,
    use_frustum: bool = True,
) -> SPTCut:
    """spt_cut with the fork's SPT-cache reuse rule (train_post.py:362-394,
    Reuse_SPT_Tolerance): an SPT selected in BOTH consecutive views whose
    camera distance moved less than `rtol` relative KEEPS the previous
    view's cut distance, so its working-set rows stay identical. The
    returned spt_distance is the effective (possibly stale) distance to feed
    back as prev_distance."""
    base = spt_cut(forest, capacity, campos, full_proj, distance_multiplier,
                   use_frustum=use_frustum)
    new_dist = base.spt_distance
    lo = prev_distance * rtol
    hi = prev_distance / max(rtol, 1e-6)
    reuse = (prev_selected & base.spt_selected
             & (new_dist >= lo) & (new_dist <= hi))
    eff = torch.where(reuse, prev_distance, new_dist)

    # re-derive the entry selection at the effective distances; plain
    # (non-SPT) leaves are distance-independent: keep them from the base
    # mask after clearing every SPT-owned row
    sel_e = _entry_selection(forest, eff, base.spt_selected)
    mask = base.gaussian_mask.clone()
    mask[forest.entry_gid.long()] = False
    mask = mask | mark_rows(capacity, torch.where(sel_e, forest.entry_gid,
                                                  capacity))
    return SPTCut(gaussian_mask=mask, spt_selected=base.spt_selected,
                  spt_distance=eff, n_selected=torch.sum(mask))


def spt_cut_budgeted(
    forest: SPTForest,
    capacity: int,
    campos: torch.Tensor,
    full_proj: torch.Tensor,
    budget,
    base_multiplier=1.0,
    grow: float = 1.5,
    use_frustum: bool = True,
    retries: int = 3,
) -> SPTCut:
    """spt_cut with the over-budget fallback and no host sync.

    The reference re-cuts with distance_multiplier *= 1.5 until the working
    set fits (train_post.py:324-430), a device->host sync per view. Here the
    candidate multipliers base * grow^k are all cut and the smallest one
    under budget wins on the device. If even the last one exceeds the budget
    it is returned over budget (compare n_selected to the budget before
    truncating it to a fixed-size index list)."""
    cuts = [spt_cut(forest, capacity, campos, full_proj,
                    distance_multiplier=base_multiplier * (grow ** k),
                    use_frustum=use_frustum)
            for k in range(retries)]
    best = cuts[-1]
    for cut in reversed(cuts[:-1]):
        ok = cut.n_selected <= budget
        best = SPTCut(*(torch.where(ok, a, b) for a, b in zip(cut, best)))
    return best


def mip_respawn_mask(forest: SPTForest, capacity: int,
                     camera_positions: torch.Tensor) -> torch.Tensor:
    """[C] bool: SPT entries too fine to EVER be selected from any training
    camera (reference Use_MIP_respawn, train_post.py:752-761): an entry is
    unreachable when its max-distance window lies below the closest camera's
    distance to its SPT root, so relocate_gs may spend its row elsewhere
    (extra_dead)."""
    # [S] closest-camera distance per SPT root
    d = _distance(forest.spt_root_xyz[:, None, :], camera_positions[None])
    min_d = torch.amin(d, dim=1)
    (d_e,) = gather_rows([min_d], forest.entry_spt.long())
    never = forest.entry_max < d_e
    return mark_rows(capacity, torch.where(never, forest.entry_gid,
                                           capacity))
