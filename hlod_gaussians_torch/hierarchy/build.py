"""Merge-hierarchy construction as level-synchronous tensor passes (port of
hlod_gaussians_tpu/hierarchy/build.py; reference GaussianHierarchyCreator:
PointbasedKdTreeGenerator.cpp:16-68 kd-tree, ClusterMerger.cpp:23-169
covariance-preserving merge, rotation_aligner.cpp:23-108 alignment).

* kd-median split: each level sorts (segment, coordinate along the
  segment's longest axis) once and splits every segment at its median.
  Segments are binary-heap slots (children of h are 2h+1 and 2h+2), so the
  tree is a fixed array of 2^(L+1)-1 slots.
* cluster merge, bottom-up, one batched pass per level: weights
  w = opacity * (s0*s1 + s0*s2 + s1*s2), merged mean and SH the weighted
  average, merged covariance sum_i a_i (Sigma_i + d_i d_i^T), scales and
  rotation from a closed-form 3x3 eigendecomposition.
* rotation alignment, top-down, one batched pass per level: each node takes
  the proper signed axis permutation of its rotation closest to its
  parent's (Frobenius inner product), permuting its scale alike.

The passes run on the device of the input tensors (the card by default);
`compact_hierarchy` densifies the occupied slots into the model's node
table on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from hlod_gaussians_torch.models.gaussians import (
    NODE_CHILD_COUNT, NODE_DEPTH, NODE_FIRST_CHILD, NODE_NEXT_SIBLING,
    NODE_PARENT)
from hlod_gaussians_torch.ops import gaussian_math, quaternion


def heap_depth(idx):
    """Exact floor(log2(idx+1)) of integer heap indices, by counting the
    level thresholds in integers: a float32 log2 misplaces indices just
    below a level boundary above 2^24."""
    idx1 = idx.long() + 1
    depth = torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)
    for k in range(1, 31):
        depth += (idx1 >= (1 << k)).to(torch.int32)
    return depth


def ellipse_surface(scale):
    """scale [...,3] -> s0*s1 + s0*s2 + s1*s2 (ClusterMerger.cpp:16-21)."""
    return (scale[..., 0] * scale[..., 1] + scale[..., 0] * scale[..., 2]
            + scale[..., 1] * scale[..., 2])


def sym_eigh3(a):
    """Closed-form eigendecomposition of symmetric [...,3,3] matrices:
    trigonometric eigenvalues (Smith's method), ascending, and null-space
    eigenvectors from row cross products (columns of the returned matrix).
    The covariances here are PSD with a small diagonal floor."""
    q = (a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2]) / 3.0
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    d0 = a[..., 0, 0] - q
    d1 = a[..., 1, 1] - q
    d2 = a[..., 2, 2] - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * (a01 ** 2 + a02 ** 2 + a12 ** 2)
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))

    inv_p = 1.0 / p
    b00, b11, b22 = d0 * inv_p, d1 * inv_p, d2 * inv_p
    b01, b02, b12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    evals = torch.stack([e_lo, e_mid, e_hi], dim=-1)         # ascending

    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    x_axis = eye[0].expand(a.shape[:-1])
    y_axis = eye[1].expand(a.shape[:-1])

    def null_vec(lam):
        # the largest cross product of two rows of (A - lambda I); a fixed
        # axis where the eigenvalue repeats (Gram-Schmidt below restores an
        # orthonormal frame)
        m = a - lam[..., None, None] * eye
        c01 = torch.linalg.cross(m[..., 0, :], m[..., 1, :])
        c02 = torch.linalg.cross(m[..., 0, :], m[..., 2, :])
        c12 = torch.linalg.cross(m[..., 1, :], m[..., 2, :])
        n01 = torch.sum(c01 * c01, dim=-1, keepdim=True)
        n02 = torch.sum(c02 * c02, dim=-1, keepdim=True)
        n12 = torch.sum(c12 * c12, dim=-1, keepdim=True)
        best = torch.where(n01 >= torch.maximum(n02, n12), c01,
                           torch.where(n02 >= n12, c02, c12))
        nrm = torch.sqrt(torch.sum(best * best, dim=-1, keepdim=True))
        return torch.where(nrm > 1e-20, best / torch.clamp_min(nrm, 1e-20),
                           x_axis)

    v0 = null_vec(evals[..., 0])
    v1 = null_vec(evals[..., 1])
    v1 = v1 - torch.sum(v0 * v1, dim=-1, keepdim=True) * v0
    n1 = torch.sqrt(torch.sum(v1 * v1, dim=-1, keepdim=True))
    fallback = torch.linalg.cross(
        v0, torch.where(torch.abs(v0[..., 0:1]) < 0.9, x_axis, y_axis))
    fallback = fallback / torch.sqrt(
        torch.sum(fallback * fallback, dim=-1, keepdim=True))
    v1 = torch.where(n1 > 1e-10, v1 / torch.clamp_min(n1, 1e-20), fallback)
    v2 = torch.linalg.cross(v0, v1)
    return evals, torch.stack([v0, v1, v2], dim=-1)


class PaddedHierarchy(NamedTuple):
    """Heap-slot hierarchy: tensors of H = 2^(L+1)-1 slots, `occupied`
    marks real nodes. Leaves hold the input Gaussians, interior slots the
    merged ones."""

    pos: torch.Tensor         # [H,3]
    scale: torch.Tensor       # [H,3] linear
    quat: torch.Tensor        # [H,4] (w,x,y,z) normalized
    opacity: torch.Tensor     # [H]
    sh: torch.Tensor          # [H,K,3]
    box_lo: torch.Tensor      # [H,3] AABB min
    box_hi: torch.Tensor      # [H,3] AABB max
    max_side: torch.Tensor    # [H] longest AABB side
    occupied: torch.Tensor    # [H] bool
    interior: torch.Tensor    # [H] bool (occupied, with 2 children)
    leaf_point: torch.Tensor  # [H] int32 input row of a leaf, -1 else
    depth: torch.Tensor       # [H] int32 depth from the root

    @property
    def heap_capacity(self) -> int:
        return self.pos.shape[0]


def _num_levels(n: int) -> int:
    return max(1, math.ceil(math.log2(n))) if n > 1 else 1


def _ordered_int(key):
    """float32 -> int64 in the floats' order, shifted to be non-negative
    (below 2^32). -0.0 maps to +0.0's value: XLA's sort compares the two
    equal (and then keeps the index order)."""
    key = torch.where(key == 0, torch.zeros_like(key), key)
    bits = key.contiguous().view(torch.int32)
    flipped = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return flipped.long() + (1 << 31)


def _point_box(means, scales):
    """mean -+ 3*max_scale, each rounded once to float32 as a fused
    multiply-add rounds it (the compiled reference and XLA's fused program
    round it so; two roundings can move a box side by one ulp, which can
    turn a segment's longest axis and so the tree)."""
    r = 3.0 * torch.max(scales, dim=-1, keepdim=True).values.double()
    m = means.double()
    return (m - r).float(), (m + r).float()


def assign_kd_segments(means, scales, n_levels: int):
    """Level-synchronous kd-median split (PointbasedKdTreeGenerator.cpp
    :16-68). Returns (leaf_seg [n] heap slot per point, occupied [H] bool).

    The reference's split: pivot num/2 - 1, the left child takes
    [0, num/2), along the longest side of the segment's box of
    mean +- 3*max_scale. Ranks within a segment follow (key, point index),
    as XLA's sort of (segment, key, index) on two keys orders them."""
    n = means.shape[0]
    dev = means.device
    h_cap = 2 ** (n_levels + 1) - 1
    lo_pt, hi_pt = _point_box(means, scales)
    arange_n = torch.arange(n, device=dev)

    seg = torch.zeros(n, dtype=torch.long, device=dev)
    occupied = torch.zeros(h_cap, dtype=torch.bool, device=dev)
    occupied[0] = True
    for _level in range(n_levels):
        counts = torch.zeros(h_cap, dtype=torch.long, device=dev)
        counts.index_add_(0, seg, torch.ones_like(seg))
        count_pt = counts[seg]
        # an empty segment keeps +inf / -inf, so its argmax picks axis 0
        lo = torch.full((h_cap, 3), float("inf"), device=dev).scatter_reduce(
            0, seg[:, None].expand(n, 3), lo_pt, "amin")
        hi = torch.full((h_cap, 3), -float("inf"), device=dev).scatter_reduce(
            0, seg[:, None].expand(n, 3), hi_pt, "amax")
        axis = torch.argmax(hi - lo, dim=-1)                       # [H]
        key = torch.gather(means, 1, axis[seg][:, None])[:, 0]

        # rank of each point within its segment by (seg, key, index)
        order = torch.sort((seg << 32) | _ordered_int(key),
                           stable=True).indices
        sorted_seg = seg[order]
        start = torch.searchsorted(sorted_seg, sorted_seg)
        rank = torch.empty_like(seg)
        rank[order] = arange_n - start

        is_right = (rank >= count_pt // 2).long()
        seg = torch.where(count_pt >= 2, 2 * seg + 1 + is_right, seg)
        occupied[seg] = True
    return seg, occupied


def _children(x, lo_i: int, hi_i: int):
    """(left, right) children of parents [lo_i, hi_i): stride-2 slices."""
    c_lo, c_hi = 2 * lo_i + 1, 2 * hi_i + 1
    return x[c_lo:c_hi:2], x[c_lo + 1:c_hi + 1:2]


def _merge_level(arrays, lo_i: int, hi_i: int, clamp_opacity: bool = True):
    """Cluster merge of the children of parents [lo_i, hi_i)
    (ClusterMerger.cpp:50-146); returns the merged parent rows."""
    pos, scale, quat, opacity, sh, box_lo, box_hi, _ = arrays
    p0, p1 = _children(pos, lo_i, hi_i)
    s0, s1 = _children(scale, lo_i, hi_i)
    q0, q1 = _children(quat, lo_i, hi_i)
    o0, o1 = _children(opacity, lo_i, hi_i)
    sh0, sh1 = _children(sh, lo_i, hi_i)

    w0 = o0 * ellipse_surface(s0)
    w1 = o1 * ellipse_surface(s1)
    wsum = w0 + w1
    wsafe = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    a0 = (w0 / wsafe)[:, None]
    a1 = (w1 / wsafe)[:, None]

    mpos = a0 * p0 + a1 * p1
    msh = a0[..., None] * sh0 + a1[..., None] * sh1

    cov0 = gaussian_math.unpack_cov3d(gaussian_math.compute_cov3d(s0, q0))
    cov1 = gaussian_math.unpack_cov3d(gaussian_math.compute_cov3d(s1, q1))
    d0 = p0 - mpos
    d1 = p1 - mpos
    mcov = (a0[..., None] * (cov0 + d0[:, :, None] * d0[:, None, :])
            + a1[..., None] * (cov1 + d1[:, :, None] * d1[:, None, :]))
    # the floor of the reference's retry loop (ClusterMerger.cpp:101-116)
    mcov = mcov + torch.eye(3, device=mcov.device) * 1e-12

    evals, evecs = sym_eigh3(mcov)
    mscale = torch.sqrt(torch.abs(evals))
    # handedness fix (ClusterMerger.cpp:118-126)
    cross = torch.linalg.cross(evecs[..., :, 0], evecs[..., :, 1])
    det_neg = torch.sum(cross * evecs[..., :, 2], dim=-1) < 0
    evecs = torch.cat([evecs[..., :, :2], torch.where(
        det_neg[:, None], -evecs[..., :, 2], evecs[..., :, 2])[..., None]],
        dim=-1)
    mquat = quaternion.from_matrix(evecs)
    # the reference writes opacity = wsum / surface unclamped, which can
    # exceed 1 (ClusterMerger.cpp:139). clamp_opacity inflates the scale by
    # sqrt(wsum / surface) instead: the surface is quadratic in the scale,
    # so the opacity lands at 1 and opacity * surface is kept.
    # clamp_opacity=False is the reference exactly.
    surf = torch.clamp_min(ellipse_surface(mscale), 1e-20)
    if clamp_opacity:
        inflate = torch.sqrt(torch.clamp_min(wsum / surf, 1.0))
        mscale = mscale * inflate[..., None]
    mop = wsum / torch.clamp_min(ellipse_surface(mscale), 1e-20)

    # AABB union and its longest side (ClusterMerger.cpp:148-169)
    blo = torch.minimum(*_children(box_lo, lo_i, hi_i))
    bhi = torch.maximum(*_children(box_hi, lo_i, hi_i))
    mside = torch.max(bhi - blo, dim=-1).values
    return mpos, mscale, mquat, mop, msh, blo, bhi, mside


def _merge_level_avg(arrays, lo_i: int, hi_i: int):
    """Simple-average merge (AvgMerger.cpp:14-44): parent = mean of the
    children's position, opacity, rotation and SH, and the SUM of their
    scales (the reference accumulates scale without dividing)."""
    pos, scale, quat, opacity, sh, box_lo, box_hi, _ = arrays

    def mean(x):
        a, b = _children(x, lo_i, hi_i)
        return 0.5 * (a + b)

    q = mean(quat)
    blo = torch.minimum(*_children(box_lo, lo_i, hi_i))
    bhi = torch.maximum(*_children(box_hi, lo_i, hi_i))
    s0, s1 = _children(scale, lo_i, hi_i)
    return (mean(pos), s0 + s1,
            q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True),
                                1e-12),
            mean(opacity), mean(sh), blo, bhi,
            torch.max(bhi - blo, dim=-1).values)


def _proper_perms():
    """The 24 proper signed axis permutations (det +1)."""
    perms, signs = [], []
    for p in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
              (2, 1, 0)):
        for s in range(8):
            sg = np.array([1 - 2 * ((s >> w) & 1) for w in range(3)],
                          np.float32)
            if np.linalg.det(np.eye(3, dtype=np.float32)[:, list(p)]
                             * sg[None, :]) > 0:
                perms.append(p)
                signs.append(sg)
    return np.asarray(perms, np.int64), np.asarray(signs, np.float32)


_PERMS, _SIGNS = _proper_perms()


def align_rotations_to(parent_quat, child_quat, child_scale):
    """Each child rotation's proper signed axis permutation that best
    matches its parent (largest Frobenius inner product; the first of
    tied ones), and the child scale permuted alike
    (rotation_aligner.cpp:23-89). Batched over the leading axis."""
    dev = child_quat.device
    perms = torch.as_tensor(_PERMS, device=dev)           # [24,3]
    signs = torch.as_tensor(_SIGNS, device=dev)           # [24,3]
    rp = quaternion.to_matrix(quaternion.normalize(parent_quat))
    rc = quaternion.to_matrix(quaternion.normalize(child_quat))

    # candidates: columns permuted and sign-flipped [..., 24, 3, 3]
    cand = rc[..., :, perms].movedim(-3, -2) * signs[:, None, :]
    score = torch.sum(cand * rp[..., None, :, :], dim=(-1, -2))
    best = torch.argmax(score, dim=-1)
    bperm = perms[best]                                   # [..., 3]
    r_best = torch.gather(rc, -1, bperm[..., None, :].expand(rc.shape)) \
        * signs[best][..., None, :]
    return quaternion.from_matrix(r_best), torch.gather(child_scale, -1,
                                                        bperm)


def build_hierarchy_padded(means, scales, quats, opacities, shs, *,
                           n_levels: int, merger: str = "cluster",
                           clamp_opacity: bool = True) -> PaddedHierarchy:
    """kd split, bottom-up merge and top-down alignment on heap slots, on
    the device of the inputs."""
    n = means.shape[0]
    dev = means.device
    h_cap = 2 ** (n_levels + 1) - 1

    leaf_seg, occupied = assign_kd_segments(means, scales, n_levels)
    # a node is interior iff its left child slot is occupied (children come
    # in pairs); the last level's children fall outside the heap
    left_child = 2 * torch.arange(h_cap, device=dev) + 1
    interior = (occupied & (left_child < h_cap)
                & occupied[torch.clamp(left_child, max=h_cap - 1)])

    def slots(fill, rows, shape=()):
        out = torch.full((h_cap,) + shape, fill, dtype=rows.dtype,
                         device=dev)
        out[leaf_seg] = rows
        return out

    lo_pt, hi_pt = _point_box(means, scales)
    quat = torch.zeros((h_cap, 4), device=dev)
    quat[:, 0] = 1.0
    quat[leaf_seg] = quats
    arrays = [
        slots(0.0, means, (3,)), slots(1.0, scales, (3,)), quat,
        slots(0.0, opacities), slots(0.0, shs, tuple(shs.shape[1:])),
        slots(0.0, lo_pt, (3,)), slots(0.0, hi_pt, (3,)),
        slots(0.0, torch.max(hi_pt - lo_pt, dim=-1).values),
    ]
    leaf_point = slots(-1, torch.arange(n, dtype=torch.int32, device=dev))

    for level in range(n_levels - 1, -1, -1):
        lo_i, hi_i = 2 ** level - 1, 2 ** (level + 1) - 1
        if merger == "cluster":
            merged = _merge_level(arrays, lo_i, hi_i, clamp_opacity)
        elif merger == "avg":
            merged = _merge_level_avg(arrays, lo_i, hi_i)
        else:
            raise ValueError(f"unknown merger {merger!r}")
        msk = interior[lo_i:hi_i]
        for a, new in zip(arrays, merged):
            b = msk.reshape((-1,) + (1,) * (new.dim() - 1))
            a[lo_i:hi_i] = torch.where(b, new, a[lo_i:hi_i])
    pos, scale, quat, opacity, sh, box_lo, box_hi, max_side = arrays

    for level in range(1, n_levels + 1):
        lo_i, hi_i = 2 ** level - 1, 2 ** (level + 1) - 1
        par = (torch.arange(lo_i, hi_i, device=dev) - 1) // 2
        nq, ns = align_rotations_to(quat[par], quat[lo_i:hi_i],
                                    scale[lo_i:hi_i])
        has_parent = occupied[lo_i:hi_i, None]
        quat[lo_i:hi_i] = torch.where(has_parent, nq, quat[lo_i:hi_i])
        scale[lo_i:hi_i] = torch.where(has_parent, ns, scale[lo_i:hi_i])

    return PaddedHierarchy(
        pos=pos, scale=scale, quat=quat, opacity=opacity, sh=sh,
        box_lo=box_lo, box_hi=box_hi, max_side=max_side, occupied=occupied,
        interior=interior, leaf_point=leaf_point,
        depth=heap_depth(torch.arange(h_cap, device=dev)))


class Hierarchy(NamedTuple):
    """Dense hierarchy: M = 2n-1 nodes, node index == Gaussian index; node
    table columns as in the model (scene/gaussian_model.py:31-36)."""

    pos: np.ndarray
    scale: np.ndarray
    quat: np.ndarray
    opacity: np.ndarray
    sh: np.ndarray
    nodes: np.ndarray       # [M,6] int32
    box_lo: np.ndarray
    box_hi: np.ndarray
    max_side: np.ndarray
    leaf_point: np.ndarray  # [M] input row of a leaf (-1 for interior)


def compact_hierarchy(ph: PaddedHierarchy) -> Hierarchy:
    """Occupied heap slots -> dense node table (host-side indexing)."""
    occ = ph.occupied.cpu().numpy()
    h_cap = occ.shape[0]
    new_idx = np.cumsum(occ) - 1              # heap slot -> dense index
    heap_ids = np.nonzero(occ)[0]
    m = heap_ids.shape[0]

    interior = ph.interior.cpu().numpy()[heap_ids]
    parent = np.where(heap_ids == 0, -1, new_idx[(heap_ids - 1) // 2])
    first_child = np.where(interior,
                           new_idx[np.minimum(2 * heap_ids + 1, h_cap - 1)],
                           -1)
    # next sibling: a left child's is its right sibling, a right child's 0
    is_left = heap_ids % 2 == 1
    next_sib = np.where(is_left & (heap_ids != 0),
                        new_idx[np.minimum(heap_ids + 1, h_cap - 1)], 0)

    nodes = np.stack([
        ph.depth.cpu().numpy()[heap_ids], parent, np.where(interior, 2, 0),
        first_child, next_sib, np.zeros(m, np.int64)], axis=-1)

    idx = torch.as_tensor(heap_ids, device=ph.pos.device)

    def take(x):
        return x[idx].cpu().numpy()

    return Hierarchy(
        pos=take(ph.pos), scale=take(ph.scale), quat=take(ph.quat),
        opacity=take(ph.opacity), sh=take(ph.sh),
        nodes=nodes.astype(np.int32), box_lo=take(ph.box_lo),
        box_hi=take(ph.box_hi), max_side=take(ph.max_side),
        leaf_point=take(ph.leaf_point))


def _tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def build_hierarchy(means, scales, quats, opacities, shs,
                    merger: str = "cluster", clamp_opacity: bool = True,
                    device=None) -> Hierarchy:
    """Offline entry point: numpy arrays or tensors in, dense Hierarchy
    out. The build runs on ``device``: by default the device of ``means``
    when it is a tensor, else the card.

    merger="cluster" is the covariance-preserving merge (ClusterMerger.cpp);
    "avg" the simple average (AvgMerger.cpp)."""
    if device is None:
        device = (means.device if isinstance(means, torch.Tensor)
                  else torch.device("cuda"))
    means, scales, quats, opacities, shs = (
        _tensor(x, device) for x in (means, scales, quats, opacities, shs))
    ph = build_hierarchy_padded(
        means, scales, quats, opacities, shs,
        n_levels=_num_levels(means.shape[0]), merger=merger,
        clamp_opacity=clamp_opacity)
    return compact_hierarchy(ph)


def build_flat(means, scales, quats, opacities, shs) -> Hierarchy:
    """Single-root flat "hierarchy" (FlatGenerator.cpp:14-31 + AvgMerger
    root): node 0 is an average-merged root whose children are every input
    Gaussian, chained as siblings. numpy, on the host."""
    means, scales, quats, opacities, shs = (
        np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        for x in (means, scales, quats, opacities, shs))
    n = int(means.shape[0])
    c = n + 1
    nodes = np.full((c, 6), -1, np.int32)
    nodes[0, NODE_DEPTH] = 0
    nodes[0, NODE_PARENT] = -1
    nodes[0, NODE_CHILD_COUNT] = n
    nodes[0, NODE_FIRST_CHILD] = 1
    nodes[1:, NODE_DEPTH] = 1
    nodes[1:, NODE_PARENT] = 0
    nodes[1:, NODE_CHILD_COUNT] = 0
    nodes[1:, NODE_FIRST_CHILD] = -1
    nodes[1:c - 1, NODE_NEXT_SIBLING] = np.arange(2, c, dtype=np.int32)

    q = np.mean(quats, axis=0)
    q /= max(np.linalg.norm(q), 1e-12)
    pos = np.concatenate([np.mean(means, 0, keepdims=True), means],
                         0).astype(np.float32)
    scale = np.concatenate([np.sum(scales, 0, keepdims=True), scales],
                           0).astype(np.float32)
    quat = np.concatenate([q[None], quats], 0).astype(np.float32)
    op = np.concatenate([[np.mean(opacities)], opacities],
                        0).astype(np.float32)
    sh = np.concatenate([np.mean(shs, 0, keepdims=True), shs],
                        0).astype(np.float32)
    r = 3.0 * scale.max(axis=1, keepdims=True)
    box_lo = pos - r
    box_hi = pos + r
    box_lo[0] = (pos[1:] - r[1:]).min(0)
    box_hi[0] = (pos[1:] + r[1:]).max(0)
    return Hierarchy(pos=pos, scale=scale, quat=quat, opacity=op, sh=sh,
                     nodes=nodes, box_lo=box_lo, box_hi=box_hi,
                     max_side=(box_hi - box_lo).max(1).astype(np.float32),
                     leaf_point=np.concatenate(
                         [[-1], np.arange(n)]).astype(np.int32))
