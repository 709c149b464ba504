"""Inputs made from the run's seed, on the device, in a few large calls:
the flat scene, the LOD leaves and the tree over them, and the cameras.
The same tensors go to the program and to the reference.

The distributions are those of the repository's bench scene
(`scripts/bench_scene.py`: a converged flat 3DGS chunk's screen statistics)
and of its LOD bench tree (`bench.py`: 2^19 leaves around z = 30), drawn
here from a `torch.Generator` seeded with `--seed`, so every seed gives
the same sizes and another draw.

The tree is built here, by the hierarchical 3DGS creator's method
(kd-median split along the longest side of each segment's box of
mean +- 3 max scale; covariance-preserving merge with weights
opacity x ellipse surface; opacity over 1 kept at 1 by inflating the
scale), so a served scene is an input like a file from create-hierarchy,
and the reference needs nothing that the program built.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness.reference import Camera, rotation


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 63))
    return g


def yaw_camera(yaw, width, height, fovx, fovy, device, znear=0.01,
               zfar=100.0) -> Camera:
    """A camera at the origin looking down +z, yawed `yaw` radians about
    y (3DGS's getWorld2View and getProjectionMatrix, row-vector form)."""
    c, s = math.cos(yaw), math.sin(yaw)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    view = np.eye(4)
    view[:3, :3] = r
    tx, ty = math.tan(fovx / 2), math.tan(fovy / 2)
    top, right = ty * znear, tx * znear
    proj = np.zeros((4, 4))
    proj[0, 0] = 2 * znear / (2 * right)
    proj[1, 1] = 2 * znear / (2 * top)
    proj[3, 2] = 1.0
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    full = view.astype(np.float32) @ proj.T.astype(np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(view=t(view), full_proj=t(full), campos=t(np.zeros(3)),
                  tan_fovx=float(np.float32(tx)),
                  tan_fovy=float(np.float32(ty)), width=int(width),
                  height=int(height))


def cameras(cfg: dict, traffic: dict, device):
    return [yaw_camera(traffic["yaw_step"] * i, cfg["width"], cfg["height"],
                       cfg["fovx"], cfg["fovy"], device)
            for i in range(traffic["views"])]


def flat_scene(cfg: dict, seed: int, device) -> dict:
    """Raw parameters of the bench scene: positions N(0, s) around z0,
    log-normal scales, unit quaternions, opacity U(lo, hi) as logits,
    SH DC and rest coefficients N(0, sigma)."""
    s = cfg["scene"]
    n = cfg["n_gaussians"]
    g = generator(seed, device)
    k = (cfg["sh_degree"] + 1) ** 2 - 1

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    xyz = randn(n, 3) * s["pos_sigma"]
    xyz[:, 2] += s["pos_z"]
    log_scale = randn(n, 3) * s["log_scale_sigma"] + math.log(
        s["scale_median"])
    quat = randn(n, 4)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    op = torch.rand((n,), generator=g, device=device) * (
        s["opacity_hi"] - s["opacity_lo"]) + s["opacity_lo"]
    return dict(xyz=xyz, log_scale=log_scale, quat=quat,
                opacity_logit=torch.log(op / (1 - op))[:, None],
                f_dc=randn(n, 1, 3) * s["dc_sigma"],
                f_rest=randn(n, k, 3) * s["rest_sigma"],
                exposure=torch.eye(3, 4, device=device)[None])


def perturb(scene: dict, traffic: dict, seed: int, device) -> dict:
    """The training start: the SH DC shifted and the positions jittered."""
    p = traffic["perturb"]
    g = generator(seed, device, stream=1)
    jitter = torch.randn(scene["xyz"].shape, generator=g, device=device)
    return dict(scene, f_dc=scene["f_dc"] + p["f_dc_shift"],
                xyz=scene["xyz"] + jitter * p["xyz_sigma"])


def lod_leaves(cfg: dict, seed: int, device):
    """(pos, scale, quat, opacity, sh) of the LOD leaves."""
    s = cfg["leaves"]
    n = cfg["n_leaves"]
    g = generator(seed, device)
    k = (cfg["sh_degree"] + 1) ** 2

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    pos = randn(n, 3) * s["pos_sigma"]
    pos[:, 2] += s["pos_z"]
    scale = torch.exp(randn(n, 3) * s["log_scale_sigma"]
                      + s["log_scale_mean"])
    quat = randn(n, 4)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    op = torch.rand((n,), generator=g, device=device) * (
        s["opacity_hi"] - s["opacity_lo"]) + s["opacity_lo"]
    sh = randn(n, k, 3) * s["rest_sigma"]
    sh[:, 0] = randn(n, 3) * s["dc_sigma"]
    return pos, scale, quat, op, sh


def quat_from_rotation(r):
    """Proper rotation matrices [..., 3, 3] -> unit (w, x, y, z), w >= 0."""
    m00, m11, m22 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    cand = torch.stack([
        torch.stack([1 + m00 + m11 + m22, r[..., 2, 1] - r[..., 1, 2],
                     r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]],
                    -1),
        torch.stack([r[..., 2, 1] - r[..., 1, 2], 1 + m00 - m11 - m22,
                     r[..., 0, 1] + r[..., 1, 0], r[..., 0, 2] + r[..., 2, 0]],
                    -1),
        torch.stack([r[..., 0, 2] - r[..., 2, 0], r[..., 0, 1] + r[..., 1, 0],
                     1 - m00 + m11 - m22, r[..., 1, 2] + r[..., 2, 1]], -1),
        torch.stack([r[..., 1, 0] - r[..., 0, 1], r[..., 0, 2] + r[..., 2, 0],
                     r[..., 1, 2] + r[..., 2, 1], 1 - m00 - m11 + m22], -1),
    ], -2)
    best = torch.argmax(torch.stack([m00 + m11 + m22, m00, m11, m22], -1), -1)
    q = torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def _eigh(a, batch=1 << 14):
    """torch.linalg.eigh in batches (the batched solver refuses very large
    batches)."""
    parts = [torch.linalg.eigh(a[i:i + batch])
             for i in range(0, a.shape[0], batch)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _surface(s):
    return (s[..., 0] * s[..., 1] + s[..., 0] * s[..., 2]
            + s[..., 1] * s[..., 2])


def build_tree(pos, scale, quat, opacity, sh) -> dict:
    """A complete binary tree over 2^L leaves in heap order (children of
    node i are 2i+1 and 2i+2): {pos, scale, quat, opacity, sh, nodes
    [2^(L+1)-1, 6] int32 (depth, parent, children, first child, next
    sibling, 0), alive}."""
    n = pos.shape[0]
    levels = int(round(math.log2(n)))
    if n < 2 or 1 << levels != n:
        raise ValueError(f"the tree needs a power of two of leaves, not {n}")
    dev = pos.device
    r = 3.0 * torch.max(scale, dim=1).values[:, None]
    lo_pt, hi_pt = pos - r, pos + r
    seg = torch.zeros(n, dtype=torch.long, device=dev)
    for level in range(levels):
        nseg, size = 1 << level, n >> level
        idx = seg[:, None].expand(n, 3)
        lo = torch.full((nseg, 3), float("inf"), device=dev).scatter_reduce(
            0, idx, lo_pt, "amin")
        hi = torch.full((nseg, 3), -float("inf"), device=dev).scatter_reduce(
            0, idx, hi_pt, "amax")
        axis = torch.argmax(hi - lo, dim=1)
        key = torch.gather(pos, 1, axis[seg][:, None])[:, 0]
        order = torch.sort(key, stable=True).indices
        order = order[torch.sort(seg[order], stable=True).indices]
        rank = torch.empty_like(seg)
        rank[order] = torch.arange(n, device=dev) - seg[order] * size
        seg = 2 * seg + (rank >= size // 2).long()

    slots = 2 * n - 1
    first_leaf = n - 1
    tree = dict(pos=torch.zeros((slots, 3), device=dev),
                scale=torch.ones((slots, 3), device=dev),
                quat=torch.zeros((slots, 4), device=dev),
                opacity=torch.zeros((slots,), device=dev),
                sh=torch.zeros((slots,) + sh.shape[1:], device=dev))
    leaf = first_leaf + seg
    for key, val in zip(("pos", "scale", "quat", "opacity", "sh"),
                        (pos, scale, quat, opacity, sh)):
        tree[key][leaf] = val
    for level in range(levels - 1, -1, -1):
        par = torch.arange((1 << level) - 1, (1 << (level + 1)) - 1,
                           device=dev)
        kids = (2 * par + 1, 2 * par + 2)
        w = [tree["opacity"][c] * _surface(tree["scale"][c]) for c in kids]
        wsum = w[0] + w[1]
        a = [wi / torch.where(wsum > 0, wsum, torch.ones_like(wsum))
             for wi in w]
        mean = a[0][:, None] * tree["pos"][kids[0]] \
            + a[1][:, None] * tree["pos"][kids[1]]
        cov = torch.eye(3, device=dev) * 1e-12
        for ai, c in zip(a, kids):
            d = tree["pos"][c] - mean
            rot = rotation(tree["quat"][c]) * tree["scale"][c][:, None, :]
            cov = cov + ai[:, None, None] * (rot @ rot.transpose(1, 2)
                                             + d[:, :, None] * d[:, None, :])
        evals, evecs = _eigh(cov)
        flip = torch.linalg.det(evecs) < 0
        evecs = torch.cat([evecs[..., :2], torch.where(
            flip[:, None, None], -evecs[..., 2:], evecs[..., 2:])], -1)
        s = torch.sqrt(torch.abs(evals))
        s = s * torch.sqrt(torch.clamp_min(
            wsum / torch.clamp_min(_surface(s), 1e-20), 1.0))[:, None]
        tree["pos"][par] = mean
        tree["scale"][par] = s
        tree["quat"][par] = quat_from_rotation(evecs)
        tree["opacity"][par] = wsum / torch.clamp_min(_surface(s), 1e-20)
        tree["sh"][par] = a[0][:, None, None] * tree["sh"][kids[0]] \
            + a[1][:, None, None] * tree["sh"][kids[1]]

    i = torch.arange(slots, device=dev)
    interior = i < first_leaf
    depth = torch.floor(torch.log2((i + 1).double())).int()
    nodes = torch.stack([
        depth, torch.where(i == 0, -1, torch.div(i - 1, 2,
                                                 rounding_mode="floor")),
        torch.where(interior, 2, 0), torch.where(interior, 2 * i + 1, -1),
        torch.where((i % 2 == 1), i + 1, -1), torch.zeros_like(i)],
        dim=1).int()
    tree["nodes"] = nodes.contiguous()
    tree["alive"] = torch.ones((slots,), dtype=torch.bool, device=dev)
    tree["opacity"] = torch.clamp(tree["opacity"], 0.0, 1.0)
    return tree
