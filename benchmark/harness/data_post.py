"""Inputs of the post-optimization cells, made from the run's seed on the
device: the leaves of the repository's post bench tree, the 40-view orbit
that looks out from a ring inside it, and the training start over the tree that
`data.build_tree` merges from the leaves. The same tensors go to the
program and to the reference.

The leaves follow the JAX package's post bench (scripts/offload_bench3.py
:47-66, chip_smoke.py's post_bench_leaves): half on a shell of radius
20 + N(0, 1), half in an N(0, 12) volume, log scales N(-3.4, 0.3), unit
quaternions, opacity U(0.2, 0.9), SH DC N(0, 0.4) and the other bands
N(0, 0.05), here up to the configuration's degree and drawn from a
`torch.Generator` seeded with `--seed`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness.data import generator
from benchmark.harness.reference import Camera

# the rows past the tree, as the program's empty state holds them
PAD = dict(xyz=0.0, log_scale=-10.0, opacity_logit=-10.0)


def post_leaves(cfg: dict, seed: int, device):
    """(pos, scale, quat, opacity, sh) of the bench tree's leaves."""
    s = cfg["leaves"]
    n = cfg["n_leaves"]
    g = generator(seed, device)
    k = (cfg["sh_degree"] + 1) ** 2

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    n_shell = n // 2
    sph = randn(n_shell, 3)
    sph = sph / torch.linalg.vector_norm(sph, dim=-1, keepdim=True)
    shell = sph * (s["shell_radius"] + s["shell_sigma"] * randn(n_shell, 1))
    vol = randn(n - n_shell, 3) * s["volume_sigma"]
    pos = torch.cat([shell, vol])
    scale = torch.exp(randn(n, 3) * s["log_scale_sigma"]
                      + s["log_scale_mean"])
    quat = randn(n, 4)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    op = torch.rand((n,), generator=g, device=device) * (
        s["opacity_hi"] - s["opacity_lo"]) + s["opacity_lo"]
    sh = randn(n, k, 3) * s["rest_sigma"]
    sh[:, 0] = randn(n, 3) * s["dc_sigma"]
    return pos, scale, quat, op, sh


def orbit_camera(i: int, n: int, radius: float, width, height, fovx, fovy,
                 device, znear=0.01, zfar=100.0) -> Camera:
    """View i of the n-view orbit: the camera-to-world rotation R yawed
    a = 2 pi i / n about y, as the post bench's orbit (offload_bench3.py
    :107-119) yaws it, and the centre c on the ring of `radius` in the
    direction it looks, R (0, 0, 1) radius = radius (sin a, 0, cos a), so
    every view looks out from its own point of the ring. (The bench passes
    its ring point as the world-to-camera translation, which puts every
    centre at (0, 0, radius).) Row-vector matrices as 3DGS's
    getWorld2View2 and getProjectionMatrix give them, with t = -R^T c."""
    a = 2.0 * math.pi * i / n
    r = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                  [-math.sin(a), 0, math.cos(a)]], np.float64)
    centre = radius * r[:, 2]
    t = -(r.T @ centre)
    rt = np.zeros((4, 4), np.float64)
    rt[:3, :3] = r.T
    rt[:3, 3] = t
    rt[3, 3] = 1.0
    view = rt.T.astype(np.float32)
    tx, ty = math.tan(fovx / 2), math.tan(fovy / 2)
    proj = np.zeros((4, 4))
    proj[0, 0] = 1.0 / tx
    proj[1, 1] = 1.0 / ty
    proj[3, 2] = 1.0
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    full = view @ proj.T.astype(np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(view=f32(view), full_proj=f32(full), campos=f32(centre),
                  tan_fovx=float(np.float32(tx)),
                  tan_fovy=float(np.float32(ty)), width=int(width),
                  height=int(height))


def orbit(cfg: dict, traffic: dict, device):
    return [orbit_camera(i, traffic["views"], traffic["orbit_radius"],
                         cfg["width"], cfg["height"], cfg["fovx"],
                         cfg["fovy"], device)
            for i in range(traffic["views"])]


def post_start(tree: dict, capacity: int, n_exposures: int,
               f_dc_shift: float = 0.0) -> dict:
    """The tree as raw, capacity-padded training parameters: {xyz,
    log_scale, quat, opacity_logit [C, 1], f_dc [C, 1, 3], f_rest
    [C, K, 3], exposure (an identity row a view), nodes [C, 6], alive [C]}; the
    rows past the tree are dead, with the values of the program's empty
    state. `f_dc_shift` is added to every node's SH DC."""
    m = tree["pos"].shape[0]
    dev = tree["pos"].device

    def padded(x, fill):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=dev)
        out[:m] = x
        return out

    op = torch.clamp(tree["opacity"], 1e-6, 1.0 - 1e-6)
    quat = padded(tree["quat"], 0.0)
    quat[m:, 0] = 1.0
    return dict(
        xyz=padded(tree["pos"], PAD["xyz"]),
        log_scale=padded(torch.log(tree["scale"]), PAD["log_scale"]),
        quat=quat,
        opacity_logit=padded(torch.log(op / (1.0 - op))[:, None],
                             PAD["opacity_logit"]),
        f_dc=padded(tree["sh"][:, :1] + f_dc_shift, 0.0),
        f_rest=padded(tree["sh"][:, 1:], 0.0),
        exposure=torch.eye(3, 4, device=dev)[None].repeat(
            n_exposures, 1, 1),
        nodes=padded(tree["nodes"], -1),
        alive=padded(tree["alive"], False))
