"""Gaussian model state (port of hlod_gaussians_tpu/models/gaussians.py;
reference GaussianModel, scene/gaussian_model.py).

The state is capacity-padded like the JAX package's: every tensor has a
leading capacity C and `alive` selects the live rows. Parameters are stored
raw (log-scales, opacity logits, unnormalized quaternions); `activate`
applies the reference's activations. Skybox rows occupy [0, n_skybox).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from hlod_gaussians_torch.ops import knn as knn_ops
from hlod_gaussians_torch.ops import sh as sh_ops

# Hierarchy node-table columns (reference scene/gaussian_model.py:31-36).
# nodes[i] describes the node whose Gaussian is row i.
NODE_DEPTH = 0
NODE_PARENT = 1
NODE_CHILD_COUNT = 2
NODE_FIRST_CHILD = 3
NODE_NEXT_SIBLING = 4
NODE_AUX = 5


@dataclasses.dataclass(frozen=True)
class GaussianState:
    """Capacity-padded Gaussian parameters.

      xyz           [C,3]   world positions
      f_dc          [C,1,3] SH DC coefficients
      f_rest        [C,K,3] SH rest coefficients
      log_scale     [C,3]
      quat          [C,4]   (w,x,y,z), unnormalized
      opacity_logit [C,1]
      exposure      [E,3,4] per-image affine color transform
      alive         [C] bool
      nodes         [C,6] int32 hierarchy node table (all -1 when flat)
      n_skybox      rows [0, n_skybox) are skybox
      n_scaffold    scaffold rows [n_skybox, n_skybox + n_scaffold)
    """

    xyz: torch.Tensor
    f_dc: torch.Tensor
    f_rest: torch.Tensor
    log_scale: torch.Tensor
    quat: torch.Tensor
    opacity_logit: torch.Tensor
    exposure: torch.Tensor
    alive: torch.Tensor
    nodes: torch.Tensor
    n_skybox: int = 0
    n_scaffold: int = 0

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def sh_degree(self) -> int:
        return {1: 0, 4: 1, 9: 2, 16: 3}[1 + self.f_rest.shape[1]]

    def num_alive(self):
        return torch.sum(self.alive)

    @property
    def skybox_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.xyz.device) < self.n_skybox

    @property
    def protected_mask(self) -> torch.Tensor:
        """Skybox + scaffold rows: never densified, pruned or shrunk."""
        return (torch.arange(self.capacity, device=self.xyz.device)
                < self.n_skybox + self.n_scaffold)

    def params(self) -> dict:
        """The trainable tensors as a dict (for grads and the optimizer)."""
        return dict(xyz=self.xyz, f_dc=self.f_dc, f_rest=self.f_rest,
                    log_scale=self.log_scale, quat=self.quat,
                    opacity_logit=self.opacity_logit, exposure=self.exposure)

    def replace_params(self, p: dict) -> "GaussianState":
        return dataclasses.replace(self, **p)


class Activated(NamedTuple):
    """Activated per-Gaussian quantities consumed by the renderer."""

    means3d: torch.Tensor    # [C,3]
    scales: torch.Tensor     # [C,3] exp(log_scale)
    quats: torch.Tensor      # [C,4] normalized
    opacities: torch.Tensor  # [C] sigmoid(logit)
    shs: torch.Tensor        # [C,K,3]
    valid: torch.Tensor      # [C] bool


def activate(state: GaussianState,
             valid: Optional[torch.Tensor] = None) -> Activated:
    """The reference's activations (scene/gaussian_model.py:677-693)."""
    q = state.quat / torch.linalg.norm(state.quat, dim=-1,
                                       keepdim=True).clamp_min(1e-12)
    return Activated(
        means3d=state.xyz,
        scales=torch.exp(state.log_scale),
        quats=q,
        opacities=torch.sigmoid(state.opacity_logit[..., 0]),
        shs=torch.cat([state.f_dc, state.f_rest], dim=1),
        valid=state.alive if valid is None else (state.alive & valid),
    )


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def scene_extent(cam_centers: np.ndarray) -> float:
    """NeRF++-style scene extent: 1.1 x max distance from the average camera
    center (reference getNerfppNorm, scene/dataset_readers.py:52-73)."""
    center = cam_centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(cam_centers - center, axis=-1)
    return float(dist.max() * 1.1)


def empty_state(capacity: int, sh_degree: int = 3, n_exposures: int = 1,
                n_skybox: int = 0,
                device=torch.device("cuda")) -> GaussianState:
    k_rest = sh_ops.NUM_COEFFS[sh_degree] - 1
    f32 = dict(dtype=torch.float32, device=device)
    ident = torch.cat([torch.eye(3, **f32), torch.zeros((3, 1), **f32)], dim=1)
    quat = torch.zeros((capacity, 4), **f32)
    quat[:, 0] = 1.0
    return GaussianState(
        xyz=torch.zeros((capacity, 3), **f32),
        f_dc=torch.zeros((capacity, 1, 3), **f32),
        f_rest=torch.zeros((capacity, k_rest, 3), **f32),
        log_scale=torch.full((capacity, 3), -10.0, **f32),
        quat=quat,
        opacity_logit=torch.full((capacity, 1), -10.0, **f32),
        exposure=ident[None].repeat(max(n_exposures, 1), 1, 1),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        nodes=torch.full((capacity, 6), -1, dtype=torch.int32, device=device),
        n_skybox=n_skybox,
    )


def make_skybox(n: int, radius: float, seed: int = 0):
    """Skybox point cloud: n points on the upper 2/3 of a sphere of
    ``radius`` (10x the scene radius in the reference), faint blue
    (scene/gaussian_model.py:827-842). Returns numpy (positions [n,3],
    colors [n,3] in [0,1]); the same seed gives the JAX package's points."""
    rng = np.random.default_rng(seed)
    theta = 2.0 * np.pi * rng.random(n)
    phi = np.arccos(1.0 - 1.4 * rng.random(n))
    pos = np.stack([
        radius * np.cos(theta) * np.sin(phi),
        radius * np.sin(theta) * np.sin(phi),
        radius * np.cos(phi),
    ], axis=-1).astype(np.float32)
    colors = np.tile(np.array([[0.7, 0.8, 0.95]], np.float32), (n, 1))
    return pos, colors


def create_from_points(
    points: np.ndarray,            # [N,3]
    colors: np.ndarray,            # [N,3] in [0,1]
    capacity: int,
    sh_degree: int = 3,
    n_exposures: int = 1,
    scene_radius: float = 1.0,
    skybox_num: int = 0,
    skybox_seed: int = 0,
    opacity_init: float = 0.01,
    skybox_opacity: float = 0.7,
    scale_clip_max: Optional[float] = None,
    device=torch.device("cuda"),
) -> GaussianState:
    """Initialize from a point cloud (reference create_from_pcd): optional
    skybox rows first, log-scales from the kNN mean squared distance,
    identity rotation, constant opacity logit, colors -> SH DC."""
    n = points.shape[0]
    total = n + skybox_num
    if total > capacity:
        raise ValueError(f"capacity {capacity} < points {n} + skybox {skybox_num}")

    all_pos = points.astype(np.float32)
    all_col = colors.astype(np.float32)
    if skybox_num > 0:
        sky_pos, sky_col = make_skybox(skybox_num, 10.0 * scene_radius,
                                       skybox_seed)
        all_pos = np.concatenate([sky_pos, all_pos], axis=0)
        all_col = np.concatenate([sky_col, all_col], axis=0)

    # fills the freshly allocated state in place
    state = empty_state(capacity, sh_degree, n_exposures, n_skybox=skybox_num,
                        device=device)
    pos = torch.as_tensor(all_pos, device=device)
    dist2 = torch.clamp_min(knn_ops.knn_mean_sq_dist(pos, k=3), 1e-7)
    log_s = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    if scale_clip_max is not None:
        log_s = torch.clamp_max(log_s, float(np.log(np.float32(scale_clip_max))))

    op = torch.full((total, 1), float(inverse_sigmoid(
        torch.tensor(opacity_init, dtype=torch.float32))), device=device)
    if skybox_num > 0:
        op[:skybox_num] = float(inverse_sigmoid(
            torch.tensor(skybox_opacity, dtype=torch.float32)))

    state.xyz[:total] = pos
    state.f_dc[:total] = sh_ops.rgb_to_sh(
        torch.as_tensor(all_col, device=device))[:, None, :]
    state.log_scale[:total] = log_s
    state.opacity_logit[:total] = op
    state.alive[:total] = True
    return state


def create_from_gaussian_ply(ply, capacity: int, n_exposures: int = 1,
                             device=torch.device("cuda")) -> GaussianState:
    """Initialize from a saved 3DGS point cloud (data.ply.GaussianPly; the
    reference's --pretrained path, scene/__init__.py:82-83 create_from_pt):
    raw parameters are adopted verbatim, quaternions normalized, no kNN
    re-init."""
    n = ply.xyz.shape[0]
    if n > capacity:
        raise ValueError(f"capacity {capacity} < ply points {n}")
    sh_degree = {0: 0, 3: 1, 8: 2, 15: 3}[ply.f_rest.shape[1]]
    state = empty_state(capacity, sh_degree, n_exposures, n_skybox=0,
                        device=device)
    q = ply.quat / np.maximum(
        np.linalg.norm(ply.quat, axis=-1, keepdims=True), 1e-12)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    state.xyz[:n] = dev(ply.xyz)
    state.f_dc[:n] = dev(ply.f_dc)
    state.f_rest[:n] = dev(ply.f_rest)
    state.log_scale[:n] = dev(ply.log_scale)
    state.quat[:n] = dev(q)
    state.opacity_logit[:n] = dev(ply.opacity.reshape(n, 1))
    state.alive[:n] = True
    return state


def select_scaffold_ring(scaffold_xyz: np.ndarray, center: np.ndarray,
                         extent0: float, n_skybox: int) -> np.ndarray:
    """Scaffold rows a chunk conditions on (reference
    scene/gaussian_model.py:890-895): points whose Chebyshev x/y distance to
    the chunk center lies in (0.5*extent, 1.5*extent) — the ring AROUND the
    chunk, the interior being covered by the chunk's own points — plus every
    skybox row. extent0 is the chunk's extent[0] (the reference uses the
    first component for both axes). Numpy in, numpy bool mask out."""
    d = np.abs(np.asarray(scaffold_xyz)[:, :2] - np.asarray(center)[:2])
    m = np.maximum(d[:, 0], d[:, 1])
    sel = (m > 0.5 * extent0) & (m < 1.5 * extent0)
    sel[:n_skybox] = True
    return sel


def create_with_scaffold(
    scaffold: GaussianState,
    chunk_center: np.ndarray,
    chunk_extent0: float,
    points: np.ndarray,
    colors: np.ndarray,
    capacity: int,
    sh_degree: int = 3,
    n_exposures: int = 1,
    opacity_init: float = 0.01,
    max_scaffold_rows: Optional[int] = None,
    device=torch.device("cuda"),
) -> GaussianState:
    """Chunk state conditioned on the trained coarse scaffold (reference
    create_from_pcd with scaffold_file, scene/gaussian_model.py:866-919):

    rows = [scaffold skybox | scaffold ring (trained params) | chunk
    points]. Scaffold rows keep their trained raw parameters, their SH rest
    zero-padded to the chunk's degree or truncated to it; chunk points get
    the kNN scale / SH-DC init of create_from_points. With
    ``max_scaffold_rows`` a ring larger than that keeps every skybox row
    and an even subsample of the rest (the JAX package's deviation for
    scaffolds as dense as the chunks)."""
    def host(t):
        return t.detach().cpu().numpy()

    sel = select_scaffold_ring(host(scaffold.xyz), chunk_center,
                               chunk_extent0, scaffold.n_skybox)
    sel &= host(scaffold.alive)
    rows = np.where(sel)[0]
    if max_scaffold_rows is not None and len(rows) > max_scaffold_rows:
        sky = rows[rows < scaffold.n_skybox]
        rest = rows[rows >= scaffold.n_skybox]
        keep = max(0, max_scaffold_rows - len(sky))
        if keep < len(rest):
            rest = rest[np.linspace(0, len(rest) - 1, keep).astype(np.int64)]
        rows = np.concatenate([sky, rest])
    n_scaf = len(rows)
    n = points.shape[0]
    if n_scaf + n > capacity:
        raise ValueError(f"capacity {capacity} < scaffold {n_scaf} + points {n}")

    n_sky = int(np.sum(rows < scaffold.n_skybox))
    # fills the freshly allocated state in place
    state = empty_state(capacity, sh_degree, n_exposures, n_skybox=n_sky,
                        device=device)
    k_rest = sh_ops.NUM_COEFFS[sh_degree] - 1
    src_rest = host(scaffold.f_rest)[rows]
    kk = min(k_rest, src_rest.shape[1])

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    pos = dev(points)
    dist2 = torch.clamp_min(knn_ops.knn_mean_sq_dist(pos, k=3), 1e-7)
    total = n_scaf + n
    state.xyz[:n_scaf] = dev(host(scaffold.xyz)[rows])
    state.xyz[n_scaf:total] = pos
    state.f_dc[:n_scaf] = dev(host(scaffold.f_dc)[rows])
    state.f_dc[n_scaf:total] = sh_ops.rgb_to_sh(dev(colors))[:, None, :]
    state.f_rest[:n_scaf, :kk] = dev(src_rest[:, :kk])
    state.log_scale[:n_scaf] = dev(host(scaffold.log_scale)[rows])
    state.log_scale[n_scaf:total] = torch.log(torch.sqrt(dist2))[:, None]
    state.quat[:n_scaf] = dev(host(scaffold.quat)[rows])
    state.opacity_logit[:n_scaf] = dev(host(scaffold.opacity_logit)[rows])
    state.opacity_logit[n_scaf:total] = float(inverse_sigmoid(
        torch.tensor(opacity_init, dtype=torch.float32)))
    state.alive[:total] = True
    return dataclasses.replace(state, n_scaffold=n_scaf - n_sky)
