"""Tile-parallel rendering: one frame split across ranks by image bands
(port of hlod_gaussians_tpu/parallel/tile_parallel.py:29-190).

The image-space analogue of sequence parallelism: per-tile blends are
independent, so the tile grid splits across the ranks of the `tile` axis.
Every rank projects the (replicated) Gaussians, bins them against ITS
horizontal band of whole tile rows and blends only its own tiles (kernel
B1 on a band of height band_h with max_dup / n entries, its plain version
on the CPU); the bands are then all-gathered and reassembled. Rank r runs
the body of the JAX package's `shard_map` for band r.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.parallel import distributed as pdist
from hlod_gaussians_torch.parallel.data_parallel import Axis
from hlod_gaussians_torch.render import _compute_cut, render_arrays


def render_tile_parallel(
    means3d, scales, quats, opacities, shs, valid,
    world_view, full_proj, campos, tan_fovx, tan_fovy, bg,
    mesh,
    ts=None, kids=None,
    *,
    sh_degree: int, width: int, height: int,
    cfg: RasterizerConfig = RasterizerConfig(),
    k_max: int = 1024,
    axis: str = "tile",
):
    """Render one frame with its pixel rows split over ``axis`` of
    ``mesh`` (a DeviceMesh, a process group, or None for one rank).

    The Gaussians are replicated; each rank culls and bins against its band
    and blends its own tiles. Optional (ts, kids) turn on the in-kernel LOD
    alpha (hierarchy rendering). Returns the [3, H, W] image and whether
    any band overflowed its max_dup / n entries (callers must surface it,
    as RenderResult.truncated)."""
    if mesh is None:
        ax = Axis(1, 0, None)
    else:
        group = mesh.get_group(axis) if hasattr(mesh, "get_group") else mesh
        ax = Axis(dist.get_world_size(group), dist.get_rank(group), group)
    out = render_arrays(
        means3d, scales, quats, opacities, shs, valid, world_view, full_proj,
        campos, tan_fovx, tan_fovy, bg, ts, kids, sh_degree=sh_degree,
        width=width, height=height, cfg=cfg, k_max=k_max,
        use_lod=ts is not None and kids is not None,
        band=(ax.index, ax.size))
    img, trunc = out.image, out.truncated
    if ax.size > 1:
        # one all-gather: each band's image with its truncated flag
        packed = torch.cat([img.reshape(-1),
                            trunc.to(torch.float32).reshape(1)])
        parts = pdist.all_gather(packed, ax.group)
        img = torch.cat([p[:-1].reshape(img.shape) for p in parts], dim=1)
        trunc = torch.stack([p[-1] for p in parts]).max() > 0
    return img[:, :height], trunc


def render_lod_tile_parallel(
    means3d, scales, quats, opacities, shs, nodes, alive,
    world_view, full_proj, campos, tan_fovx, tan_fovy, bg,
    target_size, mesh,
    boxes=None, pcache=None, interp_table=None,
    *,
    sh_degree: int, width: int, height: int,
    n_skybox: int = 0,
    cfg: RasterizerConfig = RasterizerConfig(),
    k_max: int = 1024,
    axis: str = "tile",
    use_frustum: bool = True,
):
    """One hierarchical-LOD frame split over the ranks: the replicated cut
    (render._compute_cut, the selection rule of every LOD entry point) and
    the masked InterpTable lerp on every rank, then the banded blend of
    render_tile_parallel with the in-kernel LOD alpha. The O(pixels) blend
    splits across ranks while the O(nodes) cut stays replicated. Skybox
    rows (depth -1, outside every cut) come back through the mask with
    t = 1. Returns ([3, H, W] image, n_selected, truncated)."""
    from hlod_gaussians_torch.hierarchy import cut as cut_mod

    cut = _compute_cut(None, boxes, nodes, means3d, scales, alive, campos,
                       world_view, target_size, pcache, use_frustum)
    if interp_table is None:
        interp_table = cut_mod.build_interp_table(
            dict(means3d=means3d, scales=scales, quats=quats,
                 opacities=opacities, shs=shs), nodes)
    mask = cut.render_mask
    n_selected = torch.sum(mask)
    ts = cut.ts
    if n_skybox > 0:
        sky = torch.arange(means3d.shape[0], device=means3d.device) < n_skybox
        mask = mask | (sky & alive)
        ts = torch.where(sky, torch.ones_like(ts), ts)
    interp = cut_mod.interpolate_all_masked(interp_table, ts, mask)
    q = interp["quats"]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    img, truncated = render_tile_parallel(
        interp["means3d"], interp["scales"], q, interp["opacities"],
        interp["shs"], mask, world_view, full_proj, campos, tan_fovx,
        tan_fovy, bg, mesh, torch.where(mask, ts, torch.ones_like(ts)),
        torch.clamp_min(cut.kids, 1),
        sh_degree=sh_degree, width=width, height=height, cfg=cfg,
        k_max=k_max, axis=axis)
    return img, n_selected, truncated
