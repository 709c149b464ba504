"""Tile-parallel rendering: one frame split across ranks by image bands
(port of hlod_gaussians_tpu/parallel/tile_parallel.py:29-190).

The image-space analogue of sequence parallelism: per-tile blends are
independent, so the tile grid splits across the ranks of the `tile` axis.
Every rank projects the (replicated) Gaussians, bins them against ITS
horizontal band of whole tile rows and blends only its own tiles (the
``band=`` of render_arrays and render_lod_masked: kernel B1 on a band of
height band_h with max_dup / n entries, its plain version on the CPU); the
bands are then all-gathered and reassembled. Rank r runs the body of the
JAX package's `shard_map` for band r.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.parallel import distributed as pdist
from hlod_gaussians_torch.parallel.data_parallel import Axis
from hlod_gaussians_torch.render import render_arrays, render_lod_masked


def _tile_axis(mesh, axis: str) -> Axis:
    """This rank's place on ``axis`` of ``mesh`` (a DeviceMesh, a process
    group, or None for one rank)."""
    if mesh is None:
        return Axis(1, 0, None)
    group = mesh.get_group(axis) if hasattr(mesh, "get_group") else mesh
    return Axis(dist.get_world_size(group), dist.get_rank(group), group)


def _gather_bands(out, ax: Axis, height: int):
    """The ranks' bands of a banded RenderResult reassembled by one
    all-gather of each band's image with its truncated flag. Returns the
    [3, H, W] image and whether any band overflowed."""
    img, trunc = out.image, out.truncated
    if ax.size > 1:
        packed = torch.cat([img.reshape(-1),
                            trunc.to(torch.float32).reshape(1)])
        parts = pdist.all_gather(packed, ax.group)
        img = torch.cat([p[:-1].reshape(img.shape) for p in parts], dim=1)
        trunc = torch.stack([p[-1] for p in parts]).max() > 0
    return img[:, :height], trunc


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
    ax = _tile_axis(mesh, axis)
    out = render_arrays(
        means3d, scales, quats, opacities, shs, valid, world_view, full_proj,
        campos, tan_fovx, tan_fovy, bg, ts, kids, sh_degree=sh_degree,
        width=width, height=height, cfg=cfg, k_max=k_max,
        use_lod=ts is not None and kids is not None,
        band=(ax.index, ax.size))
    return _gather_bands(out, ax, height)


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
    """One hierarchical-LOD frame split over the ranks: render_lod_masked's
    band of this rank (the replicated cut and lod_preprocess pass, then the
    banded blend with the in-kernel LOD alpha), all-gathered. The O(pixels)
    blend splits across ranks while the O(nodes) cut stays replicated.
    Returns ([3, H, W] image, n_selected, truncated)."""
    ax = _tile_axis(mesh, axis)
    out, n_selected = render_lod_masked(
        means3d, scales, quats, opacities, shs, nodes, alive, world_view,
        full_proj, campos, tan_fovx, tan_fovy, bg, target_size, boxes,
        pcache, None, interp_table, sh_degree=sh_degree, width=width,
        height=height, n_skybox=n_skybox, cfg=cfg, k_max=k_max,
        use_frustum=use_frustum, band=(ax.index, ax.size))
    img, truncated = _gather_bands(out, ax, height)
    return img, n_selected, truncated
