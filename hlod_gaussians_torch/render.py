"""Render facade: project -> SH color -> bin -> blend (port of
hlod_gaussians_tpu/render.py: render_arrays, apply_exposure,
tau_to_threshold, and render_lod with its dynamic cut).

``xy_offset`` is the screen-space hook of the reference's
``screenspace_points`` (gaussian_renderer/__init__.py:45-52): an [N,2]
tensor added to the projected means, whose gradient drives densification.

Both backends are differentiable with respect to means3d, scales, quats,
opacities, shs and xy_offset. The pallas backend blends with the CUDA
kernel B1 and differentiates through kernel B2 (ops/rasterize.py); the xla
backend blends with the plain scan and differentiates through autograd.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.hierarchy import cut as cut_mod
from hlod_gaussians_torch.models.gaussians import NODE_DEPTH, NODE_PARENT
from hlod_gaussians_torch.ops import gaussian_math, sh as sh_ops
from hlod_gaussians_torch.ops.binning import bin_gaussians
from hlod_gaussians_torch.ops.rasterize import rasterize_tiles
from hlod_gaussians_torch.ops.rasterize_xla import rasterize_scan


class RenderResult(NamedTuple):
    image: torch.Tensor      # [3, H, W] color (bg composited, pre-exposure)
    invdepth: torch.Tensor   # [H, W] expected inverse depth
    final_t: torch.Tensor    # [H, W] final transmittance
    n_contrib: torch.Tensor  # [H, W] int32
    seen: torch.Tensor       # [N] bool — Gaussian contributed to some pixel
    radii: torch.Tensor      # [N] int32 — screen-space radius (0 = culled)
    visible: torch.Tensor    # [N] bool — survived culling (radii > 0)
    truncated: torch.Tensor  # 0-d bool — entries were dropped
    n_dup: torch.Tensor      # 0-d int32 — entries this frame needed (capped
                             # at max_dup)


def render_arrays(
    means3d: torch.Tensor,      # [N,3]
    scales: torch.Tensor,       # [N,3] linear (activated)
    quats: torch.Tensor,        # [N,4] normalized
    opacities: torch.Tensor,    # [N] in [0,1] (activated)
    shs: torch.Tensor,          # [N,K,3]
    valid: torch.Tensor,        # [N] bool alive mask
    world_view: torch.Tensor,   # [4,4]
    full_proj: torch.Tensor,    # [4,4]
    campos: torch.Tensor,       # [3]
    tan_fovx, tan_fovy,
    bg: torch.Tensor,           # [3]
    ts: Optional[torch.Tensor] = None,
    kids: Optional[torch.Tensor] = None,
    xy_offset: Optional[torch.Tensor] = None,
    *,
    sh_degree: int,
    width: int, height: int,
    cfg: RasterizerConfig = RasterizerConfig(),
    k_max: int = 1024,
    antialiasing: bool = False,
    use_lod: bool = False,
    want_seen: bool = False,
) -> RenderResult:
    """Render activated Gaussian tensors into one view.

    ``want_seen`` makes the kernel path emit exact per-Gaussian applied
    flags (the CUDA `seen` buffer, forward.cu:568); the xla path always
    does."""
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)

    cov6 = gaussian_math.compute_cov3d(scales, quats)
    max_scale = torch.max(scales, dim=-1).values
    proj = gaussian_math.project_gaussians(
        means3d, cov6, opacities, world_view, full_proj,
        width, height, focal_x, focal_y, tan_fovx, tan_fovy,
        dilation=cfg.dilation, antialiasing=antialiasing, near=cfg.near,
        valid_in=valid, big_limit=cfg.big_limit, max_scale=max_scale)

    xy = proj.xy if xy_offset is None else proj.xy + xy_offset
    color = sh_ops.sh_color(sh_degree, shs, means3d, campos)
    invdepth_g = 1.0 / torch.clamp_min(proj.depth, 1e-6)
    ts_r, kids_r = (ts, kids) if use_lod else (None, None)

    if cfg.backend == "pallas":
        # tight alpha-aware coverage on the production path
        tight = cfg.tight_binning
        bins = bin_gaussians(
            xy.detach(), proj.depth.detach(), proj.radius, proj.valid,
            width, height, cfg.tile_w, cfg.tile_h, cfg.max_dup,
            ext=proj.ext.detach() if tight else None,
            reff2=proj.reff2.detach() if tight else None)
        out = rasterize_tiles(
            bins, xy, proj.conic, proj.opacity, color, invdepth_g, bg,
            ts_r, kids_r, width=width, height=height, tile_w=cfg.tile_w,
            tile_h=cfg.tile_h, t_eps=cfg.t_eps, alpha_min=cfg.alpha_min,
            want_seen=want_seen, inference=cfg.inference)
    elif cfg.backend == "xla":
        # the scan path keeps the reference's circle rects
        bins = bin_gaussians(
            xy.detach(), proj.depth.detach(), proj.radius, proj.valid,
            width, height, cfg.tile_w, cfg.tile_h, cfg.max_dup)
        out = rasterize_scan(
            bins, xy, proj.conic, proj.opacity, color, invdepth_g, bg,
            ts_r, kids_r, width=width, height=height, tile_w=cfg.tile_w,
            tile_h=cfg.tile_h, k_max=k_max, t_eps=cfg.t_eps,
            alpha_min=cfg.alpha_min)
    else:
        raise ValueError(f"unknown backend {cfg.backend!r}")
    return RenderResult(
        image=out.image, invdepth=out.invdepth, final_t=out.final_t,
        n_contrib=out.n_contrib, seen=out.seen, radii=proj.radius,
        visible=proj.valid, truncated=out.truncated,
        n_dup=bins.num_candidates)


def apply_exposure(image: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    """Per-image 3x4 affine color transform (gaussian_renderer/__init__.py
    :150-153): out = A @ rgb + b per pixel."""
    c, h, w = image.shape
    out = exposure[:3, :3] @ image.reshape(3, -1) + exposure[:3, 3:4]
    return out.reshape(c, h, w)


def tau_to_threshold(tau, tan_fovx, width: int):
    """Pixel granularity tau -> world-size-per-distance threshold
    (render_hierarchy.py:56)."""
    return (2.0 * (tau + 0.5)) * tan_fovx / (0.5 * width)


def _compute_cut(precomputed_cut, nodes, means3d, scales, alive, campos,
                 world_view, target_size, use_frustum):
    """The cut of a LOD render: the caller's, or the dynamic size rule.
    The camera forward axis in world space is the third column of the
    world->view linear block (row-vector convention)."""
    if precomputed_cut is not None:
        return precomputed_cut
    return cut_mod.expand_to_size_dynamic(
        nodes, means3d, torch.max(scales, dim=1).values, alive, campos,
        world_view[:3, 2], target_size, use_frustum=use_frustum)


def _prepend_skybox(n_skybox, alive, means3d, scales, quats, opacities, shs,
                    interp, valid_tail, ts_tail, kids_tail):
    """Skybox rows render uninterpolated ahead of the cut (render_post
    prepends them, gaussian_renderer/__init__.py:341-358)."""
    if n_skybox <= 0:
        return (interp["means3d"], interp["scales"], interp["quats"],
                interp["opacities"], interp["shs"], valid_tail, ts_tail,
                kids_tail)
    dev = means3d.device
    return (torch.cat([means3d[:n_skybox], interp["means3d"]]),
            torch.cat([scales[:n_skybox], interp["scales"]]),
            torch.cat([quats[:n_skybox], interp["quats"]]),
            torch.cat([opacities[:n_skybox], interp["opacities"]]),
            torch.cat([shs[:n_skybox], interp["shs"]]),
            torch.cat([alive[:n_skybox], valid_tail]),
            torch.cat([torch.ones((n_skybox,), device=dev), ts_tail]),
            torch.cat([torch.ones((n_skybox,), dtype=torch.int32, device=dev),
                       kids_tail]))


def render_lod(
    means3d, scales, quats, opacities, shs,   # activated tensors [C,...]
    nodes, alive,
    world_view, full_proj, campos, tan_fovx, tan_fovy, bg,
    target_size,
    cut_mask=None,           # optional [C] bool: externally maintained cut
                             # (viewer incremental maintenance) — replaces the
                             # size-rule selection; ts/kids still come from
                             # the size metric
    precomputed_cut=None,    # optional cut_mod.CutResult for THIS view
    *,
    sh_degree: int, width: int, height: int,
    budget: int,             # capacity of the compacted cut
    n_skybox: int = 0,
    cfg: RasterizerConfig = RasterizerConfig(),
    k_max: int = 1024,
    antialiasing: bool = False,
    use_frustum: bool = True,
):
    """Hierarchical LOD render: granularity cut -> parent interpolation ->
    blend with the in-kernel LOD alpha correction (render_hierarchy.py:32-120
    + runtime_switching.cu:533-684 + render_post). The cut is compacted into
    `budget` rows; past the budget the smallest-on-screen nodes are dropped
    (visible through n_selected). Returns (RenderResult, n_selected)."""
    cfg = dataclasses.replace(cfg, inference=True)
    c = means3d.shape[0]
    dev = means3d.device
    cut = _compute_cut(precomputed_cut, nodes, means3d, scales, alive,
                       campos, world_view, target_size, use_frustum)

    mask = cut.render_mask if cut_mask is None else \
        (cut_mask & alive & (nodes[:, NODE_DEPTH] >= 0))
    n_selected = torch.sum(mask)
    # compaction: lexicographic (~mask, -size, index) as two stable sorts,
    # the secondary key first, so an overflow drops the smallest nodes
    neg_size = -torch.where(torch.isfinite(cut.size), cut.size,
                            torch.full_like(cut.size, 3.4e38))
    idx = torch.sort(neg_size, stable=True).indices
    idx = idx[torch.sort((~mask[idx]).to(torch.int32), stable=True).indices]
    take = min(budget, c)
    idx = idx[:take]
    if take < budget:
        idx = torch.cat([idx, torch.full((budget - take,), c,
                                         dtype=idx.dtype, device=dev)])
    sel_valid = torch.arange(budget, device=dev) < n_selected
    idx_c = torch.clamp(idx, 0, c - 1)

    ts_sel = cut.ts[idx_c]
    kids_sel = cut.kids[idx_c]
    parent = torch.clamp(nodes[idx_c, NODE_PARENT], 0, c - 1).long()
    params = dict(means3d=means3d, scales=scales, quats=quats,
                  opacities=opacities, shs=shs)
    interp = cut_mod.interpolate_with_parents(params, idx_c, parent, ts_sel)

    (means_r, scales_r, quats_r, opac_r, shs_r, valid_r, ts_r,
     kids_r) = _prepend_skybox(n_skybox, alive, means3d, scales, quats,
                               opacities, shs, interp, sel_valid, ts_sel,
                               kids_sel)
    quats_r = quats_r / torch.linalg.norm(quats_r, dim=-1,
                                          keepdim=True).clamp_min(1e-12)

    out = render_arrays(
        means_r, scales_r, quats_r, opac_r, shs_r, valid_r,
        world_view, full_proj, campos, tan_fovx, tan_fovy, bg,
        ts_r, kids_r, None,
        sh_degree=sh_degree, width=width, height=height, cfg=cfg,
        k_max=k_max, antialiasing=antialiasing, use_lod=True)
    return out, n_selected
