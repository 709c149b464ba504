"""Render facade: project -> SH color -> bin -> blend (port of
hlod_gaussians_tpu/render.py): render_arrays and its `render` wrapper,
render_params (the training steps' render of raw parameters), apply_exposure,
tau_to_threshold, and the hierarchical-LOD entry points
render_lod (budgeted), render_lod_masked (dense cuts) and
render_lod_stream (the viewer loop, which chooses between the two, regulated
with a one-frame lag).

``xy_offset`` is the screen-space hook of the reference's
``screenspace_points`` (gaussian_renderer/__init__.py:45-52): an [N,2]
tensor added to the projected means, whose gradient drives densification.

Both backends are differentiable with respect to means3d, scales, quats,
opacities, shs and xy_offset. The pallas backend blends with the CUDA
kernel B1 and differentiates through kernel B2 (ops/rasterize.py); the xla
backend blends with the plain scan and differentiates through autograd.

Spans (utils/metrics.span): render_arrays opens `hlod.project`, `hlod.bin`
and `hlod.blend` (B1's feature rows and the blend), and so do
render_lod_masked, whose `hlod.project` holds the lod_preprocess pass (the
lerp and the feature rows included), and render_params, whose
`hlod.project` holds the train_preprocess forward; the LOD entry points
`hlod.cut`, `hlod.compact` (the budgeted path) and `hlod.interp` (on the
masked path only the table's lookup); render_lod_stream `hlod.lod_stream`
around its frame, whose feedback it adds to `counters` as it reads it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.hierarchy import cut as cut_mod
from hlod_gaussians_torch.models.gaussians import (NODE_DEPTH, NODE_PARENT,
                                                  activate)
from hlod_gaussians_torch.ops import gaussian_math, sh as sh_ops
from hlod_gaussians_torch.ops.binning import bin_gaussians, tile_grid
from hlod_gaussians_torch.ops.lod_preprocess import lod_preprocess
from hlod_gaussians_torch.ops.train_preprocess import train_preprocess
from hlod_gaussians_torch.ops.rasterize import rasterize_tiles
from hlod_gaussians_torch.ops.rasterize_xla import (blend_features,
                                                    rasterize_scan)
from hlod_gaussians_torch.utils.metrics import counters, span


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
    band: Optional[tuple] = None,
) -> RenderResult:
    """Render activated Gaussian tensors into one view.

    ``want_seen`` makes the kernel path emit exact per-Gaussian applied
    flags (the CUDA `seen` buffer, forward.cu:568); the xla path always
    does. ``band=(index, n)`` renders only band ``index`` of ``n``
    horizontal bands of whole tile rows (tile-parallel rendering): the
    per-pixel outputs are [band_h, W], band_h = (tile rows // n) * tile_h,
    and the band's entries are capped at max_dup // n."""
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)

    with span("hlod.project"):
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
    use_lod = use_lod and ts is not None and kids is not None
    return _bin_and_blend(
        xy, proj.depth, proj.radius, proj.valid, proj.ext, proj.reff2,
        lambda xy: blend_features(xy, proj.conic, proj.opacity, color,
                                  invdepth_g,
                                  *((ts, kids) if use_lod else ())),
        bg, width=width, height=height, cfg=cfg, k_max=k_max,
        use_lod=use_lod, want_seen=want_seen, band=band)


def render_params(
    g,                          # models.gaussians.GaussianState, raw params
    valid: Optional[torch.Tensor],   # [C] bool, or None: g.alive alone
    world_view: torch.Tensor, full_proj: torch.Tensor, campos: torch.Tensor,
    tan_fovx, tan_fovy,
    bg: torch.Tensor,
    xy_offset: Optional[torch.Tensor] = None,
    *,
    sh_degree: int,
    width: int, height: int,
    cfg: RasterizerConfig = RasterizerConfig(),
    k_max: int = 1024,
    antialiasing: bool = False,
) -> RenderResult:
    """The training steps' render of a state's raw parameters, where
    g.alive & valid, differentiable with respect to them and xy_offset.

    On CPU tensors: activate, then render_arrays. On CUDA tensors the
    activations, projection, SH colour and feature rows are the
    train_preprocess kernels in `hlod.project` (one launch forward, one in
    the backward) and the binning and blend are render_arrays'."""
    if g.xyz.device.type == "cpu":
        act = activate(g, valid)
        return render_arrays(
            act.means3d, act.scales, act.quats, act.opacities, act.shs,
            act.valid, world_view, full_proj, campos, tan_fovx, tan_fovy,
            bg, None, None, xy_offset, sh_degree=sh_degree, width=width,
            height=height, cfg=cfg, k_max=k_max, antialiasing=antialiasing)
    with span("hlod.project"):
        rows = train_preprocess(
            g.xyz, g.log_scale, g.quat, g.opacity_logit, g.f_dc, g.f_rest,
            g.alive if valid is None else g.alive & valid, world_view,
            full_proj, campos, tan_fovx, tan_fovy, xy_offset, width=width,
            height=height, sh_degree=sh_degree, dilation=cfg.dilation,
            near=cfg.near, big_limit=cfg.big_limit,
            antialiasing=antialiasing)
    feats = rows.feats
    return _bin_and_blend(
        feats[:, :2], rows.depth, rows.radius, rows.valid, rows.ext,
        rows.reff2, lambda xy: feats, bg, width=width, height=height,
        cfg=cfg, k_max=k_max, use_lod=False)


def _bin_and_blend(xy, depth, radius, visible, ext, reff2, features, bg, *,
                   width, height, cfg, k_max, use_lod, want_seen=False,
                   band=None) -> RenderResult:
    """The tail of every render: bin the rows in `hlod.bin`, then make
    their feature rows (``features(xy)``, blend_features' layout at the
    binned screen positions ``xy``; made after the binning, so a new table
    never sits beside its temporaries) and blend them in `hlod.blend`.
    ``visible`` is the projection's valid; ``band`` is render_arrays'."""
    if cfg.backend not in ("pallas", "xla"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    with span("hlod.bin"):
        # tight alpha-aware coverage on the production path; the scan path
        # keeps the reference's circle rects
        tight = cfg.backend == "pallas" and cfg.tight_binning
        bin_valid, max_dup = visible, cfg.max_dup
        if band is not None:
            xy, bin_valid, height = _band_local(xy, ext, radius, visible,
                                                band, width, height, cfg)
            max_dup = cfg.max_dup // band[1]
        bins = bin_gaussians(
            xy.detach(), depth.detach(), radius, bin_valid, width, height,
            cfg.tile_w, cfg.tile_h, max_dup,
            ext=ext.detach() if tight else None,
            reff2=reff2.detach() if tight else None)

    with span("hlod.blend"):
        feats = features(xy)
        kw = dict(width=width, height=height, tile_w=cfg.tile_w,
                  tile_h=cfg.tile_h, use_lod=use_lod, t_eps=cfg.t_eps,
                  alpha_min=cfg.alpha_min)
        if cfg.backend == "pallas":
            out = rasterize_tiles(bins, feats, bg, want_seen=want_seen,
                                  inference=cfg.inference, **kw)
        else:
            out = rasterize_scan(bins, feats, bg, k_max=k_max, **kw)
    return RenderResult(
        image=out.image, invdepth=out.invdepth, final_t=out.final_t,
        n_contrib=out.n_contrib, seen=out.seen, radii=radius,
        visible=visible, truncated=out.truncated,
        n_dup=bins.num_candidates)


def _band_local(xy, ext, radius, valid, band, width, height, cfg):
    """Band ``index`` of ``n`` of the projected rows: the band-local screen
    positions (the band starts at y = 0), the rows that can touch the band
    and its height. The band test uses the tight y half-extent where the
    binning does (it holds every pixel the blend can touch), else the
    3-sigma radius; ext and reff2 are relative, so the shift leaves them
    valid."""
    index, n = band
    _, gh = tile_grid(width, height, cfg.tile_w, cfg.tile_h)
    if gh % n:
        raise ValueError(f"tile rows {gh} must divide over {n} bands")
    band_h = (gh // n) * cfg.tile_h
    xy = xy - torch.tensor([0.0, float(band_h * index)], device=xy.device)
    tight = cfg.backend == "pallas" and cfg.tight_binning
    r_y = ext[:, 1] if tight else radius.to(torch.float32)
    in_band = ((xy[:, 1] + r_y) >= 0) & ((xy[:, 1] - r_y) < band_h)
    return xy, valid & in_band, band_h


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


def render(gaussian_arrays, camera, bg, *, sh_degree: int,
           cfg: RasterizerConfig = RasterizerConfig(), k_max: int = 1024,
           antialiasing: bool = False) -> RenderResult:
    """render_arrays for a Camera and a dict of activated tensors."""
    g = gaussian_arrays
    return render_arrays(
        g["means3d"], g["scales"], g["quats"], g["opacities"], g["shs"],
        g["valid"], camera.world_view, camera.full_proj, camera.campos,
        camera.tan_fovx, camera.tan_fovy,
        torch.as_tensor(bg, dtype=torch.float32, device=g["means3d"].device),
        sh_degree=sh_degree, width=camera.width, height=camera.height,
        cfg=cfg, k_max=k_max, antialiasing=antialiasing)


def _compute_cut(precomputed_cut, boxes, nodes, means3d, scales, alive,
                 campos, world_view, target_size, pcache, use_frustum):
    """The cut of every LOD entry point (they must select by the same rule
    or their paths diverge): the caller's, the box metric with ``boxes``,
    else the dynamic metric. The camera forward axis in world space is the
    third column of the world->view linear block (row-vector convention)."""
    if precomputed_cut is not None:
        return precomputed_cut
    with span("hlod.cut"):
        if boxes is not None:
            box_lo, box_hi, max_side = boxes
            return cut_mod.expand_to_size_box(
                nodes, box_lo, box_hi, max_side, alive, campos, target_size,
                pcache)
        return cut_mod.expand_to_size_dynamic(
            nodes, means3d, torch.max(scales, dim=1).values, alive, campos,
            world_view[:3, 2], target_size, pcache, use_frustum=use_frustum)


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


def compact_cut(mask, size, budget: int):
    """The cut compacted into ``budget`` rows: lexicographic (~mask, -size,
    index) as two stable sorts, the secondary key first, so an overflow
    drops the smallest-on-screen nodes. Returns (row index [budget], clamped
    into the table; valid [budget] bool, the first n_selected rows)."""
    c = mask.shape[0]
    neg_size = -torch.where(torch.isfinite(size), size,
                            torch.full_like(size, 3.4e38))
    idx = torch.sort(neg_size, stable=True).indices
    idx = idx[torch.sort((~mask[idx]).to(torch.int32), stable=True).indices]
    idx = idx[:min(budget, c)]
    if c < budget:
        idx = torch.cat([idx, torch.full((budget - c,), c - 1,
                                         dtype=idx.dtype, device=idx.device)])
    valid = torch.arange(budget, device=mask.device) < torch.sum(mask)
    return idx, valid


def render_lod(
    means3d, scales, quats, opacities, shs,   # activated tensors [C,...]
    nodes, alive,
    world_view, full_proj, campos, tan_fovx, tan_fovy, bg,
    target_size,
    boxes=None,              # optional (box_lo [C,3], box_hi [C,3],
                             # max_side [C]): the upstream box metric
    cut_mask=None,           # optional [C] bool: an externally maintained
                             # cut (viewer maintenance) in place of the size
                             # rule's selection; ts/kids still come from the
                             # size metric
    pcache=None,             # optional cut_mod.ParentCache built once per
                             # tree: the per-frame cut without a gather
    precomputed_cut=None,    # optional cut_mod.CutResult for THIS view
    interp_table=None,       # optional cut_mod.InterpTable built once per
                             # (tree, params): interpolation as one gather
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
    + runtime_switching.cu:533-684 + render_post). With ``boxes`` the cut
    uses the upstream projected-box metric (the tau-sweep protocol,
    render_hierarchy.py:56-80), else the fork's dynamic metric. The cut is
    compacted into `budget` rows; past the budget the smallest-on-screen
    nodes are dropped (visible through n_selected). Returns
    (RenderResult, n_selected)."""
    cfg = dataclasses.replace(cfg, inference=True)
    c = means3d.shape[0]
    cut = _compute_cut(precomputed_cut, boxes, nodes, means3d, scales, alive,
                       campos, world_view, target_size, pcache, use_frustum)

    with span("hlod.compact"):
        mask = cut.render_mask if cut_mask is None else \
            (cut_mask & alive & (nodes[:, NODE_DEPTH] >= 0))
        n_selected = torch.sum(mask)
        idx_c, sel_valid = compact_cut(mask, cut.size, budget)
        ts_sel = cut.ts[idx_c]
        kids_sel = cut.kids[idx_c]

    # interpolate the cut, prepend the skybox, normalize the quaternions
    with span("hlod.interp"):
        if interp_table is not None:
            interp = cut_mod.interpolate_from_table(interp_table, idx_c,
                                                    ts_sel)
        else:
            parent = torch.clamp(nodes[idx_c, NODE_PARENT], 0, c - 1).long()
            params = dict(means3d=means3d, scales=scales, quats=quats,
                          opacities=opacities, shs=shs)
            interp = cut_mod.interpolate_with_parents(params, idx_c, parent,
                                                      ts_sel)
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


def render_lod_masked(
    means3d, scales, quats, opacities, shs,
    nodes, alive,
    world_view, full_proj, campos, tan_fovx, tan_fovy, bg,
    target_size,
    boxes=None,
    pcache=None,
    precomputed_cut=None,
    interp_table=None,       # built from the parameters when None
    *,
    sh_degree: int, width: int, height: int,
    n_skybox: int = 0,
    cfg: RasterizerConfig = RasterizerConfig(),
    k_max: int = 1024,
    antialiasing: bool = False,
    use_frustum: bool = True,
    band: Optional[tuple] = None,
):
    """Budget-free LOD render for dense cuts: every node is interpolated by
    one lerp over the InterpTable and the cut mask becomes the renderer's
    valid mask, with no compaction sort and no per-frame feature gather.
    The lerp, the skybox prepend, the projection, SH and B1's feature rows
    are one `lod_preprocess` pass (on the card one kernel launch, which
    reads only the drawn rows of the table); binning and the blend are
    render_arrays', and so is ``band=(index, n)``, one band of a
    tile-parallel frame. Returns (RenderResult, n_selected)."""
    cfg = dataclasses.replace(cfg, inference=True)
    cut = _compute_cut(precomputed_cut, boxes, nodes, means3d, scales, alive,
                       campos, world_view, target_size, pcache, use_frustum)
    mask = cut.render_mask

    with span("hlod.interp"):
        table = interp_table
        if table is None:
            table = cut_mod.build_interp_table(
                dict(means3d=means3d, scales=scales, quats=quats,
                     opacities=opacities, shs=shs), nodes)
    with span("hlod.project"):
        rows = lod_preprocess(
            table, mask, cut.ts, cut.kids, alive, world_view, full_proj,
            campos, tan_fovx, tan_fovy, width=width, height=height,
            sh_degree=sh_degree, n_skybox=n_skybox, dilation=cfg.dilation,
            near=cfg.near, big_limit=cfg.big_limit,
            antialiasing=antialiasing)
    feats = rows.feats
    out = _bin_and_blend(
        feats[:, :2], rows.depth, rows.radius, rows.valid, rows.ext,
        rows.reff2,
        # a band moves the rows' screen positions to its own origin
        lambda xy: feats if band is None else torch.cat([xy, feats[:, 2:]],
                                                        dim=1),
        bg, width=width, height=height, cfg=cfg, k_max=k_max, use_lod=True,
        band=band)
    return out, torch.sum(mask)


def _budget_bucket(want: int, min_budget: int, max_budget: int,
                   cap: int) -> int:
    """Smallest bucket >= want on the ladder {1, 1.5} x 2^k from
    min_budget, clipped to [min_budget, min(max_budget, cap)]. Every
    budget-sized stage pays the bucket, so the half steps cap the overshoot
    at 1.5x."""
    b = min_budget
    while b < want and b < max_budget:
        b_half = b + (b >> 1)
        if want <= b_half:
            b = b_half
            break
        b <<= 1
    return min(max(b, min_budget), max_budget, cap)


def _feedback(out, n_sel):
    """The regulation scalars of a frame packed as one [3] int32 tensor:
    (n_selected, truncated, n_dup)."""
    return torch.stack([n_sel.to(torch.int32),
                        out.truncated.to(torch.int32),
                        out.n_dup.to(torch.int32)])


def _to_host_async(fb):
    """Start fb's copy to the host: (host tensor, event), on the card into a
    pinned tensor with an event recorded after the copy, else (fb, None)."""
    if not fb.is_cuda:
        return fb, None
    host = torch.empty(fb.shape, dtype=fb.dtype, pin_memory=True)
    host.copy_(fb, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def render_lod_stream(
    means3d, scales, quats, opacities, shs, nodes, alive,
    world_view, full_proj, campos, tan_fovx, tan_fovy, bg,
    target_size, state, boxes=None, pcache=None,
    interp_table=None,
    *,
    sh_degree: int, width: int, height: int,
    min_budget: int = 4096,
    max_budget: int = 1 << 20,
    n_skybox: int = 0,
    cfg: RasterizerConfig = RasterizerConfig(),
    k_max: int = 1024,
    antialiasing: bool = False,
    use_frustum: bool = True,
    headroom: float = 1.125,
    shrink_patience: int = 3,
    md_floor: int = 1 << 17,
    masked_crossover: float = 4.0,
):
    """Viewer streaming render: budget and capacity regulated with a
    one-frame lag, so no device->host wait sits between two frames'
    dispatches (the SIBR viewer adapts to the previous frame's overrun too,
    runtime_maintenance.cu:39-387).

    Frame k is dispatched with the budget bucket chosen from frame k-1's
    cut size. Its packed (n_selected, truncated, n_dup) goes to a pinned
    host tensor by a non-blocking copy, with an event recorded after it,
    and is read after frame k+1 has been dispatched. By design, for one
    frame each before the state adapts: a cut grown past the budget drops
    its smallest-on-screen nodes, and entries past the binning capacity
    truncate the frame.

    ``state`` is a dict the caller owns; pass ``{}`` on the first frame,
    which counts its cut once (a sync) to seed the bucket. It holds
    "budget", "md" (the capacity high-water per bucket, "MASKED" for the
    masked path), "shrink" (frames the cut has wanted a smaller bucket),
    "n_truncated_frames" and the pending feedback. As it reads a frame's
    feedback it adds to `counters` the nodes drawn (n_selected, at most the
    budget) and the rows interpolated: the budget on the budgeted path; on
    the masked path n_selected where the tree is on a CUDA device, whose
    lod_preprocess kernel lerps the drawn rows alone, else the tree's.
    Returns (RenderResult, n_selected device scalar)."""
    with span("hlod.lod_stream"):
        cap = means3d.shape[0]

        def bucket_for(n_sel: int) -> int:
            return _budget_bucket(int(n_sel * headroom) + 1, min_budget,
                                  max_budget, cap)

        if "budget" not in state:
            cut0 = _compute_cut(None, boxes, nodes, means3d, scales, alive,
                                campos, world_view, target_size, pcache,
                                use_frustum)
            state["budget"] = bucket_for(int(torch.sum(cut0.render_mask)))
            state["md"] = {}
            state["shrink"] = 0

        budget = state["budget"]
        args = (means3d, scales, quats, opacities, shs, nodes, alive,
                world_view, full_proj, campos, tan_fovx, tan_fovy, bg,
                target_size, boxes)
        kw = dict(pcache=pcache, interp_table=interp_table,
                  sh_degree=sh_degree, width=width, height=height,
                  n_skybox=n_skybox, k_max=k_max, antialiasing=antialiasing,
                  use_frustum=use_frustum)
        # dense cuts skip the compaction and the feature gather: render masked
        # over the whole tree
        if (interp_table is not None
                and budget * masked_crossover > cap * headroom):
            budget = "MASKED"
            # an undershooting first capacity: the n_dup feedback grows it in
            # <= 2 frames, while an overshoot would stay (md only grows)
            md = state["md"].get(budget, max(md_floor, cap // 2))
            out, n_sel = render_lod_masked(
                *args, cfg=dataclasses.replace(
                    cfg, max_dup=min(md, cfg.max_dup)), **kw)
        else:
            md = state["md"].get(budget, max(md_floor, 2 * budget))
            out, n_sel = render_lod(
                *args, cfg=dataclasses.replace(
                    cfg, max_dup=min(md, cfg.max_dup)), budget=budget, **kw)
        feedback = _to_host_async(_feedback(out, n_sel))

        # the previous frame's feedback: its work ran while this frame was
        # being dispatched
        prev = state.pop("pending", None)
        if prev is not None:
            (p_host, p_event), p_budget, p_md = prev
            if p_event is not None:
                p_event.synchronize()
            p_n, p_trunc, p_dup = p_host.tolist()
            # on the card (an event) the masked path's kernel lerps the
            # drawn rows alone; its plain version lerps every row
            rows = (p_budget if p_budget != "MASKED" else
                    p_n if p_event is not None else cap)
            counters["lod.nodes_drawn"] += min(p_n, rows)
            counters["lod.rows_interpolated"] += rows
            # the capacity hugs the observed entry demand (n_dup: exact when
            # not truncated, the capacity itself when truncated, so the margin
            # still grows it); a high-water per bucket, never lowered
            want_md = _budget_bucket(int(p_dup * 1.0625) + 1, md_floor,
                                     cfg.max_dup, cfg.max_dup)
            if p_trunc:
                want_md = max(want_md, min(p_md * 2, cfg.max_dup))
                state["n_truncated_frames"] = \
                    state.get("n_truncated_frames", 0) + 1
            if want_md > state["md"].get(p_budget, 0):
                state["md"][p_budget] = want_md
            want = bucket_for(p_n)
            if want > state["budget"]:
                state["budget"] = want
                state["shrink"] = 0
            elif want < state["budget"]:
                state["shrink"] += 1
                if state["shrink"] >= shrink_patience:
                    state["budget"] = want
                    state["shrink"] = 0
            else:
                state["shrink"] = 0
        state["pending"] = (feedback, budget, md)
        return out, n_sel
