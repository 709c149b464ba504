"""Evaluation harness: granularity sweeps with PSNR / SSIM / GMSD (and
LPIPS when the caller has it), port of hlod_gaussians_tpu/eval.py.

The reference's two protocols:
* a tau sweep over a box-metric hierarchy (render_hierarchy.py:32-141):
  threshold = 2*(tau+0.5)*tanfovx/(0.5*W), tau in {0, 3, 6, 15} px;
* a granularity-limit sweep over the dynamic hierarchy
  (eval_hierarchy_dynamic.py:30-73): limit in {0, 0.01, 0.1}.

Both drive render_lod over the test views and report the means per level.
LPIPS is an optional ``lpips_fn``: nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from hlod_gaussians_torch import render as render_mod
from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.hierarchy import cut as cut_mod
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.models.gaussians import GaussianState
from hlod_gaussians_torch.ops import perceptual
from hlod_gaussians_torch.ops import ssim as ssim_ops

DEFAULT_TAUS = (0.0, 3.0, 6.0, 15.0)         # render_hierarchy.py:129
DEFAULT_LIMITS = (0.0, 0.01, 0.1)            # eval_hierarchy_dynamic.py:50


@dataclasses.dataclass
class EvalResult:
    level: float
    psnr: float
    ssim: float
    lpips: Optional[float]       # None without an lpips_fn
    gmsd: float                  # weights-free perceptual (lower = better)
    mean_rendered: float


def eval_views(
    state: GaussianState,
    cameras: Sequence,
    gt_images: Sequence,                 # [3,H,W] each, numpy or tensors
    levels: Sequence[float] = DEFAULT_LIMITS,
    *,
    level_is_tau: bool = False,
    boxes=None,                          # (box_lo, box_hi, max_side) for the
                                         # upstream box metric (tau protocol)
    budget: int = 1 << 18,
    cfg: RasterizerConfig = RasterizerConfig(),
    k_max: int = 1024,
    bg=(0.0, 0.0, 0.0),
    antialiasing: bool = False,
    lpips_fn=None,
    warn=None,
) -> List[EvalResult]:
    """Sweep granularity levels over the test views, on the state's device.

    With ``level_is_tau`` the levels are pixel granularities converted per
    view (render_hierarchy.py:56); with ``boxes`` (e.g. from
    hierarchy.boxes.compute_node_boxes or a loaded .hier) the cut uses the
    reference's projected-box metric instead of the dynamic one. The parent
    cache and the interp table are built once for the sweep.
    """
    _warn = warn if warn is not None else (
        lambda msg: warnings.warn(msg, stacklevel=3))
    if lpips_fn is None:
        _warn("LPIPS unavailable (no lpips_fn) — reporting PSNR/SSIM/GMSD "
              "only")
    if len(cameras) != len(gt_images):
        raise ValueError(f"{len(cameras)} cameras vs {len(gt_images)} gt "
                         "images")
    dev = state.xyz.device

    def tensor(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.float32)
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    act = gm.activate(state)
    if boxes is not None:
        boxes = tuple(tensor(b) for b in boxes)
        pcache = cut_mod.build_parent_cache_box(state.nodes, *boxes)
    else:
        pcache = cut_mod.build_parent_cache(
            state.nodes, act.means3d, torch.max(act.scales, dim=1).values)
    itab = cut_mod.build_interp_table(
        dict(means3d=act.means3d, scales=act.scales, quats=act.quats,
             opacities=act.opacities, shs=act.shs), state.nodes)
    bg_t = tensor(bg)
    gts = [tensor(g) for g in gt_images]
    out: List[EvalResult] = []
    for level in levels:
        psnr_sum = ssim_sum = lpips_sum = gmsd_sum = n_sum = 0.0
        n_truncated = n_capped = 0
        for cam, gt in zip(cameras, gts):
            if level_is_tau:
                target = float(render_mod.tau_to_threshold(
                    level, float(cam.tan_fovx), cam.width))
            else:
                target = level
            with torch.no_grad():
                res, n_sel = render_mod.render_lod(
                    act.means3d, act.scales, act.quats, act.opacities,
                    act.shs, state.nodes, state.alive,
                    cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
                    cam.tan_fovy, bg_t, max(target, 1e-12), boxes, None,
                    pcache, None, itab,
                    sh_degree=state.sh_degree, width=cam.width,
                    height=cam.height, budget=budget,
                    n_skybox=state.n_skybox, cfg=cfg, k_max=k_max,
                    antialiasing=antialiasing)
                img = torch.clamp(res.image, 0.0, 1.0)
                psnr_sum += float(ssim_ops.psnr(img, gt))
                ssim_sum += float(ssim_ops.ssim(img, gt))
                gmsd_sum += float(perceptual.gmsd(img, gt))
                if lpips_fn is not None:
                    lpips_sum += float(lpips_fn(img, gt))
            n_truncated += int(bool(res.truncated))
            n_capped += int(int(n_sel) > budget)
            # the render drops past-budget nodes: report what rendered
            n_sum += min(float(n_sel), float(budget))
        if n_truncated or n_capped:
            _warn(f"level {level}: {n_truncated} view(s) truncated "
                  f"(cfg.max_dup) and {n_capped} over the node budget "
                  f"({budget}) — metrics are degraded; raise max_dup/"
                  "budget for exact numbers")
        m = max(len(cameras), 1)
        out.append(EvalResult(
            level=level, psnr=psnr_sum / m, ssim=ssim_sum / m,
            lpips=(lpips_sum / m) if lpips_fn is not None else None,
            gmsd=gmsd_sum / m, mean_rendered=n_sum / m))
    return out
