"""Faults of the post-optimization cells, planted under the timed path as
benchmark/harness/faults.py plants the others; each must turn `correct`
false. `register()` adds them to faults.FAULTS under these names:

* post_state_unchanged: post_iteration returns the state it was given;
* post_half_batch: the post loss is taken over the top half of the image
  rows only, the mean over those (the working-set opacity term kept);
* post_coarse_cut: the SPT cut selects at the next coarser granularity
  of a binary tree: the target granularity doubled, that is every camera
  distance twice as long.
"""

from __future__ import annotations


def _state_unchanged(orig):
    def post_iteration(ts, forest, *a, **kw):
        _, forest, fb = orig(ts, forest, *a, **kw)
        return ts, forest, fb
    return post_iteration


def _half_batch(orig):
    import torch
    from hlod_gaussians_torch import render as render_mod
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.ops import ssim as ssim_ops

    def post_loss(g, params, cut_mask, world_view, full_proj, campos,
                  tan_fovx, tan_fovy, gt_image, bg, *, opt, post, cfg, width,
                  height, k_max, sh_degree, antialiasing):
        act = gm.activate(g.replace_params(params), cut_mask | g.skybox_mask)
        out = render_mod.render_arrays(
            act.means3d, act.scales, act.quats, act.opacities, act.shs,
            act.valid, world_view, full_proj, campos, tan_fovx, tan_fovy, bg,
            sh_degree=sh_degree, width=width, height=height, cfg=cfg,
            k_max=k_max, antialiasing=antialiasing)
        rows = height // 2
        img, gt = out.image[:, :rows], gt_image[:, :rows]
        l1 = torch.abs(img - gt).mean()
        s = ssim_ops.ssim(img, gt)
        loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1.0 - s)
        ws = cut_mask & g.alive
        op = torch.sigmoid(params["opacity_logit"][:, 0])
        loss = loss + post.lambda_opacity * torch.sum(
            torch.where(ws, op, 0.0)) / torch.clamp_min(torch.sum(ws), 1)
        return loss, (out, out.image, l1, s)
    return post_loss


def _coarse_cut(orig):
    def spt_cut_budgeted(forest, capacity, campos, full_proj, budget,
                         base_multiplier=1.0, *a, **kw):
        return orig(forest, capacity, campos, full_proj, budget,
                    2.0 * base_multiplier, *a, **kw)
    return spt_cut_budgeted


FAULTS = {
    "post_state_unchanged": ("hlod_gaussians_torch.pipeline.full_train",
                             "post_iteration", _state_unchanged),
    "post_half_batch": ("hlod_gaussians_torch.train.post", "post_loss",
                        _half_batch),
    "post_coarse_cut": ("hlod_gaussians_torch.hierarchy.spt",
                        "spt_cut_budgeted", _coarse_cut),
}


def register():
    """Adds the post faults to faults.FAULTS, for faults.planted."""
    from benchmark.harness import faults
    faults.FAULTS.update(FAULTS)
