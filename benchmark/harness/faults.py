"""Faults planted under the timed path, for the tests and the calibration
of the limits: each must turn `correct` false.

* state_unchanged: train_step returns the state it was given;
* half_batch: the training loss is taken over the top half of the image
  rows only, the mean over those;
* stale_frame: render_lod_stream hands back the previous frame's image;
* half_cut: render_lod_stream draws the tree with every other node dead.
"""

from __future__ import annotations

import contextlib


def _half_batch_loss(orig):
    import torch
    from hlod_gaussians_torch import render as render_mod
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.ops import ssim as ssim_ops

    def step_loss(g, params, xy_offset, world_view, full_proj, campos,
                  tan_fovx, tan_fovy, gt_image, bg, alpha_mask=None,
                  mono_invdepth=None, depth_mask=None, exposure_idx=None,
                  depth_w=0.0, *, opt, cfg, width, height, k_max, sh_degree,
                  use_exposure, antialiasing):
        act = gm.activate(g.replace_params(params))
        out = render_mod.render_arrays(
            act.means3d, act.scales, act.quats, act.opacities, act.shs,
            act.valid, world_view, full_proj, campos, tan_fovx, tan_fovy,
            bg, None, None, xy_offset, sh_degree=sh_degree, width=width,
            height=height, cfg=cfg, k_max=k_max, antialiasing=antialiasing)
        image = out.image
        if use_exposure and exposure_idx is not None:
            image = render_mod.apply_exposure(
                image, params["exposure"][exposure_idx])
        rows = height // 2
        img, gt = image[:, :rows], gt_image[:, :rows]
        l1 = torch.abs(img - gt).mean()
        s = ssim_ops.ssim(img, gt)
        loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1.0 - s)
        return loss, (out, image, l1, s, torch.zeros((), device=l1.device))
    return step_loss


def _state_unchanged(orig):
    def train_step(ts, *a, **kw):
        _, aux = orig(ts, *a, **kw)
        return ts, aux
    return train_step


def _stale_frame(orig):
    last = []

    def render_lod_stream(*a, **kw):
        out = orig(*a, **kw)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return render_lod_stream


def _half_cut(orig):
    import torch

    def render_lod_stream(means3d, scales, quats, opacities, shs, nodes,
                          alive, *a, **kw):
        keep = torch.arange(alive.shape[0], device=alive.device) % 2 == 0
        return orig(means3d, scales, quats, opacities, shs, nodes,
                    alive & keep, *a, **kw)
    return render_lod_stream


FAULTS = {
    "state_unchanged": ("hlod_gaussians_torch.train.flat", "train_step",
                        _state_unchanged),
    "half_batch": ("hlod_gaussians_torch.train.flat", "step_loss",
                   _half_batch_loss),
    "stale_frame": ("hlod_gaussians_torch.render", "render_lod_stream",
                    _stale_frame),
    "half_cut": ("hlod_gaussians_torch.render", "render_lod_stream",
                 _half_cut),
}


@contextlib.contextmanager
def planted(name):
    """The fault `name` in place for the duration (None: none)."""
    if name is None:
        yield
        return
    import importlib
    module, attr, make = FAULTS[name]
    mod = importlib.import_module(module)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)
