"""Flat 3DGS training: the per-view train step (port of
hlod_gaussians_tpu/train/flat.py:38-291; reference train_single.py
::training and the hierarchy-aware densification of
scene/gaussian_model.py:1348-1530).

`train_step` is render (kernel B1) -> loss -> backward (kernel B2 and the
per-Gaussian reduction) -> densification statistics -> masked Adam ->
big-Gaussian shrink over the capacity-padded state. Like the JAX package's,
it is functional: it returns a new state and leaves its input untouched.
`densify_step` writes new children into free capacity rows.

Loss (train_single.py:106-117):
    (1-lambda_dssim) * L1 + lambda_dssim * (1 - SSIM)
    + depth_l1_weight(iter) * mean|invdepth - mono_invdepth| * depth_mask

Densify condition (fork variant, scene/gaussian_model.py:1452-1470):
    |grad_2d| * max_radii2D * opacity^(1/5) >= threshold
    AND opacity > 0.15 AND leaf (child_count == 0) AND not skybox/scaffold.
Selected leaves get TWO children (same position, scale and opacity divided
by 0.8*N with N=2); the parent stays alive (it becomes an interior node).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hlod_gaussians_torch import optim, render as render_mod
from hlod_gaussians_torch.config import OptimizationConfig, RasterizerConfig
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.models.gaussians import GaussianState
from hlod_gaussians_torch.ops import ssim as ssim_ops
from hlod_gaussians_torch.utils.metrics import span


def _log32(x) -> float:
    """log of a constant rounded to float32, computed in float32 as the JAX
    package computes its constants."""
    return float(np.log(np.float32(x)))


@dataclasses.dataclass(frozen=True)
class FlatTrainState:
    gaussians: GaussianState
    adam: optim.AdamState
    xyz_grad_accum: torch.Tensor  # [C] running max of screen-space grad norms
    denom: torch.Tensor           # [C] int32 visibility counts
    max_radii: torch.Tensor       # [C] float32 max screen radius since last densify
    step: int


def init_flat_train(state: GaussianState) -> FlatTrainState:
    c = state.capacity
    dev = state.xyz.device
    return FlatTrainState(
        gaussians=state,
        adam=optim.init_adam(state.params()),
        xyz_grad_accum=torch.zeros((c,), dtype=torch.float32, device=dev),
        denom=torch.zeros((c,), dtype=torch.int32, device=dev),
        max_radii=torch.zeros((c,), dtype=torch.float32, device=dev),
        step=0,
    )


class StepAux(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    ssim: torch.Tensor
    depth_l1: torch.Tensor
    image: torch.Tensor
    n_visible: torch.Tensor
    truncated: torch.Tensor


def step_loss(
    g: GaussianState, params: dict, xy_offset: torch.Tensor,
    world_view, full_proj, campos, tan_fovx, tan_fovy,
    gt_image: torch.Tensor, bg: torch.Tensor,
    alpha_mask: Optional[torch.Tensor] = None,
    mono_invdepth: Optional[torch.Tensor] = None,
    depth_mask: Optional[torch.Tensor] = None,
    exposure_idx: Optional[int] = None,
    depth_w: float = 0.0,
    *,
    opt: OptimizationConfig, cfg: RasterizerConfig, width: int, height: int,
    k_max: int, sh_degree: int, use_exposure: bool, antialiasing: bool,
):
    """The forward half of train_step: render `params` (with the state's
    other fields) and score the view -> (loss, (render result, image, l1,
    ssim, depth_l1))."""
    out = render_mod.render_params(
        g.replace_params(params), None, world_view, full_proj, campos,
        tan_fovx, tan_fovy, bg, xy_offset, sh_degree=sh_degree, width=width,
        height=height, cfg=cfg, k_max=k_max, antialiasing=antialiasing)
    with span("hlod.loss"):
        image = out.image
        if use_exposure and exposure_idx is not None:
            image = render_mod.apply_exposure(
                image, params["exposure"][exposure_idx])
        if alpha_mask is not None:
            image = image * alpha_mask
        l1 = torch.abs(image - gt_image).mean()
        ssim_v = ssim_ops.ssim(image, gt_image)
        photo = ((1.0 - opt.lambda_dssim) * l1
                 + opt.lambda_dssim * (1.0 - ssim_v))
        if mono_invdepth is not None:
            dmask = depth_mask if depth_mask is not None else 1.0
            depth_l1 = torch.abs((out.invdepth - mono_invdepth)
                                 * dmask).mean()
        else:
            depth_l1 = torch.zeros((), device=image.device)
        loss = photo + depth_w * depth_l1
    return loss, (out, image, l1, ssim_v, depth_l1)


def train_step(
    ts: FlatTrainState,
    world_view: torch.Tensor, full_proj: torch.Tensor, campos: torch.Tensor,
    tan_fovx, tan_fovy,
    gt_image: torch.Tensor,                 # [3,H,W]
    bg: torch.Tensor,                       # [3]
    alpha_mask: Optional[torch.Tensor] = None,     # [1,H,W] or None
    mono_invdepth: Optional[torch.Tensor] = None,  # [H,W] or None
    depth_mask: Optional[torch.Tensor] = None,     # [H,W] or None
    exposure_idx: Optional[int] = None,
    scene_extent: float = 1.0,
    *,
    opt: OptimizationConfig = OptimizationConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    width: int, height: int, k_max: int = 1024,
    sh_degree: int = 3,
    use_exposure: bool = True,
    skybox_locked: bool = False,
    antialiasing: bool = False,
    scale_big_gauss: bool = True,
    big_gauss_frac: float = 0.02,
) -> Tuple[FlatTrainState, StepAux]:
    """One optimization step on a single view, inside the `hlod.train_step`
    span: render_params' spans, then `hlod.loss`, `hlod.backward` and
    `hlod.adam` (densification statistics, masked Adam, the shrink)."""
    with span("hlod.train_step"):
        g = ts.gaussians
        cap = g.capacity
        depth_w = optim.expon_lr(ts.step, opt.depth_l1_weight_init,
                                 opt.depth_l1_weight_final,
                                 max_steps=opt.iterations)

        params = {k: p.detach().requires_grad_(True)
                  for k, p in g.params().items()}
        # the screen-space gradient (reference screenspace_points)
        xy_offset = torch.zeros((cap, 2), dtype=torch.float32,
                                device=g.xyz.device, requires_grad=True)
        loss, (out, image, l1, ssim_v, depth_l1) = step_loss(
            g, params, xy_offset, world_view, full_proj, campos, tan_fovx,
            tan_fovy, gt_image, bg, alpha_mask, mono_invdepth, depth_mask,
            exposure_idx, depth_w, opt=opt, cfg=cfg, width=width,
            height=height, k_max=k_max, sh_degree=sh_degree,
            use_exposure=use_exposure, antialiasing=antialiasing)
        names = list(params)
        with span("hlod.backward"):
            got = torch.autograd.grad(
                loss, [params[k] for k in names] + [xy_offset],
                allow_unused=True)
        # a tensor the loss does not reach (exposure without use_exposure)
        # gets a zero gradient, as under jax.grad
        grads = {k: torch.zeros_like(params[k]) if gk is None else gk
                 for k, gk in zip(names, got)}
        xy_grad = (got[-1] if got[-1] is not None
                   else torch.zeros_like(xy_offset))
        params = {k: p.detach() for k, p in params.items()}

        if skybox_locked:
            sky = g.skybox_mask
            for k in ("xyz", "quat", "f_dc", "f_rest", "opacity_logit",
                      "log_scale"):
                gk = grads[k]
                grads[k] = torch.where(
                    sky.reshape((cap,) + (1,) * (gk.ndim - 1)),
                    torch.zeros_like(gk), gk)

        with span("hlod.adam"):
            # densification stats (scene/gaussian_model.py:1522-1530):
            # running MAX of screen-space gradient norms over visible rows;
            # radii likewise
            visible = out.visible
            g2d = torch.linalg.vector_norm(xy_grad, dim=-1)
            xyz_accum = torch.where(
                visible, torch.maximum(ts.xyz_grad_accum, g2d),
                ts.xyz_grad_accum)
            denom = ts.denom + visible.to(torch.int32)
            max_radii = torch.where(
                visible,
                torch.maximum(ts.max_radii, out.radii.to(torch.float32)),
                ts.max_radii)

            lrs = optim.param_lrs(opt, ts.step, scene_extent)
            new_params, adam = optim.sparse_adam_update(
                params, grads, ts.adam, lrs, visible=visible)
            # big-Gaussian shrink (train_single.py:180-186)
            if scale_big_gauss:
                new_params = shrink_big_gaussians(new_params, g, scene_extent,
                                                  big_gauss_frac)

            new_ts = FlatTrainState(
                gaussians=g.replace_params(new_params), adam=adam,
                xyz_grad_accum=xyz_accum, denom=denom, max_radii=max_radii,
                step=ts.step + 1)
        aux = StepAux(loss=loss.detach(), l1=l1.detach(),
                      ssim=ssim_v.detach(), depth_l1=depth_l1.detach(),
                      image=image.detach(), n_visible=torch.sum(visible),
                      truncated=out.truncated)
        return new_ts, aux


def _scatter_rows(dst, rows, src):
    """dst with dst[rows[i]] = src[i] where rows[i] < C; rows == C are
    dropped (jnp .at[].set(mode="drop")). Rows below C are distinct."""
    ext = torch.cat([dst, dst[:1]])        # the spare row takes the drops
    ext[rows] = src
    return ext[:dst.shape[0]]


def densify_step(ts: FlatTrainState, scene_extent,
                 *, opt: OptimizationConfig = OptimizationConfig(),
                 mode: str = "split",
                 ) -> Tuple[FlatTrainState, torch.Tensor]:
    """Hierarchy-aware densification: each selected leaf gains two children
    written into free capacity slots.

    mode="split" divides the children's scale and opacity by 0.8*N
    (reference densify, gaussian_model.py:1452-1503); mode="clone" copies
    them unchanged (densify_and_clone, gaussian_model.py:1404-1449).
    Returns (new_state, number_of_densified_leaves as a 0-d tensor).
    """
    g = ts.gaussians
    cap = g.capacity
    dev = g.xyz.device
    opacity = torch.sigmoid(g.opacity_logit[:, 0])

    score = ts.xyz_grad_accum * ts.max_radii * torch.pow(opacity, 0.2)
    sel = (score >= opt.densify_grad_threshold) & (opacity > 0.15)
    sel = sel & g.alive & (~g.protected_mask)
    sel = sel & (g.nodes[:, gm.NODE_CHILD_COUNT] <= 0)

    free = ~g.alive
    n_free = torch.sum(free)
    idx = torch.arange(cap, device=dev)
    # free rows in ascending order, then the fill value cap
    free_idx = torch.sort(torch.where(free, idx, cap)).values

    rank = torch.cumsum(sel.to(torch.int64), 0) - 1      # rank among selected
    can = sel & (2 * rank + 1 < n_free)
    c0 = torch.where(can, free_idx[torch.clamp(2 * rank, 0, cap - 1)], cap)
    c1 = torch.where(can, free_idx[torch.clamp(2 * rank + 1, 0, cap - 1)], cap)

    if mode == "split":
        inv08n = 1.0 / (0.8 * 2.0)
        child_ls = g.log_scale + _log32(inv08n)
        child_op = gm.inverse_sigmoid(
            torch.clamp(opacity * inv08n, 1e-6, 1 - 1e-6))[:, None]
    elif mode == "clone":
        child_ls = g.log_scale
        child_op = g.opacity_logit
    else:
        raise ValueError(mode)

    def scatter2(dst, src):
        return _scatter_rows(_scatter_rows(dst, c0, src), c1, src)

    alive_src = torch.ones_like(g.alive)
    depth1 = g.nodes[:, gm.NODE_DEPTH] + 1
    parent_idx = idx.to(torch.int32)
    zeros = torch.zeros_like(depth1)
    node_c0 = torch.stack([depth1, parent_idx, zeros, torch.full_like(depth1, -1),
                           c1.to(torch.int32), zeros], dim=-1)
    node_c1 = torch.stack([depth1, parent_idx, zeros, torch.full_like(depth1, -1),
                           zeros, zeros], dim=-1)
    nodes = _scatter_rows(_scatter_rows(g.nodes, c0, node_c0), c1, node_c1)
    # the parent becomes interior
    interior = nodes.clone()
    interior[:, gm.NODE_CHILD_COUNT] = 2
    interior[:, gm.NODE_FIRST_CHILD] = c0.to(torch.int32)
    nodes = torch.where(can[:, None], interior, nodes)

    new_g = dataclasses.replace(
        g, xyz=scatter2(g.xyz, g.xyz), f_dc=scatter2(g.f_dc, g.f_dc),
        f_rest=scatter2(g.f_rest, g.f_rest), quat=scatter2(g.quat, g.quat),
        log_scale=scatter2(g.log_scale, child_ls),
        opacity_logit=scatter2(g.opacity_logit, child_op),
        alive=scatter2(g.alive, alive_src), nodes=nodes)

    # fresh Adam moments for the new rows
    new_rows = scatter2(torch.zeros_like(g.alive), alive_src)
    new_ts = FlatTrainState(
        gaussians=new_g, adam=optim.zero_rows(ts.adam, new_rows),
        xyz_grad_accum=torch.zeros_like(ts.xyz_grad_accum),
        denom=torch.zeros_like(ts.denom),
        max_radii=torch.zeros_like(ts.max_radii),
        step=ts.step)
    return new_ts, torch.sum(can)


def shrink_big_gaussians(new_params: dict, g: GaussianState, scene_extent,
                         big_gauss_frac: float) -> dict:
    """Gaussians above big_gauss_frac of the scene extent shrink by 0.8
    each step (2% for chunk training, 10% for the coarse scaffold,
    train_coarse.py:168-172); skybox and scaffold rows excluded
    (train_single.py:184-185)."""
    ls = new_params["log_scale"]
    limit = _log32(np.float32(scene_extent) * np.float32(big_gauss_frac))
    viol = (torch.max(ls, dim=-1).values > limit) & g.alive
    viol = viol & (~g.protected_mask)
    ls = torch.where(viol[:, None], ls + _log32(0.8), ls)
    return dict(new_params, log_scale=ls)


def reset_opacity(ts: FlatTrainState) -> FlatTrainState:
    """Clamp opacity to <= 0.01 for non-skybox rows (reference
    reset_opacity, scene/gaussian_model.py:1214-1218)."""
    g = ts.gaussians
    op = torch.sigmoid(g.opacity_logit)
    new_logit = gm.inverse_sigmoid(torch.clamp_max(op, 0.01))
    sky = g.skybox_mask[:, None]
    logit = torch.where(sky, g.opacity_logit, new_logit)
    # the reference swaps ONLY the opacity tensor in the optimizer,
    # resetting its moments — the other tensors keep their momentum
    # (replace_tensor_to_optimizer, scene/gaussian_model.py:1214-1218)
    adam = optim.zero_rows(ts.adam, ~g.skybox_mask, keys=("opacity_logit",))
    return dataclasses.replace(
        ts, gaussians=dataclasses.replace(g, opacity_logit=logit), adam=adam)
