"""Hierarchy post-optimization: LOD-aware training on the full tree (port
of hlod_gaussians_tpu/train/post.py; reference train_post.py:112-886).

Per step an SPT working-set cut (hierarchy/spt.py) selects the
granularity-appropriate rows of the tree for the view; the full
capacity-padded state stays on the card and the cut is a boolean mask, so
only the selected rows reach binning and blending. `post_train_step` is
render (kernel B1) -> loss -> backward (kernel B2 and the per-Gaussian
reduction) -> masked Adam, and, with `mcmc_noise_lr`, covariance-shaped
exploration noise. Like the JAX package's, it returns a new state and
leaves its input untouched.

Loss (train_post.py:558-576):
    (1-lambda_dssim) * L1 + lambda_dssim * (1 - SSIM)
    + lambda_opacity * mean|sigmoid(opacity)|   (over the working set)
    + lambda_scaling * mean|exp(scale)|

Densification rounds (train_post.py:707-788): `densify_round` grows toward
max_cap (add_new_gs), then relocates dead leaves (relocate_gs); the caller
then rebuilds the SPT forest (`rebuild_spt`, a host sweep).

Spans (utils/metrics.span): post_train_step opens `hlod.loss`,
`hlod.backward` and `hlod.adam` as train/flat.py's train_step does;
densify_round opens `hlod.densify` and rebuild_spt `hlod.rebuild_spt`.

Also here: `create_from_dhier` (a loaded .dhier as a capacity-padded state)
and its inverse `state_to_dhier`. The JAX package's exposure-table swap
around the MCMC calls, which only spares XLA recompiles, has no
counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hlod_gaussians_torch import optim, render as render_mod
from hlod_gaussians_torch.config import (OptimizationConfig, PostConfig,
                                         RasterizerConfig)
from hlod_gaussians_torch.data.dhier import DHier
from hlod_gaussians_torch.hierarchy import mcmc, spt as spt_mod
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.ops import gaussian_math, quaternion
from hlod_gaussians_torch.ops import sh as sh_ops
from hlod_gaussians_torch.ops import ssim as ssim_ops
from hlod_gaussians_torch.utils.metrics import span


def create_from_dhier(
    d: DHier,
    capacity: int,
    skybox_num: int = 0,
    scene_radius: float = 1.0,
    n_exposures: int = 1,
    opacity_is_activated: bool = True,
    device=torch.device("cuda"),
) -> gm.GaussianState:
    """Load a .dhier into a capacity-padded state, prepending the skybox and
    shifting the node table (reference create_from_hier,
    scene/gaussian_model.py:990-1095). ``opacity_is_activated`` mirrors the
    .dhier convention of storing activated opacities."""
    g = d.pos.shape[0]
    total = g + skybox_num
    if total > capacity:
        raise ValueError(f"capacity {capacity} < {g} + skybox {skybox_num}")
    # fills the freshly allocated state in place
    state = gm.empty_state(capacity, d.sh_degree, n_exposures,
                           n_skybox=skybox_num, device=device)

    def dev(a):
        return torch.tensor(np.asarray(a), device=device)

    if skybox_num > 0:
        sky_pos, sky_col = gm.make_skybox(skybox_num, 10.0 * scene_radius)
        state.xyz[:skybox_num] = dev(sky_pos)
        state.f_dc[:skybox_num] = sh_ops.rgb_to_sh(dev(sky_col))[:, None, :]
        state.opacity_logit[:skybox_num] = gm.inverse_sigmoid(
            torch.tensor(0.7, dtype=torch.float32))
        state.log_scale[:skybox_num] = torch.log(
            torch.tensor(scene_radius * 0.1, dtype=torch.float32))
        # skybox rows are flagged depth=-1 (skipped by cuts, reference
        # markNodesForSizeDynamic runtime_switching.cu:560-563)
        state.nodes[:skybox_num] = dev(np.array([-1, -1, 0, -1, 0, 0],
                                                np.int32))

    op = d.opacity
    if opacity_is_activated:
        op_c = np.clip(op, 1e-6, 1 - 1e-6)
        op_logit = np.log(op_c / (1.0 - op_c))
    else:
        op_logit = op

    nodes = d.nodes.copy()
    # shift child/parent/sibling indices by the skybox offset
    for col in (gm.NODE_PARENT, gm.NODE_FIRST_CHILD, gm.NODE_NEXT_SIBLING):
        nodes[:, col] = np.where(nodes[:, col] > 0, nodes[:, col] + skybox_num,
                                 nodes[:, col])
    # parent == 0 is the root's child: it now points at the shifted root
    nodes[d.nodes[:, gm.NODE_PARENT] == 0, gm.NODE_PARENT] = skybox_num

    sl = slice(skybox_num, total)
    k = d.shs.shape[1]
    state.xyz[sl] = dev(d.pos)
    state.quat[sl] = dev(d.quat)
    state.log_scale[sl] = dev(d.log_scale)
    state.opacity_logit[sl] = dev(op_logit.astype(np.float32))[:, None]
    state.f_dc[sl] = dev(d.shs[:, :1])
    state.f_rest[sl, :k - 1] = dev(d.shs[:, 1:])
    state.nodes[sl] = dev(nodes.astype(np.int32))
    state.alive[:total] = True
    return state


def state_to_dhier(state: gm.GaussianState) -> DHier:
    """Export the non-skybox rows back to a .dhier (reference save_hier,
    scene/gaussian_model.py:1115-1124)."""
    def host(t):
        return t.detach().cpu().numpy()

    alive = host(state.alive)
    sky = state.n_skybox
    rows = np.where(alive)[0]
    rows = rows[rows >= sky]
    remap = np.full(state.capacity, -1, np.int64)
    remap[rows] = np.arange(len(rows))

    nodes = host(state.nodes)[rows].copy()
    for col in (gm.NODE_PARENT, gm.NODE_FIRST_CHILD, gm.NODE_NEXT_SIBLING):
        v = nodes[:, col]
        nodes[:, col] = np.where(v >= sky,
                                 remap[np.clip(v, 0, state.capacity - 1)],
                                 np.minimum(v, 0))
    shs = np.concatenate([host(state.f_dc)[rows], host(state.f_rest)[rows]],
                         axis=1)
    op = 1.0 / (1.0 + np.exp(-host(state.opacity_logit)[rows, 0]))
    return DHier(
        sh_degree=state.sh_degree, pos=host(state.xyz)[rows],
        quat=host(state.quat)[rows], log_scale=host(state.log_scale)[rows],
        opacity=op.astype(np.float32), shs=shs.astype(np.float32),
        nodes=nodes.astype(np.int32))


@dataclasses.dataclass(frozen=True)
class PostTrainState:
    gaussians: gm.GaussianState
    adam: optim.AdamState
    step: int


def init_post_train(state: gm.GaussianState) -> PostTrainState:
    return PostTrainState(gaussians=state, adam=optim.init_adam(state.params()),
                          step=0)


class PostAux(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    ssim: torch.Tensor
    n_rendered: torch.Tensor
    image: torch.Tensor
    truncated: torch.Tensor


def mcmc_noise(step: int, shape, device) -> torch.Tensor:
    """The exploration noise's standard normal draw for a step: a generator
    seeded by the step (the JAX package draws from
    fold_in(PRNGKey(0), step), post.py:236-239, which torch cannot
    replay)."""
    gen = torch.Generator(device=device).manual_seed(int(step))
    return torch.randn(shape, generator=gen, device=device)


def post_loss(
    g: gm.GaussianState, params: dict, cut_mask: torch.Tensor,
    world_view, full_proj, campos, tan_fovx, tan_fovy,
    gt_image: torch.Tensor, bg: torch.Tensor,
    *,
    opt: OptimizationConfig, post: PostConfig, cfg: RasterizerConfig,
    width: int, height: int, k_max: int, sh_degree: int,
    antialiasing: bool,
):
    """The forward half of post_train_step: render `params` over the working
    set (and the skybox) and score the view in `hlod.loss` -> (loss,
    (render result, image, l1, ssim))."""
    out = render_mod.render_params(
        g.replace_params(params), cut_mask | g.skybox_mask, world_view,
        full_proj, campos, tan_fovx, tan_fovy, bg, sh_degree=sh_degree,
        width=width, height=height, cfg=cfg, k_max=k_max,
        antialiasing=antialiasing)
    with span("hlod.loss"):
        image = out.image
        l1 = torch.abs(image - gt_image).mean()
        ssim_v = ssim_ops.ssim(image, gt_image)
        loss = ((1.0 - opt.lambda_dssim) * l1
                + opt.lambda_dssim * (1.0 - ssim_v))
        # MCMC regularizers over the working set (train_post.py:565-576)
        ws = cut_mask & g.alive
        n_ws = torch.clamp_min(torch.sum(ws), 1)
        if post.lambda_opacity > 0:
            op = torch.sigmoid(params["opacity_logit"][:, 0])
            loss = loss + post.lambda_opacity * torch.sum(
                torch.where(ws, torch.abs(op), 0.0)) / n_ws
        if post.lambda_scaling > 0:
            sc = torch.exp(params["log_scale"])
            loss = loss + post.lambda_scaling * torch.sum(
                torch.where(ws[:, None], torch.abs(sc), 0.0)) / n_ws
    return loss, (out, image, l1, ssim_v)


def post_train_step(
    ts: PostTrainState,
    cut_mask: torch.Tensor,             # [C] bool working set for this view
    world_view, full_proj, campos, tan_fovx, tan_fovy,
    gt_image: torch.Tensor,             # [3,H,W]
    bg: torch.Tensor,                   # [3]
    scene_extent: float = 1.0,
    *,
    opt: OptimizationConfig = OptimizationConfig(),
    post: PostConfig = PostConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    width: int, height: int, k_max: int = 1024,
    sh_degree: int = 1,
    antialiasing: bool = True,
    eps: Optional[torch.Tensor] = None,
) -> Tuple[PostTrainState, PostAux]:
    """One post-optimization step over the masked working set
    (train_post.py:495-620 + 790-818): render_params' spans, then
    `hlod.loss`, `hlod.backward` and `hlod.adam` (the skybox gradient
    mask, masked Adam and the noise). ``eps`` ([C,3]) is the exploration
    noise's normal draw; without it `mcmc_noise` draws one when
    post.mcmc_noise_lr > 0."""
    g = ts.gaussians
    cap = g.capacity
    params = {k: p.detach().requires_grad_(True)
              for k, p in g.params().items()}
    loss, (out, image, l1, ssim_v) = post_loss(
        g, params, cut_mask, world_view, full_proj, campos, tan_fovx,
        tan_fovy, gt_image, bg, opt=opt, post=post, cfg=cfg, width=width,
        height=height, k_max=k_max, sh_degree=sh_degree,
        antialiasing=antialiasing)
    names = list(params)
    with span("hlod.backward"):
        got = torch.autograd.grad(loss, [params[k] for k in names],
                                  allow_unused=True)
    # the exposure table is not in the loss: a zero gradient, as under
    # jax.grad
    grads = {k: torch.zeros_like(params[k]) if gk is None else gk
             for k, gk in zip(names, got)}
    params = {k: p.detach() for k, p in params.items()}

    with span("hlod.adam"):
        # skybox rows train colour and opacity but not geometry
        # (train_post.py:790-800)
        sky = g.skybox_mask
        for k in ("xyz", "quat", "log_scale"):
            gk = grads[k]
            grads[k] = torch.where(
                sky.reshape((cap,) + (1,) * (gk.ndim - 1)),
                torch.zeros_like(gk), gk)

        lrs = optim.param_lrs(opt, ts.step, scene_extent,
                              lr_multiplier=post.lr_multiplier)
        visible = out.visible
        new_params, adam = optim.sparse_adam_update(params, grads, ts.adam,
                                                    lrs, visible=visible)

        if post.mcmc_noise_lr > 0:
            # covariance-shaped exploration noise on low-opacity
            # working-set rows (3DGS-as-MCMC; reference
            # train_post.py:869-885):
            #   noise = Sigma @ randn * sigmoid(-100*(opacity - 0.995)) * lr
            if eps is None:
                eps = mcmc_noise(ts.step, new_params["xyz"].shape,
                                 g.xyz.device)
            op = torch.sigmoid(new_params["opacity_logit"][:, 0])
            gate = torch.sigmoid(-100.0 * (op - 0.995))
            cov = gaussian_math.unpack_cov3d(gaussian_math.compute_cov3d(
                torch.exp(new_params["log_scale"]),
                quaternion.normalize(new_params["quat"])))
            shaped = torch.einsum("nij,nj->ni", cov, eps)
            mask = (visible & ~sky)[:, None]
            new_params = dict(new_params, xyz=new_params["xyz"] + torch.where(
                mask,
                shaped * gate[:, None] * post.mcmc_noise_lr * lrs["xyz"],
                0.0))

        new_ts = PostTrainState(gaussians=g.replace_params(new_params),
                                adam=adam, step=ts.step + 1)
    aux = PostAux(loss=loss.detach(), l1=l1.detach(), ssim=ssim_v.detach(),
                  n_rendered=torch.sum(visible), image=image.detach(),
                  truncated=out.truncated)
    return new_ts, aux


def densify_round(
    ts: PostTrainState,
    generator: Optional[torch.Generator] = None,
    *,
    post: PostConfig = PostConfig(),
    budget: int = 4096,
    max_depth: int = 40,
    extra_dead: Optional[torch.Tensor] = None,
    sampled: Optional[tuple] = None,
) -> Tuple[PostTrainState, dict]:
    """Grow + relocate, as the reference does every densify_interval
    (train_post.py:707-788): add_new_gs toward max_cap (grow_fraction
    growth), then relocate dead leaves. ``extra_dead`` feeds the MIP respawn
    of never-visible SPT entries (spt.mip_respawn_mask). The host draws come
    from `generator`, or from ``sampled`` = (add_new_gs draws, relocate_gs
    draws). One host sync reads the live count. Inside `hlod.densify`."""
    with span("hlod.densify"):
        g = ts.gaussians
        if not post.mcmc_densification:
            # the reference runs NO densification without the MCMC flag
            # (every grow/relocate site is inside `if MCMC_Densification`)
            return ts, dict(n_added_pairs=0, n_relocated=0,
                            size=torch.sum(g.alive))
        size = int(torch.sum(g.alive))
        # the target in float32, as the JAX package rounds it
        target = min(post.max_cap, int(np.float32(size)
                                       * np.float32(1.0 + post.grow_fraction)))
        n_new = max(target - size, 0)
        s_add, s_rel = sampled if sampled is not None else (None, None)

        g2, adam2, n_pairs = mcmc.add_new_gs(
            g, ts.adam, n_new, budget=budget, sampled=s_add,
            generator=generator)
        g3, adam3, n_reloc = mcmc.relocate_gs(
            g2, adam2, post.dead_opacity, budget=budget, max_depth=max_depth,
            extra_dead=extra_dead, sampled=s_rel, generator=generator)
        stats = dict(n_added_pairs=n_pairs, n_relocated=n_reloc,
                     size=torch.sum(g3.alive))
        return PostTrainState(gaussians=g3, adam=adam3, step=ts.step), stats


def rebuild_spt(state: gm.GaussianState, *, post: PostConfig = PostConfig(),
                max_depth: int = 64) -> spt_mod.SPTForest:
    """(Re)build the SPT forest from the current state: the state comes to
    the host for spt.build_spt's numpy sweep, the forest goes back to the
    state's device. Inside `hlod.rebuild_spt`."""
    with span("hlod.rebuild_spt"):
        alive = state.alive.cpu().numpy()
        nodes = state.nodes.cpu().numpy()
        root_candidates = np.where(alive & (nodes[:, gm.NODE_PARENT] == -1)
                                   & (nodes[:, gm.NODE_DEPTH] >= 0))[0]
        root = int(root_candidates[0])
        return spt_mod.build_spt(
            nodes, state.xyz.cpu().numpy(),
            np.exp(state.log_scale.cpu().numpy()), alive, root,
            root_volume=post.spt_root_volume,
            target_granularity=post.spt_target_granularity,
            min_spt_size=post.min_spt_size, max_depth=max_depth,
            use_bounding_spheres=post.use_bounding_spheres,
            device=state.xyz.device)
