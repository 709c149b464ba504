"""Chunk-parallel training: every chunk trains in the same step (port of
hlod_gaussians_tpu/parallel/chunk_parallel.py:26-88).

The reference's only scale-out is process-level data parallelism over
chunks, through SLURM job arrays polled with `sacct`
(scripts/full_train.py:85-96,161-236). The JAX package stacks the chunks'
train states along a leading chunk axis, shards it over the `data` mesh
axis and vmaps the flat train step. Here the stacked state holds a rank's
block of chunks, and its chunks step one after another through
`flat.train_step` (kernels B1 and B2). Chunks are independent, as in the
reference: there is no cross-chunk traffic; the merge
(pipeline/merge.py) consolidates them afterwards.

A stacked state is a FlatTrainState whose tensors carry a leading chunk
axis K and whose `step` and `adam.step` are tuples of K ints.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from hlod_gaussians_torch import optim
from hlod_gaussians_torch.config import OptimizationConfig, RasterizerConfig
from hlod_gaussians_torch.models.gaussians import GaussianState
from hlod_gaussians_torch.parallel.data_parallel import mesh_axis
from hlod_gaussians_torch.train import flat


_G_TENSORS = tuple(f.name for f in dataclasses.fields(GaussianState)
                   if f.name not in ("n_skybox", "n_scaffold"))


def _leaves(ts: flat.FlatTrainState) -> List[torch.Tensor]:
    """The state's tensors in the order _map_tensors visits them."""
    return ([getattr(ts.gaussians, k) for k in _G_TENSORS]
            + list(ts.adam.m.values()) + list(ts.adam.v.values())
            + [ts.xyz_grad_accum, ts.denom, ts.max_radii])


def _map_tensors(fn, ts: flat.FlatTrainState, step,
                 adam_step) -> flat.FlatTrainState:
    g = ts.gaussians
    return flat.FlatTrainState(
        gaussians=dataclasses.replace(
            g, **{k: fn(getattr(g, k)) for k in _G_TENSORS}),
        adam=optim.AdamState(m={k: fn(v) for k, v in ts.adam.m.items()},
                             v={k: fn(v) for k, v in ts.adam.v.items()},
                             step=adam_step),
        xyz_grad_accum=fn(ts.xyz_grad_accum), denom=fn(ts.denom),
        max_radii=fn(ts.max_radii), step=step)


def stack_states(tss: Sequence[flat.FlatTrainState]) -> flat.FlatTrainState:
    """Stack per-chunk train states along a leading chunk axis. All chunks
    share the capacity, SH degree, exposure count and skybox / scaffold
    counts (the JAX pytrees must match in structure)."""
    first = tss[0].gaussians
    for ts in tss[1:]:
        g = ts.gaussians
        if (g.n_skybox, g.n_scaffold) != (first.n_skybox, first.n_scaffold):
            raise ValueError("chunk states differ in skybox / scaffold rows")
    stacked = iter([torch.stack(xs) for xs in zip(*map(_leaves, tss))])
    return _map_tensors(lambda _: next(stacked), tss[0],
                        tuple(ts.step for ts in tss),
                        tuple(ts.adam.step for ts in tss))


def unstack_states(bts: flat.FlatTrainState) -> List[flat.FlatTrainState]:
    return [_map_tensors(lambda x: x[i], bts, bts.step[i], bts.adam.step[i])
            for i in range(len(bts.step))]


def shard_chunk_states(bts: flat.FlatTrainState,
                       mesh) -> flat.FlatTrainState:
    """This rank's block of the chunk axis along ``data`` (K must divide
    over it); the same block on every ``gauss`` rank."""
    ax = mesh_axis(mesh, 0)
    k = len(bts.step)
    if k % ax.size:
        raise ValueError(f"{k} chunks do not divide over {ax.size} data "
                         "ranks")
    per = k // ax.size
    sl = slice(ax.index * per, (ax.index + 1) * per)
    return _map_tensors(lambda x: x[sl], bts, bts.step[sl],
                        bts.adam.step[sl])


def chunk_parallel_step(
    bts: flat.FlatTrainState,        # this rank's chunks, leading axis K
    world_view, full_proj, campos, tan_fovx, tan_fovy,   # [K, ...]
    gt_images,                        # [K, 3, H, W]
    bg,                               # [3]
    exposure_idx,                     # [K] ints
    scene_extent: float = 1.0,
    *,
    opt: OptimizationConfig = OptimizationConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    width: int, height: int, k_max: int = 1024, sh_degree: int = 3,
    use_exposure: bool = True,
    scale_big_gauss: bool = True,
    skybox_locked: bool = False,
) -> Tuple[flat.FlatTrainState, flat.StepAux]:
    """One step of each of the rank's chunks, each on its own view (K
    flat.train_step calls). Pass ``skybox_locked=True`` when the chunks
    share a coarse-stage skybox (the sequential chunk loop locks it;
    otherwise each chunk's copy drifts and the merge cannot reconcile
    them). Returns the stacked states and the stacked StepAux."""
    outs, auxs = [], []
    for i, ts in enumerate(unstack_states(bts)):
        ts1, aux = flat.train_step(
            ts, world_view[i], full_proj[i], campos[i], tan_fovx[i],
            tan_fovy[i], gt_images[i], bg, exposure_idx=int(exposure_idx[i]),
            scene_extent=scene_extent, opt=opt, cfg=cfg, width=width,
            height=height, k_max=k_max, sh_degree=sh_degree,
            use_exposure=use_exposure, skybox_locked=skybox_locked,
            scale_big_gauss=scale_big_gauss)
        outs.append(ts1)
        auxs.append(aux)
    return stack_states(outs), flat.StepAux(
        *(torch.stack(xs) for xs in zip(*auxs)))


def chunk_parallel_densify(bts: flat.FlatTrainState, scene_extent,
                           *, opt: OptimizationConfig = OptimizationConfig()
                           ) -> Tuple[flat.FlatTrainState, torch.Tensor]:
    """flat.densify_step on each of the rank's chunks -> (stacked states,
    [K] densified leaves)."""
    outs, counts = [], []
    for ts in unstack_states(bts):
        ts1, n = flat.densify_step(ts, scene_extent, opt=opt)
        outs.append(ts1)
        counts.append(n)
    return stack_states(outs), torch.stack(counts)
