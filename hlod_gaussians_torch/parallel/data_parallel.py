"""Multi-process training over a (data, gauss) process mesh (port of
hlod_gaussians_tpu/parallel/data_parallel.py:37-178).

The reference scales out with process-level SLURM jobs, one chunk per GPU,
synchronized through the filesystem (scripts/full_train.py:79-236). The JAX
package runs one jitted SPMD program over a device mesh; here each rank of
a torch.distributed world runs the same step on its own shard:

  * axis ``data``: the views of a step are split across ranks. Each rank
    renders its views one after another (kernel B1 forward, B2 backward a
    view) and the gradients are summed over ``data`` and divided by the
    global batch B, which is the gradient of the mean loss.
  * axis ``gauss``: the Gaussian capacity axis in the FSDP way. Each rank
    of a gauss group holds cap / n_gauss rows of the parameters, the Adam
    moments and the densify statistics; the group all-gathers the rows
    before the render, and each rank updates its own rows from the reduced
    gradient. (In the JAX package the axis is a placement that XLA
    resolves; the step's results are the same.)

A ``mesh`` of None is a world of one process: no collective runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from hlod_gaussians_torch import optim
from hlod_gaussians_torch.config import OptimizationConfig, RasterizerConfig
from hlod_gaussians_torch.models.gaussians import GaussianState
from hlod_gaussians_torch.parallel import distributed as pdist
from hlod_gaussians_torch.train import flat

# per-row (capacity-axis) tensors; `exposure` is replicated
ROW_PARAMS = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit")
ROW_STATS = ("xyz_grad_accum", "denom", "max_radii")


def make_mesh(n_data: int, n_gauss: int = 1, data_axis: str = "data",
              gauss_axis: str = "gauss"):
    """A ``(data_axis, gauss_axis)`` DeviceMesh over the whole
    torch.distributed world (``distributed.initialize`` first), rank-major:
    rank = data index * n_gauss + gauss index. The mesh's device type
    follows the backend (NCCL: cuda, Gloo: cpu); it only holds the process
    groups of its axes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed world: call "
                           "parallel.distributed.initialize first")
    n = dist.get_world_size()
    if n_data * n_gauss != n:
        raise ValueError(f"mesh ({n_data}, {n_gauss}) does not cover a world "
                         f"of {n} processes")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_gauss),
                            mesh_dim_names=(data_axis, gauss_axis))


def make_mesh_from_config(mcfg):
    """Mesh from a config.MeshConfig (axis names and shape): the `tile`
    axis doubles as the per-Gaussian shard axis of shard_train_state."""
    return make_mesh(mcfg.data, mcfg.tile, data_axis=mcfg.data_axis,
                     gauss_axis=mcfg.tile_axis)


class Axis(NamedTuple):
    size: int
    index: int      # this rank's coordinate on the axis
    group: object   # its process group (None in a world of one)


def mesh_axis(mesh, dim: int) -> Axis:
    if mesh is None:
        return Axis(1, 0, None)
    return Axis(mesh.size(dim), mesh.get_local_rank(dim), mesh.get_group(dim))


def batch_sharding(mesh) -> Callable:
    """f(x) -> this rank's block of a global per-view (or per-chunk) batch
    x [B, ...] along the ``data`` axis; B must divide over it."""
    ax = mesh_axis(mesh, 0)

    def f(x):
        b = x.shape[0] if hasattr(x, "shape") else len(x)
        if b % ax.size:
            raise ValueError(f"batch {b} does not divide over {ax.size} "
                             "data ranks")
        per = b // ax.size
        return x[ax.index * per:(ax.index + 1) * per]
    return f


# ---- row sharding ------------------------------------------------------

def _row_keys(adam: optim.AdamState):
    return [k for k in adam.m if k != "exposure"]


def shard_rows(ts: flat.FlatTrainState, index: int,
               count: int) -> flat.FlatTrainState:
    """Rows [index * cap / count, (index + 1) * cap / count) of every
    per-row tensor of ``ts`` (parameters, alive, nodes, Adam moments,
    densify statistics); the exposure table, its moments and the skybox /
    scaffold counts stay whole."""
    g = ts.gaussians
    cap = g.capacity
    if cap % count:
        raise ValueError(f"capacity {cap} does not divide over {count} "
                         "gauss ranks")
    if count == 1:
        return ts
    per = cap // count
    sl = slice(index * per, (index + 1) * per)
    rows = {k: getattr(g, k)[sl] for k in ROW_PARAMS + ("alive", "nodes")}
    keys = _row_keys(ts.adam)
    adam = optim.AdamState(
        m={k: (v[sl] if k in keys else v) for k, v in ts.adam.m.items()},
        v={k: (v[sl] if k in keys else v) for k, v in ts.adam.v.items()},
        step=ts.adam.step)
    return dataclasses.replace(
        ts, gaussians=dataclasses.replace(g, **rows), adam=adam,
        **{k: getattr(ts, k)[sl] for k in ROW_STATS})


def shard_train_state(ts: flat.FlatTrainState, mesh) -> flat.FlatTrainState:
    """This rank's part of the state on the mesh: its block of rows along
    the ``gauss`` axis (the same block on every ``data`` rank); the
    exposure table replicated."""
    ax = mesh_axis(mesh, 1)
    return shard_rows(ts, ax.index, ax.size)


def _gather_rows(tensors: List[torch.Tensor], ax: Axis) -> List[torch.Tensor]:
    """Each [rows, ...] tensor concatenated over the gauss group, one
    all-gather a dtype."""
    if ax.size == 1:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        n = tensors[idx[0]].shape[0]
        flat_parts = [tensors[i].reshape(n, -1) for i in idx]
        widths = [p.shape[1] for p in flat_parts]
        packed = torch.cat(flat_parts, dim=1)
        if dtype == torch.bool:
            packed = packed.to(torch.uint8)
        full = torch.cat(pdist.all_gather(packed, ax.group), dim=0)
        if dtype == torch.bool:
            full = full.to(torch.bool)
        for i, part in zip(idx, torch.split(full, widths, dim=1)):
            out[i] = part.reshape((-1,) + tuple(tensors[i].shape[1:]))
    return out


def gather_gaussians(g: GaussianState, mesh) -> GaussianState:
    """The whole state from each gauss rank's rows (all-gathered)."""
    ax = mesh_axis(mesh, 1)
    keys = ROW_PARAMS + ("alive", "nodes")
    full = _gather_rows([getattr(g, k) for k in keys], ax)
    return dataclasses.replace(g, **dict(zip(keys, full)))


def gather_train_state(ts: flat.FlatTrainState, mesh) -> flat.FlatTrainState:
    """The whole train state from each gauss rank's rows: the inverse of
    shard_train_state (for checkpoints, tests and the merge)."""
    ax = mesh_axis(mesh, 1)
    if ax.size == 1:
        return ts
    keys = _row_keys(ts.adam)
    parts = ([ts.adam.m[k] for k in keys] + [ts.adam.v[k] for k in keys]
             + [getattr(ts, k) for k in ROW_STATS])
    full = _gather_rows(parts, ax)
    nk = len(keys)
    m = dict(ts.adam.m, **dict(zip(keys, full[:nk])))
    v = dict(ts.adam.v, **dict(zip(keys, full[nk:2 * nk])))
    return dataclasses.replace(
        ts, gaussians=gather_gaussians(ts.gaussians, mesh),
        adam=optim.AdamState(m=m, v=v, step=ts.adam.step),
        **dict(zip(ROW_STATS, full[2 * nk:])))


def _local_prefix_counts(g: GaussianState, offset: int) -> GaussianState:
    """The rows [offset, offset + rows) as a state of their own: the skybox
    and scaffold rows are prefixes of the capacity, so they stay prefixes
    of the block."""
    rows = g.capacity
    sky = min(max(g.n_skybox - offset, 0), rows)
    prot = min(max(g.n_skybox + g.n_scaffold - offset, 0), rows)
    return dataclasses.replace(g, n_skybox=sky, n_scaffold=prot - sky)


# ---- the step ------------------------------------------------------------

def dp_train_step(
    ts: flat.FlatTrainState,       # this rank's shard (shard_train_state)
    world_view: torch.Tensor,      # [B_local,4,4] this rank's views
    full_proj: torch.Tensor,       # [B_local,4,4]
    campos: torch.Tensor,          # [B_local,3]
    tan_fovx,                      # [B_local]
    tan_fovy,                      # [B_local]
    gt_images: torch.Tensor,       # [B_local,3,H,W]
    bg: torch.Tensor,              # [3]
    exposure_idx,                  # [B_local] ints
    scene_extent: float = 1.0,
    *,
    mesh=None,
    opt: OptimizationConfig = OptimizationConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    width: int, height: int, k_max: int = 1024,
    sh_degree: int = 3,
    use_exposure: bool = True,
    antialiasing: bool = False,
    skybox_locked: bool = False,
    scale_big_gauss: bool = True,
    big_gauss_frac: float = 0.02,
) -> Tuple[flat.FlatTrainState, torch.Tensor]:
    """Data-parallel train step over the global batch of B = B_local x
    n_data views: every data rank passes the same number of its own views.

    Returns (this rank's new shard, the mean loss over the B views). The
    gradient is the mean loss's (each view's loss scaled by 1/B, summed
    over the rank's views, then over ``data``). Densification statistics
    follow a B-step sequential loop of the reference: each view has its own
    screen-space hook, so xyz_grad_accum sums per-view norms of the
    gradient times B (the norm of the averaged gradient cancels between
    opposing views); denom sums the views that saw a row, max_radii takes
    the per-view max and `visible` is any over views. Then the skybox lock,
    the sparse Adam over visible rows and the big-Gaussian shrink, as
    flat.train_step. No depth regularization, as in the JAX package."""
    data, gauss = mesh_axis(mesh, 0), mesh_axis(mesh, 1)
    g_own = ts.gaussians
    rows = g_own.capacity
    own = slice(gauss.index * rows, (gauss.index + 1) * rows)
    g = gather_gaussians(g_own, mesh)
    cap = g.capacity
    dev = g.xyz.device
    b_local = world_view.shape[0]
    b = b_local * data.size

    params = {k: p.detach().requires_grad_(True)
              for k, p in g.params().items()}
    names = list(params)
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    g2d = torch.zeros((rows,), dtype=torch.float32, device=dev)
    seen_views = torch.zeros((rows,), dtype=torch.float32, device=dev)
    radii = torch.zeros((rows,), dtype=torch.float32, device=dev)
    loss_sum = torch.zeros((1,), dtype=torch.float32, device=dev)
    for i in range(b_local):
        # this view's screen-space hook
        xy_offset = torch.zeros((cap, 2), dtype=torch.float32, device=dev,
                                requires_grad=True)
        loss, (out, *_) = flat.step_loss(
            g, params, xy_offset, world_view[i], full_proj[i], campos[i],
            tan_fovx[i], tan_fovy[i], gt_images[i], bg,
            exposure_idx=int(exposure_idx[i]), opt=opt, cfg=cfg,
            width=width, height=height, k_max=k_max, sh_degree=sh_degree,
            use_exposure=use_exposure, antialiasing=antialiasing)
        got = torch.autograd.grad(
            loss / b, [params[k] for k in names] + [xy_offset],
            allow_unused=True)
        for k, gk in zip(names, got):
            if gk is not None:
                grads[k] += gk
        if got[-1] is not None:
            g2d += torch.linalg.vector_norm(got[-1][own] * b, dim=-1)
        visible_i = out.visible[own]
        seen_views += visible_i.to(torch.float32)
        radii = torch.maximum(radii, out.radii[own].to(torch.float32))
        loss_sum += loss.detach()

    # one SUM and one MAX all-reduce over `data`: this rank's rows of the
    # per-row gradients, the replicated exposure gradient, the densify
    # sums and the loss
    row_keys = [k for k in names if k != "exposure"]
    own_grads = {k: grads[k][own] if k in row_keys else grads[k]
                 for k in names}
    sums = [own_grads[k] for k in names] + [g2d, seen_views, loss_sum]
    sums = _all_reduce_packed(sums, "sum", data)
    maxes = _all_reduce_packed([(seen_views > 0).to(torch.float32), radii],
                               "max", data)
    own_grads = dict(zip(names, sums[:len(names)]))
    g2d, seen_views, loss_sum = sums[len(names):]
    visible = maxes[0] > 0
    radii = maxes[1]

    xyz_accum = torch.where(visible, ts.xyz_grad_accum + g2d,
                            ts.xyz_grad_accum)
    denom = ts.denom + seen_views.to(torch.int32)
    max_radii = torch.maximum(ts.max_radii, radii)

    g_local = _local_prefix_counts(g_own, own.start)
    if skybox_locked:
        sky = g_local.skybox_mask
        for k in row_keys:
            gk = own_grads[k]
            own_grads[k] = torch.where(
                sky.reshape((rows,) + (1,) * (gk.ndim - 1)),
                torch.zeros_like(gk), gk)

    lrs = optim.param_lrs(opt, ts.step, scene_extent)
    new_params, adam = optim.sparse_adam_update(
        g_own.params(), own_grads, ts.adam, lrs, visible=visible)
    if scale_big_gauss:
        new_params = flat.shrink_big_gaussians(new_params, g_local,
                                               scene_extent, big_gauss_frac)
    new_ts = flat.FlatTrainState(
        gaussians=g_own.replace_params(new_params), adam=adam,
        xyz_grad_accum=xyz_accum, denom=denom, max_radii=max_radii,
        step=ts.step + 1)
    return new_ts, loss_sum[0] / b


def _all_reduce_packed(tensors: List[torch.Tensor], op: str,
                       ax: Axis) -> List[torch.Tensor]:
    """float32 tensors reduced over the axis as one flat buffer."""
    if ax.size == 1:
        return list(tensors)
    flat_buf = torch.cat([t.reshape(-1) for t in tensors])
    pdist.all_reduce(flat_buf, op, ax.group)
    out, i = [], 0
    for t in tensors:
        out.append(flat_buf[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out
