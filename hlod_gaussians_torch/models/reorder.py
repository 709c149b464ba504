"""Storage reordering + occlusion culling (port of
hlod_gaussians_tpu/models/reorder.py).

* `sort_morton` — permute the live rows into Morton (Z-curve) order and fix
  every node-table index (reference sort_morton,
  scene/gaussian_model.py:570-601 + morton.cu:8-45), so per-view working
  sets are near-contiguous rows.
* `occlusion_cull` — render a candidate subset at low resolution and keep
  the Gaussians that contributed to a pixel (the reference renders the
  upper tree and reads back the `seen` buffer,
  gaussian_renderer/__init__.py:24-33). On the card that render is kernel
  B1 with its `seen` output; on the CPU the plain scan path, which always
  computes `seen`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from hlod_gaussians_torch import optim, render as render_mod
from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.models.gaussians import GaussianState
from hlod_gaussians_torch.ops import morton


def sort_morton(state: GaussianState, adam: Optional[optim.AdamState] = None
                ) -> Tuple[GaussianState, Optional[optim.AdamState]]:
    """Reorder rows: [skybox | live rows in Morton order | dead rows].

    The codes quantize over all capacity rows, dead rows included, as the
    JAX package's do. Its sort keys are (bucket, code, row) with bucket 0
    skybox (keyed by row), 1 live, 2 dead; here two stable sorts, the code
    first, then the bucket. Node-table indices (parent / first_child /
    next_sibling) are remapped through the permutation. Returns the permuted
    (state, adam)."""
    cap = state.capacity
    idx = torch.arange(cap, device=state.xyz.device)
    is_sky = idx < state.n_skybox
    bucket = torch.where(is_sky, 0, torch.where(state.alive, 1, 2))
    key = torch.where(is_sky, idx, morton.morton_codes(state.xyz))
    order = torch.sort(key, stable=True).indices
    order = order[torch.sort(bucket[order], stable=True).indices]
    inv = torch.empty_like(order)
    inv[order] = idx                                   # old_row -> new_row

    nodes = state.nodes[order]
    # parent >= 0 is an index (-1 root sentinel); first_child > 0 is an
    # index (0 / -1 leaf sentinels, and row 0 is never a child);
    # next_sibling > 0 is an index (0 chain-end sentinel)
    for col, lowest in ((gm.NODE_PARENT, 0), (gm.NODE_FIRST_CHILD, 1),
                        (gm.NODE_NEXT_SIBLING, 1)):
        v = nodes[:, col]
        nodes[:, col] = torch.where(
            v >= lowest, inv[torch.clamp(v, 0, cap - 1).long()].to(v.dtype),
            v)

    new_state = dataclasses.replace(
        state, xyz=state.xyz[order], f_dc=state.f_dc[order],
        f_rest=state.f_rest[order], log_scale=state.log_scale[order],
        quat=state.quat[order], opacity_logit=state.opacity_logit[order],
        alive=state.alive[order], nodes=nodes)

    new_adam = None
    if adam is not None:
        def permute_rows(t):
            return t[order] if t.ndim >= 1 and t.shape[0] == cap else t
        new_adam = optim.AdamState(
            m={k: permute_rows(v) for k, v in adam.m.items()},
            v={k: permute_rows(v) for k, v in adam.v.items()},
            step=adam.step)
    return new_state, new_adam


def occlusion_render(
    state: GaussianState,
    candidate_mask: torch.Tensor,
    world_view, full_proj, campos, tan_fovx, tan_fovy,
    *,
    width: int = 256, height: int = 256,
    k_max: int = 512,
):
    """The low-resolution render behind `occlusion_cull` (its RenderResult:
    `seen`, and `truncated` when the candidates overflow its 2^17 entries).
    The backend follows the state's device: "pallas" (kernel B1 with `seen`)
    on the card, "xla" on the CPU."""
    act = gm.activate(state, candidate_mask)
    backend = "pallas" if state.xyz.is_cuda else "xla"
    cfg = RasterizerConfig(backend=backend, tile_w=16, tile_h=16,
                           max_dup=1 << 17)
    with torch.no_grad():
        return render_mod.render_arrays(
            act.means3d, act.scales, act.quats, act.opacities, act.shs,
            act.valid, world_view, full_proj, campos, tan_fovx, tan_fovy,
            torch.zeros(3, device=state.xyz.device),
            sh_degree=state.sh_degree, width=width, height=height, cfg=cfg,
            k_max=k_max, want_seen=True)


def occlusion_cull(
    state: GaussianState,
    candidate_mask: torch.Tensor,
    world_view, full_proj, campos, tan_fovx, tan_fovy,
    *,
    width: int = 256, height: int = 256,
    k_max: int = 512,
) -> torch.Tensor:
    """[C] bool — candidates that contributed to a low-res render."""
    out = occlusion_render(state, candidate_mask, world_view, full_proj,
                           campos, tan_fovx, tan_fovy, width=width,
                           height=height, k_max=k_max)
    return out.seen & candidate_mask
