"""Debug / diagnostic renders (port of hlod_gaussians_tpu/debug.py).

Counterparts of the reference's visualization harness (debug_utils.py
:29-431): per-depth slice renders, fixed-granularity hierarchy renders with
optional per-subtree false colouring, and gaussians-per-limit curves. The
renders run on the state's device; images come back as clipped [3,H,W]
numpy arrays and counts as Python ints.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from hlod_gaussians_torch import render as render_mod
from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.hierarchy import cut as cut_mod
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.models.gaussians import GaussianState


def _render_mask(state: GaussianState, camera, mask, cfg, k_max, bg):
    """The rows of `mask` rendered at the camera -> clipped [3,H,W] numpy."""
    act = gm.activate(state, mask)
    with torch.no_grad():
        out = render_mod.render_arrays(
            act.means3d, act.scales, act.quats, act.opacities, act.shs,
            act.valid, camera.world_view, camera.full_proj, camera.campos,
            camera.tan_fovx, camera.tan_fovy,
            torch.tensor(np.asarray(bg, np.float32), device=state.xyz.device),
            sh_degree=state.sh_degree, width=camera.width,
            height=camera.height, cfg=cfg, k_max=k_max)
    return torch.clamp(out.image, 0, 1).cpu().numpy()


def render_depth_slice(state: GaussianState, camera, depth: int,
                       *, cfg: RasterizerConfig = RasterizerConfig(),
                       k_max: int = 512, bg=(0.0, 0.0, 0.0)):
    """Render the depth-`depth` cut of the hierarchy (reference
    debug_utils.generate_hierarchy_scene_image with expand_to_target).
    Returns (image [3,H,W] numpy, nodes rendered)."""
    mask = cut_mod.expand_to_target(state.nodes, state.alive, depth)
    return (_render_mask(state, camera, mask, cfg, k_max, bg),
            int(mask.sum()))


def false_color_by_subtree(state: GaussianState, roots: Sequence[int]
                           ) -> np.ndarray:
    """Per-Gaussian false colours keyed by which subtree (of `roots`) each
    node belongs to (reference hierarchy_viewer.py SPT colouring). Returns
    [C,3] float colours."""
    nodes = state.nodes.cpu().numpy()
    c = nodes.shape[0]
    owner = np.full(c, -1, np.int64)
    for i, r in enumerate(roots):
        owner[r] = i
    parent = nodes[:, gm.NODE_PARENT]
    for _ in range(64):
        need = (owner < 0) & (parent >= 0)
        if not need.any():
            break
        upd = owner[np.clip(parent, 0, c - 1)]
        owner[need] = upd[need]
    rng = np.random.default_rng(0)
    palette = rng.uniform(0.2, 1.0, (max(len(roots), 1), 3)).astype(np.float32)
    cols = np.full((c, 3), 0.3, np.float32)
    has = owner >= 0
    cols[has] = palette[owner[has] % len(palette)]
    return cols


def path_to_root(state: GaussianState, node: int) -> np.ndarray:
    """Positions along the ancestor chain of `node` up to the root
    (reference debug_utils.plot_path_to_root:68-88, minus the matplotlib
    shell: callers plot the returned [K,3] polyline)."""
    nodes = state.nodes.cpu().numpy()
    xyz = state.xyz.detach().cpu().numpy()
    pts = []
    n = int(node)
    seen = set()
    while n >= 0 and n not in seen:
        seen.add(n)
        pts.append(xyz[n])
        n = int(nodes[n, gm.NODE_PARENT])
    return np.asarray(pts, np.float32)


def render_level_slices(state: GaussianState, camera,
                        *, cfg: RasterizerConfig = RasterizerConfig(),
                        k_max: int = 512, bg=(0.0, 0.0, 0.0),
                        max_levels: int = 64):
    """Bottom-up per-level renders: the leaves, then the set of their
    parents, grandparents, ... up to the root (reference
    debug_utils.render_level_slices:286-314, which walks
    ``nodes[indices, 1].unique()`` a level). Returns a list of
    (image [3,H,W] numpy, n_rendered) from finest to coarsest."""
    nodes = state.nodes.cpu().numpy()
    c = nodes.shape[0]
    parent = nodes[:, gm.NODE_PARENT]
    alive = state.alive.cpu().numpy()
    indices = np.where(alive & (nodes[:, gm.NODE_CHILD_COUNT] == 0)
                       & (nodes[:, gm.NODE_DEPTH] >= 0))[0]
    out = []
    for _ in range(max_levels):
        if len(indices) == 0:
            break
        mask = np.zeros(c, bool)
        mask[indices] = True
        mask = torch.as_tensor(mask, device=state.alive.device)
        out.append((_render_mask(state, camera, mask, cfg, k_max, bg),
                    len(indices)))
        nxt = np.unique(parent[indices])
        indices = nxt[nxt >= 0]
        if len(indices) <= 1 and len(out) > 1:
            break
    return out


def gaussians_per_limit(state: GaussianState, campos, zdir,
                        limits: Sequence[float]) -> List[int]:
    """Cut sizes per granularity limit (reference
    debug_utils.get_gaussians_per_limit_normalized)."""
    act = gm.activate(state)
    max_scale = torch.max(act.scales, dim=-1).values
    campos, zdir = (torch.as_tensor(v, dtype=torch.float32,
                                    device=state.xyz.device)
                    for v in (campos, zdir))
    out = []
    for lim in limits:
        cut = cut_mod.expand_to_size_dynamic(
            state.nodes, act.means3d, max_scale, state.alive, campos, zdir,
            max(lim, 1e-12), use_frustum=False)
        out.append(int(cut.render_mask.sum()))
    return out
