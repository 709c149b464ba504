"""Hierarchy post-optimization (port of hlod_gaussians_tpu/train/post.py).

Only `create_from_dhier` (post.py:40-110) is ported in this slice: it turns
a loaded `.dhier` into the capacity-padded state the LOD render serves.
"""

from __future__ import annotations

import numpy as np
import torch

from hlod_gaussians_torch.data.dhier import DHier
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.ops import sh as sh_ops


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
