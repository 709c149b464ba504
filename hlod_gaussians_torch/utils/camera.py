"""Camera model and view/projection matrices (port of
hlod_gaussians_tpu/utils/camera.py:25-121).

Same conventions as the reference: a row-vector world-to-view matrix
(p_view = p_world @ M), the principal-point-aware perspective projection of
getProjectionMatrix, and full_proj = world_view @ proj. The matrices are
built in numpy exactly as the JAX package builds them and then moved to the
requested device as float32 tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """COLMAP-style (R, t) -> row-vector world-to-view 4x4 (float32 numpy).

    R is the camera-to-world rotation, t the world-to-camera translation.
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    return Rt.T.astype(np.float32).copy()


def projection_matrix(znear, zfar, fovx, fovy,
                      primx: float = 0.5, primy: float = 0.5) -> np.ndarray:
    """Row-vector perspective projection (reference getProjectionMatrix);
    primx/primy are the normalized principal point (0.5 = centered)."""
    tan_half_y = math.tan(fovy / 2)
    tan_half_x = math.tan(fovx / 2)
    top = tan_half_y * znear
    bottom = (1 - primy) * 2 * -top
    top = primy * 2 * top
    right = tan_half_x * znear
    left = (1 - primx) * 2 * -right
    right = primx * 2 * right

    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P.T.copy()


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single view (reference scene/cameras.py:31-107)."""

    width: int
    height: int
    world_view: torch.Tensor = None      # [4,4] row-vector W2V
    full_proj: torch.Tensor = None       # [4,4] row-vector W2V @ proj
    campos: torch.Tensor = None          # [3]
    tan_fovx: torch.Tensor = None        # 0-d float32
    tan_fovy: torch.Tensor = None        # 0-d float32
    image: Optional[torch.Tensor] = None       # [3,H,W] ground truth
    alpha_mask: Optional[torch.Tensor] = None  # [1,H,W]
    invdepth: Optional[torch.Tensor] = None    # [1,H,W]
    depth_mask: Optional[torch.Tensor] = None  # [1,H,W]
    exposure_idx: int = 0

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tan_fovy)


def make_camera(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                width: int, height: int, znear: float = 0.01,
                zfar: float = 100.0, primx: float = 0.5, primy: float = 0.5,
                image=None, alpha_mask=None, invdepth=None, depth_mask=None,
                exposure_idx: int = 0,
                device=torch.device("cuda")) -> Camera:
    wv = world_to_view(R, t)
    proj = projection_matrix(znear, zfar, fovx, fovy, primx, primy)
    full = (wv @ proj).astype(np.float32)
    cam_center = np.linalg.inv(wv)[3, :3]

    def dev(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=device)

    return Camera(
        width=int(width), height=int(height),
        world_view=dev(wv), full_proj=dev(full),
        campos=dev(cam_center.astype(np.float32)),
        tan_fovx=dev(np.float32(math.tan(fovx / 2))),
        tan_fovy=dev(np.float32(math.tan(fovy / 2))),
        image=dev(image), alpha_mask=dev(alpha_mask),
        invdepth=dev(invdepth), depth_mask=dev(depth_mask),
        exposure_idx=int(exposure_idx),
    )
