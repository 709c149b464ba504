"""Per-image monocular-depth scale/offset fitting (a copy of
hlod_gaussians_tpu/preprocess/depth_scale.py).

Re-derivation of preprocess/make_depth_scale.py:19-75: robust (median /
mean-absolute-deviation) alignment of an inverse monocular depth map against
the inverse depths of the image's SfM points:
    scale  = MAD(inv_colmap) / MAD(inv_mono)
    offset = median(inv_colmap) - median(inv_mono) * scale
so that `inv_mono * scale + offset ~ inv_colmap`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from hlod_gaussians_torch.data import colmap as cm


def _bilinear_sample(img: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Sample img [H,W] at float pixel coords xy [N,2] with edge clamping
    (cv2.remap INTER_LINEAR / BORDER_REPLICATE equivalent)."""
    h, w = img.shape
    x = np.clip(xy[:, 0], 0, w - 1)
    y = np.clip(xy[:, 1], 0, h - 1)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = x - x0
    fy = y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def fit_depth_scale(
    image_meta: cm.ColmapImage,
    camera: cm.ColmapCamera,
    points_xyz: np.ndarray,          # [P,3] indexed by point3D id
    inv_mono_depth: np.ndarray,      # [h,w] inverse monocular depth in [0,1]
) -> Dict[str, float]:
    """One image's (scale, offset); zeros when underdetermined
    (make_depth_scale.py:60-74)."""
    pts_idx = image_meta.point3d_ids
    mask = (pts_idx >= 0) & (pts_idx < len(points_xyz))
    pts_idx = pts_idx[mask]
    xys = image_meta.xys[mask]
    if len(pts_idx) == 0:
        return {"scale": 0.0, "offset": 0.0}

    R = cm.qvec2rotmat(image_meta.qvec)
    pts_cam = points_xyz[pts_idx] @ R.T + image_meta.tvec
    inv_colmap = 1.0 / np.maximum(pts_cam[..., 2], 1e-12)

    s = inv_mono_depth.shape[0] / camera.height
    maps = (xys * s).astype(np.float32)
    valid = ((maps[:, 0] >= 0) & (maps[:, 1] >= 0)
             & (maps[:, 0] < camera.width * s)
             & (maps[:, 1] < camera.height * s)
             & (pts_cam[..., 2] > 0))

    if valid.sum() <= 10 or (inv_colmap[valid].max()
                             - inv_colmap[valid].min()) <= 1e-3:
        return {"scale": 0.0, "offset": 0.0}

    inv_colmap = inv_colmap[valid]
    inv_mono = _bilinear_sample(inv_mono_depth, maps[valid])

    t_colmap = np.median(inv_colmap)
    s_colmap = np.mean(np.abs(inv_colmap - t_colmap))
    t_mono = np.median(inv_mono)
    s_mono = np.mean(np.abs(inv_mono - t_mono))
    if s_mono <= 1e-12:
        return {"scale": 0.0, "offset": 0.0}
    scale = float(s_colmap / s_mono)
    offset = float(t_colmap - t_mono * scale)
    return {"scale": scale, "offset": offset}
