"""Sparse-model simplification: drop isolated / pointless images.

A copy of hlod_gaussians_tpu/preprocess/simplify.py, the equivalent of
the reference's
``preprocess/simplify_images.py``: remove images whose camera sits
further than ``mult_min_dist x median`` from its nearest neighbor or that
observe no valid 3D points, and strip invalid (-1) point2D observations
from the survivors. Pure numpy (a brute-force [N,N] camera-distance
matrix — thousands of cameras — replaces sklearn's NearestNeighbors).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from hlod_gaussians_torch.data import colmap as cm


def camera_centers(images: Dict[int, cm.ColmapImage]) -> np.ndarray:
    return np.array([
        -cm.qvec2rotmat(im.qvec).T @ im.tvec for im in images.values()])


def simplify_images(images: Dict[int, cm.ColmapImage],
                    mult_min_dist: float = 10.0
                    ) -> Dict[int, cm.ColmapImage]:
    """Filter per reference simplify_images.py:36-77."""
    if not images:
        return {}
    keys = list(images.keys())
    centers = camera_centers(images)
    if len(keys) >= 2:
        d2 = ((centers[:, None] - centers[None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        nn = np.sqrt(d2.min(axis=1))
        med = float(np.median(nn))
    else:
        nn = np.zeros(len(keys))
        med = 0.0

    out = {}
    for key, dist in zip(keys, nn):
        im = images[key]
        if im.point3d_ids.shape[0] == 0 or dist > mult_min_dist * med:
            continue
        valid = im.point3d_ids >= 0
        if valid.sum() == 0:
            continue
        out[key] = cm.ColmapImage(im.id, im.qvec, im.tvec, im.camera_id,
                                  im.name, im.xys[valid],
                                  im.point3d_ids[valid])
    return out


def simplify_images_file(base_dir: str, mult_min_dist: float = 10.0,
                         model_type: str = "bin") -> int:
    """Rewrite images.{bin,txt} in place (original renamed images_heavy.*,
    like the reference). Returns the surviving image count."""
    path = os.path.join(base_dir, f"images.{model_type}")
    if model_type == "bin":
        images = cm.read_images_bin(path, load_points=True)
    else:
        images = cm.read_images_txt(path)
    filtered = simplify_images(images, mult_min_dist)
    heavy = os.path.join(base_dir, f"images_heavy.{model_type}")
    if os.path.exists(heavy):
        os.remove(heavy)
    os.rename(path, heavy)
    if model_type == "bin":
        cm.write_images_bin(path, filtered)
    else:
        raise NotImplementedError("txt write-back not supported; use bin")
    return len(filtered)
