"""Align a fresh COLMAP solve to a prior model's frame (known-pose flow).

A copy of hlod_gaussians_tpu/preprocess/transform.py, the equivalent of
the reference's
``preprocess/transform_colmap.py``: trimmed Procrustes (sim3) on matched
camera centers, applied to the new model's cameras and points, with the
reference's point-quality filter (error < 1.5, >3 observing images).
Pure numpy — the reference's torch SVD is replaced by numpy's (computed
in float64, as the reference comments demand for precision).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, NamedTuple, Tuple

import numpy as np

from hlod_gaussians_torch.data import colmap as cm


class Sim3(NamedTuple):
    t0: np.ndarray   # [3] target centroid
    t1: np.ndarray   # [3] source centroid
    s0: float        # target scale
    s1: float        # source scale
    R: np.ndarray    # [3,3] source->target rotation


def procrustes(x0: np.ndarray, x1: np.ndarray) -> Sim3:
    """Similarity transform aligning x1 to x0 (both [N,3];
    transform_colmap.py:24-44)."""
    t0 = x0.mean(axis=0)
    t1 = x1.mean(axis=0)
    x0c = x0 - t0
    x1c = x1 - t1
    s0 = float(np.sqrt((x0c ** 2).sum(-1).mean()))
    s1 = float(np.sqrt((x1c ** 2).sum(-1).mean()))
    u, _, vt = np.linalg.svd(
        (x0c / s0).T.astype(np.float64) @ (x1c / s1).astype(np.float64))
    r = (u @ vt).astype(np.float64)
    if np.linalg.det(r) < 0:
        r[2] *= -1
    return Sim3(t0, t1, s0, s1, r.astype(np.float32))


def apply_sim3(sim3: Sim3, x: np.ndarray) -> np.ndarray:
    """x1-frame points -> x0 frame: (x - t1)/s1 @ R.T * s0 + t0."""
    return ((x - sim3.t1) / sim3.s1) @ sim3.R.T * sim3.s0 + sim3.t0


def align_models(old_images: Dict[int, cm.ColmapImage],
                 new_images: Dict[int, cm.ColmapImage],
                 outlier_mult: float = 5.0
                 ) -> Tuple[Sim3, np.ndarray, np.ndarray]:
    """Trimmed sim3 from matched (by name) camera centers. Returns
    (sim3, valid_cams mask over new_images order, aligned centers)."""
    old_by_name = {im.name: im for im in old_images.values()}
    keys = list(new_images.keys())
    old_centers = np.array([
        -cm.qvec2rotmat(old_by_name[new_images[k].name].qvec).T
        @ old_by_name[new_images[k].name].tvec for k in keys])
    new_centers = np.array([
        -cm.qvec2rotmat(new_images[k].qvec).T @ new_images[k].tvec
        for k in keys])
    dists = np.linalg.norm(old_centers - new_centers, axis=-1)
    valid = dists <= (np.median(dists) * outlier_mult) + 1e-8
    sim3 = procrustes(old_centers[valid], new_centers[valid])
    aligned = apply_sim3(sim3, new_centers)
    return sim3, valid, aligned


def transform_colmap(in_dir: str, new_colmap_dir: str, out_dir: str,
                     max_error: float = 1.5, min_images: int = 3) -> Sim3:
    """Reference transform_colmap.py main flow: read old+new sparse models,
    align, filter points (error < max_error, track > min_images), write
    the aligned model under out_dir/sparse/0 and copy center/extent."""
    old_images = cm.read_images_bin(
        os.path.join(in_dir, "sparse/0/images.bin"))
    new_images = cm.read_images_bin(
        os.path.join(new_colmap_dir, "sparse/0/images.bin"),
        load_points=True)
    sim3, valid_cams, centers_aligned = align_models(old_images, new_images)

    pts = cm.read_points3d_bin_full(
        os.path.join(new_colmap_dir, "sparse/0/points3D.bin"))
    keep = (pts.errors < max_error) & (pts.track_lens > min_images)
    pts_aligned = cm.ColmapPointsFull(
        ids=pts.ids[keep],
        xyz=apply_sim3(sim3, pts.xyz[keep]).astype(np.float32),
        rgb=pts.rgb[keep], errors=pts.errors[keep],
        track_lens=np.zeros(int(keep.sum()), np.int64))

    out_sparse = os.path.join(out_dir, "sparse/0")
    os.makedirs(out_sparse, exist_ok=True)
    images_out = {}
    for k, ok, center in zip(new_images, valid_cams, centers_aligned):
        if not ok:
            continue
        im = new_images[k]
        r_aligned = cm.qvec2rotmat(im.qvec) @ sim3.R.T
        t_aligned = -r_aligned @ center
        images_out[k] = cm.ColmapImage(
            im.id, cm.rotmat2qvec(r_aligned), t_aligned, im.camera_id,
            im.name, im.xys, im.point3d_ids)
    cm.write_images_bin(os.path.join(out_sparse, "images.bin"), images_out)
    cm.write_points3d_bin_full(
        os.path.join(out_sparse, "points3D.bin"), pts_aligned)
    shutil.copy(os.path.join(new_colmap_dir, "sparse/0/cameras.bin"),
                os.path.join(out_sparse, "cameras.bin"))
    for aux in ("center.txt", "extent.txt"):
        src = os.path.join(in_dir, aux)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_dir, aux))
    return sim3
