"""Scene chunking: split an aligned reconstruction into spatial cubes (port
of hlod_gaussians_tpu/pipeline/chunking.py; reference preprocessing chunker
preprocess/make_chunk.py:35-184 + generate_chunks.py:70-83).

The aligned scene is cut into `chunk_size` cubes; each chunk keeps the
cameras whose position lies in the padded chunk box plus the SfM points
inside an extended bounding box, with per-chunk acceptance thresholds on
camera and point count. An offline host step: numpy throughout, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np

from hlod_gaussians_torch.data.scene import CameraInfo, SceneInfo


@dataclasses.dataclass(frozen=True)
class Chunk:
    index: tuple                 # (i, j) grid coordinates
    center: np.ndarray           # [3]
    extent: np.ndarray           # [3] box side lengths
    cameras: List[CameraInfo]
    point_mask: np.ndarray       # [N] bool over the scene points


def camera_centers(cams: Sequence[CameraInfo]) -> np.ndarray:
    """[V,3] camera centers from each camera's (R, T)."""
    out = []
    for c in cams:
        w2c = np.eye(4)
        w2c[:3, :3] = c.R.T
        w2c[:3, 3] = c.T
        out.append(np.linalg.inv(w2c)[:3, 3])
    return np.stack(out) if out else np.zeros((0, 3))


def make_chunks(
    scene: SceneInfo,
    chunk_size: float = 100.0,
    padding: float = 0.2,
    min_n_cams: int = 20,
    max_n_cams: int = 1500,
    point_padding: float = 2.0,
    min_points: int = 100,
) -> List[Chunk]:
    """Cut the scene into ground-plane-aligned cubes (the x/y grid of the
    aligned frame; the reference's x/z grid in its reoriented frame).

    A chunk is kept when it has >= min_n_cams cameras and >= min_points
    points (make_chunk.py:120-184); above max_n_cams its cameras are
    subsampled evenly."""
    centers = camera_centers(scene.train_cameras)
    pts = scene.points
    if len(centers) == 0:
        return []

    lo = centers.min(axis=0) - 1e-6
    hi = centers.max(axis=0) + 1e-6
    n_i = max(1, int(np.ceil((hi[0] - lo[0]) / chunk_size)))
    n_j = max(1, int(np.ceil((hi[1] - lo[1]) / chunk_size)))

    chunks = []
    for i in range(n_i):
        for j in range(n_j):
            c_lo = lo[:2] + np.array([i, j]) * chunk_size
            c_hi = c_lo + chunk_size
            center = np.array([*(0.5 * (c_lo + c_hi)),
                               0.5 * (centers[:, 2].min() + centers[:, 2].max())],
                              np.float32)

            pad = padding * chunk_size
            in_box = ((centers[:, 0] >= c_lo[0] - pad)
                      & (centers[:, 0] < c_hi[0] + pad)
                      & (centers[:, 1] >= c_lo[1] - pad)
                      & (centers[:, 1] < c_hi[1] + pad))
            cams = [scene.train_cameras[k] for k in np.where(in_box)[0]]
            if len(cams) < min_n_cams:
                continue
            if len(cams) > max_n_cams:
                keep = np.linspace(0, len(cams) - 1, max_n_cams).astype(int)
                cams = [cams[k] for k in keep]

            ppad = point_padding * chunk_size
            pmask = ((pts[:, 0] >= c_lo[0] - ppad) & (pts[:, 0] < c_hi[0] + ppad)
                     & (pts[:, 1] >= c_lo[1] - ppad) & (pts[:, 1] < c_hi[1] + ppad))
            if pmask.sum() < min_points:
                continue

            chunks.append(Chunk(
                index=(i, j), center=center,
                extent=np.array([chunk_size * (1 + 2 * padding)] * 3, np.float32),
                cameras=cams, point_mask=pmask))
    return chunks


def save_chunk_meta(path: str, chunk: Chunk) -> None:
    """center.txt / extent.txt as the reference merger reads them
    (mainHierarchyMerger.cpp:95-101)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "center.txt"), "w") as f:
        f.write(" ".join(str(float(v)) for v in chunk.center))
    with open(os.path.join(path, "extent.txt"), "w") as f:
        f.write(" ".join(str(float(v)) for v in chunk.extent))


def load_chunk_centers(chunk_dirs: Sequence[str]) -> np.ndarray:
    """[K,3] float32 centers from each directory's center.txt."""
    out = []
    for d in chunk_dirs:
        with open(os.path.join(d, "center.txt")) as f:
            out.append([float(x) for x in f.read().split()[:3]])
    return np.asarray(out, np.float32)
