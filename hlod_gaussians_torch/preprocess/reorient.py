"""Automatic scene reorientation + metric rescaling (a copy of
hlod_gaussians_tpu/preprocess/reorient.py).

Re-derivation of the reference's preprocess/auto_reorient.py:20-141: fit a
ground plane to the camera centers by least squares, rotate the scene so the
plane normal becomes +Z (cameras "up"), then scale so the median
camera-to-nearest-point distance hits `target_med_dist` ("roughly metric").
Operates directly on (qvec, tvec) camera extrinsics + the point cloud.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from hlod_gaussians_torch.data import colmap as cm


def fit_plane_least_squares(points: np.ndarray):
    """z = a*x + b*y + c fit -> (unit normal, in-plane vector, centroid)
    (auto_reorient.py:20-41)."""
    A = np.c_[points[:, 0], points[:, 1], np.ones(points.shape[0])]
    B = points[:, 2]
    (a, b, c), _, _, _ = np.linalg.lstsq(A, B, rcond=None)
    normal = np.array([a, b, -1.0])
    normal /= np.linalg.norm(normal)
    in_plane = np.cross(normal, np.array([0.0, 0.0, 1.0]))
    if np.linalg.norm(in_plane) == 0:
        in_plane = np.cross(normal, np.array([0.0, 1.0, 0.0]))
    in_plane /= np.linalg.norm(in_plane)
    return normal, in_plane, points.mean(axis=0)


def reorient_basis(cam_centers: np.ndarray) -> np.ndarray:
    """Rotation matrix aligning the fitted camera ground plane with the
    XY plane (normal -> +Z, flipped toward the majority 'up' of cameras)."""
    normal, in_plane, _ = fit_plane_least_squares(cam_centers)
    # orientation: most cameras should end up above the plane
    above = cam_centers @ normal - np.median(cam_centers @ normal)
    if (above > 0).sum() < (above < 0).sum():
        normal = -normal
    x_axis = in_plane
    z_axis = normal
    y_axis = np.cross(z_axis, x_axis)
    y_axis /= np.linalg.norm(y_axis)
    return np.stack([x_axis, y_axis, z_axis], axis=1)  # world -> new (cols)


def transform_cameras(images: Dict[int, cm.ColmapImage], rot: np.ndarray,
                      upscale: float) -> Dict[int, cm.ColmapImage]:
    """Apply rotation+scale to every camera (auto_reorient.py rotate_camera)."""
    out = {}
    for k, im in images.items():
        R = cm.qvec2rotmat(im.qvec)
        Rt = np.eye(4)
        Rt[:3, :3] = R
        Rt[:3, 3] = im.tvec
        C2W = np.linalg.inv(Rt)
        center = C2W[:3, 3] @ rot
        cam_rot = np.linalg.inv(rot) @ C2W[:3, :3]
        C2W2 = np.eye(4)
        C2W2[:3, 3] = upscale * center
        C2W2[:3, :3] = cam_rot
        W2C = np.linalg.inv(C2W2)
        out[k] = cm.ColmapImage(
            id=im.id, qvec=cm.rotmat2qvec(W2C[:3, :3]), tvec=W2C[:3, 3],
            camera_id=im.camera_id, name=im.name, xys=im.xys,
            point3d_ids=im.point3d_ids)
    return out


def transform_points(xyz: np.ndarray, rot: np.ndarray, upscale: float
                     ) -> np.ndarray:
    return (xyz @ rot) * upscale


def metric_upscale(cam_centers: np.ndarray, points: np.ndarray,
                   target_med_dist: float = 20.0) -> float:
    """Scale so the median camera-to-nearest-point distance equals
    target_med_dist (auto_reorient.py:100-110)."""
    if len(points) == 0 or len(cam_centers) == 0:
        return 1.0
    sub = points[np.random.default_rng(0).choice(
        len(points), min(len(points), 20_000), replace=False)]
    d = np.linalg.norm(cam_centers[:, None, :] - sub[None, :512, :], axis=-1)
    med = float(np.median(d.min(axis=1)))
    return target_med_dist / max(med, 1e-9)


def auto_reorient(cameras: Dict[int, cm.ColmapCamera],
                  images: Dict[int, cm.ColmapImage],
                  points: cm.ColmapPoints,
                  target_med_dist: float = 20.0):
    """Full reorient+rescale pass. Returns (images', points', rot, scale)."""
    centers = []
    for im in images.values():
        R = cm.qvec2rotmat(im.qvec)
        Rt = np.eye(4)
        Rt[:3, :3] = R
        Rt[:3, 3] = im.tvec
        centers.append(np.linalg.inv(Rt)[:3, 3])
    centers = np.stack(centers)

    rot = reorient_basis(centers)
    upscale = metric_upscale(centers @ rot, points.xyz @ rot, target_med_dist)

    new_images = transform_cameras(images, rot, upscale)
    new_xyz = transform_points(points.xyz, rot, upscale)
    new_points = cm.ColmapPoints(new_xyz.astype(np.float32), points.rgb,
                                 points.errors)
    return new_images, new_points, rot, upscale
