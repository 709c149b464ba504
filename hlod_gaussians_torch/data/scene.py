"""Scene loading: COLMAP reconstruction -> cameras + initial point cloud
(port of hlod_gaussians_tpu/data/scene.py; reference
scene/dataset_readers.py:181-270, scene/__init__.py:26-124,
utils/camera_utils.py).

Lazy per-view image loading, train/test split via test.txt or every-8th /
default eval holdout, NeRF++-style scene extent. Everything up to
`load_view` is numpy; `load_view` returns this package's `Camera` with its
tensors on the requested device. PIL is imported only where an image is
read, so importing this module does not need it.
"""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from hlod_gaussians_torch.data import colmap as cm
from hlod_gaussians_torch.data import ply as ply_io
from hlod_gaussians_torch.utils.camera import Camera, make_camera


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray           # cam-to-world rotation (qvec2rotmat(q).T)
    T: np.ndarray           # world-to-cam translation
    fovx: float
    fovy: float
    primx: float
    primy: float
    width: int
    height: int
    image_path: str
    image_name: str
    depth_path: str = ""
    depth_params: Optional[dict] = None
    alpha_path: str = ""
    is_test: bool = False


class SceneInfo(NamedTuple):
    points: np.ndarray        # [N,3]
    colors: np.ndarray        # [N,3] in [0,1]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    extent: float             # nerf++ norm radius
    center: np.ndarray        # translate applied (negated camera centroid)


def nerfpp_norm(cam_infos: Sequence[CameraInfo]):
    """Scene extent = 1.1 x max distance from the average camera center
    (reference getNerfppNorm, scene/dataset_readers.py:52-73)."""
    centers = []
    for c in cam_infos:
        w2c = np.eye(4)
        w2c[:3, :3] = c.R.T
        w2c[:3, 3] = c.T
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers)
    avg = centers.mean(axis=0)
    # 0.9 quantile, not max: one outlier camera must not inflate the
    # extent (reference getNerfppNorm, dataset_readers.py:52-73)
    dist = np.linalg.norm(centers - avg, axis=-1)
    radius = float(np.quantile(dist, 0.9) * 1.1)
    return radius, -avg


def load_colmap_scene(
    source_path: str,
    images_dir: str = "images",
    depths_dir: str = "",
    alpha_masks_dir: str = "",
    eval_split: bool = False,
    test_hold: int = 8,
    sparse_subdir: str = "sparse/0",
    train_test_exp: bool = False,
) -> SceneInfo:
    """readColmapSceneInfo equivalent (scene/dataset_readers.py:181-270).

    ``train_test_exp`` keeps test views in the TRAIN list too (flagged
    is_test so load_view can half-mask them), matching
    dataset_readers.py:258 — per-image exposures then train on the
    visible half of every view."""
    sparse = os.path.join(source_path, sparse_subdir)
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_path, "sparse")
    cams, images, pts = cm.read_model(sparse)

    # per-image monocular-depth scale/offset fits written by
    # make_depth_scale (reference readColmapSceneInfo reads
    # sparse/0/depth_params.json, dataset_readers.py:195-218)
    depth_params_all = None
    dp_path = os.path.join(sparse, "depth_params.json")
    if depths_dir and os.path.exists(dp_path):
        with open(dp_path) as f:
            depth_params_all = json.load(f)
        # med_scale — the dataset-wide reliability anchor: median of the
        # positive per-image scale fits (reference dataset_readers.py:195-206)
        all_scales = np.array(
            [v["scale"] for v in depth_params_all.values() if "scale" in v],
            dtype=np.float64)
        med_scale = (float(np.median(all_scales[all_scales > 0]))
                     if (all_scales > 0).any() else 0.0)
        for v in depth_params_all.values():
            v["med_scale"] = med_scale

    infos = []
    for iid in sorted(images, key=lambda i: images[i].name):
        im = images[iid]
        cam = cams[im.camera_id]
        fovx, fovy, primx, primy = cm.camera_intrinsics(cam)
        R = cm.qvec2rotmat(im.qvec).T
        name = os.path.splitext(im.name)[0]
        depth_path = (os.path.join(source_path, depths_dir, name + ".png")
                      if depths_dir else "")
        dp = depth_params_all.get(name) if depth_params_all else None
        alpha_path = (os.path.join(source_path, alpha_masks_dir,
                                   name + ".png")
                      if alpha_masks_dir else "")
        infos.append(CameraInfo(
            uid=iid, R=R, T=im.tvec.astype(np.float64),
            fovx=float(fovx), fovy=float(fovy),
            primx=float(primx), primy=float(primy),
            width=cam.width, height=cam.height,
            image_path=os.path.join(source_path, images_dir, im.name),
            image_name=name, depth_path=depth_path, alpha_path=alpha_path,
            depth_params=dp))

    # split: test.txt (one image name per line) or every test_hold-th
    test_file = os.path.join(source_path, "test.txt")
    if os.path.exists(test_file):
        with open(test_file) as f:
            test_names = {line.strip() for line in f if line.strip()}
        train = [c for c in infos if c.image_name not in test_names
                 and os.path.basename(c.image_path) not in test_names]
        test = [c for c in infos if c.image_name in test_names
                or os.path.basename(c.image_path) in test_names]
    elif eval_split:
        train = [c for i, c in enumerate(infos) if i % test_hold != 0]
        test = [c for i, c in enumerate(infos) if i % test_hold == 0]
    else:
        train, test = infos, []
    test = [c._replace(is_test=True) for c in test]
    if train_test_exp:
        train = train + test

    # extent from TRAIN cameras only (the reference computes getNerfppNorm
    # on train_cam_infos; test cameras must not affect densification
    # thresholds / lr scaling)
    extent, center = nerfpp_norm(train if train else infos)

    if pts is not None:
        points = pts.xyz
        colors = pts.rgb.astype(np.float32) / 255.0
    else:
        ply_path = os.path.join(sparse, "points3D.ply")
        if os.path.exists(ply_path):
            points, colors = ply_io.load_points_ply(ply_path)
        else:
            points = np.zeros((0, 3), np.float32)
            colors = np.zeros((0, 3), np.float32)

    return SceneInfo(points=points, colors=colors, train_cameras=train,
                     test_cameras=test, extent=extent, center=center)


def _downscale(img: np.ndarray, resolution_scale: float, max_width: int = 1600):
    """Resolution policy of the reference loadCam (utils/camera_utils.py:19-70):
    the 1600-px cap COMPOSES with the requested scale
    (global_down * resolution_scale), and output stays float [0, 1]."""
    h, w = img.shape[:2]
    scale = resolution_scale
    if max_width > 0 and w > max_width:
        scale = (w / max_width) * resolution_scale
    if scale == 1.0:
        return img
    from PIL import Image
    was_float = img.dtype != np.uint8
    im = Image.fromarray((img * 255).astype(np.uint8) if was_float else img)
    nw, nh = round(w / scale), round(h / scale)
    out = np.asarray(im.resize((nw, nh), Image.BILINEAR))
    # keep the caller's [0, 1] float convention (a uint8 return silently
    # made downscaled ground truth 255x too bright)
    return out.astype(np.float32) / 255.0 if was_float else out


def load_view(info: CameraInfo, resolution_scale: float = 1.0,
              max_width: int = 1600, exposure_idx: int = 0,
              train_test_exp: bool = False,
              is_test_dataset: bool = False,
              device=torch.device("cuda")) -> Camera:
    """Load one training view into a Camera on `device` (reference loadCam).

    With ``train_test_exp`` a test view trains on HALF the image only
    (reference cameras.py:63-67): the left half is masked out for the
    test dataset, the right half for train — so exposure fitting sees the
    view without leaking the evaluated half."""
    from PIL import Image

    img = np.asarray(Image.open(info.image_path).convert("RGB"),
                     dtype=np.float32) / 255.0
    img = _downscale(img, resolution_scale, max_width)
    h, w = img.shape[:2]
    chw = np.transpose(img, (2, 0, 1)).astype(np.float32)

    alpha = None
    if info.alpha_path and os.path.exists(info.alpha_path):
        a = np.asarray(Image.open(info.alpha_path).convert("L"),
                       dtype=np.float32) / 255.0
        if a.shape != (h, w):
            im = Image.fromarray(a)
            a = np.asarray(im.resize((w, h), Image.BILINEAR))
        alpha = a[None].astype(np.float32)
    if train_test_exp and info.is_test:
        if alpha is None:
            alpha = np.ones((1, h, w), np.float32)
        else:
            alpha = alpha.copy()
        if is_test_dataset:
            alpha[..., : w // 2] = 0.0
        else:
            alpha[..., w // 2:] = 0.0

    invdepth = None
    depth_mask = None
    dp = info.depth_params or {}
    if (info.depth_path and os.path.exists(info.depth_path)
            and float(dp.get("scale", 1.0)) > 0):
        d = np.asarray(Image.open(info.depth_path), dtype=np.float32)
        if d.ndim == 3:
            d = d[..., 0]
        # reference first normalizes the 16-bit PNG by 2^16, THEN applies
        # the per-image scale/offset fit (cameras.py:78-94 +
        # camera_utils.py): raw-value application was ~65536x off
        inv = d / float(1 << 16)
        inv = inv * float(dp.get("scale", 1.0)) + float(dp.get("offset", 0.0))
        inv = np.maximum(inv, 0.0)
        if inv.shape != (h, w):
            im = Image.fromarray(inv)
            inv = np.asarray(im.resize((w, h), Image.NEAREST))
        invdepth = inv[None].astype(np.float32)
        # depth reliability (reference cameras.py:85-94): start from the
        # alpha mask (folded in) or ones, then ZERO the whole mask when the
        # per-image scale fit strays outside [0.2, 5] x med_scale — on noisy
        # mono-depth this is what keeps depth regularization from hurting
        depth_mask = (alpha.copy() if alpha is not None
                      else np.ones_like(invdepth))
        scale = float(dp.get("scale", 1.0))
        med_scale = float(dp.get("med_scale", 0.0))
        if med_scale > 0 and not (0.2 * med_scale <= scale <= 5 * med_scale):
            depth_mask = depth_mask * 0.0

    return make_camera(info.R, info.T, info.fovx, info.fovy, w, h,
                       primx=info.primx, primy=info.primy,
                       image=chw, alpha_mask=alpha, invdepth=invdepth,
                       depth_mask=depth_mask, exposure_idx=exposure_idx,
                       device=device)
