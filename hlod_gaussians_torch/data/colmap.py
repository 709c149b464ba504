"""COLMAP sparse-reconstruction IO, binary and text (a copy of
hlod_gaussians_tpu/data/colmap.py, numpy only; reference
scene/colmap_loader.py:43-292, preprocess/read_write_model.py): cameras,
images (extrinsics) and points3D. The writers write the same bytes as the
JAX package's.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: (mid, np_) for mid, (name, np_) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray     # [4] (w,x,y,z) world->cam rotation
    tvec: np.ndarray     # [3]
    camera_id: int
    name: str
    xys: np.ndarray      # [M,2]
    point3d_ids: np.ndarray  # [M]


class ColmapPoints(NamedTuple):
    xyz: np.ndarray      # [N,3]
    rgb: np.ndarray      # [N,3] uint8
    errors: np.ndarray   # [N]


class ColmapPointsFull(NamedTuple):
    """Columnar points WITH ids and track lengths (needed by the known-pose
    alignment, reference preprocess/transform_colmap.py:96-112)."""
    ids: np.ndarray        # [N] int64 point3D ids
    xyz: np.ndarray        # [N,3]
    rgb: np.ndarray        # [N,3] uint8
    errors: np.ndarray     # [N]
    track_lens: np.ndarray  # [N] int64 — number of observing images


def qvec2rotmat(qvec):
    """COLMAP (w,x,y,z) quaternion -> rotation matrix
    (scene/colmap_loader.py:31-41)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R):
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0] + (q[0] == 0))


def read_cameras_bin(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = CAMERA_MODELS[mid]
            params = np.array(struct.unpack(f"<{n_params}d",
                                            f.read(8 * n_params)))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_bin(path, load_points: bool = False) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            (cam_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = struct.unpack("<Q", f.read(8))
            blob = f.read(24 * n2d)
            if load_points:
                arr = np.frombuffer(blob, dtype="<f8").reshape(n2d, 3)
                xys = arr[:, :2].astype(np.float64)
                ids = np.frombuffer(blob, dtype="<i8").reshape(n2d, 3)[:, 2]
            else:
                xys = np.zeros((0, 2))
                ids = np.zeros((0,), np.int64)
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                   name.decode("utf-8"), xys, ids)
    return out


def read_points3d_bin(path) -> ColmapPoints:
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty((num,))
        for i in range(num):
            data = struct.unpack("<QdddBBBd", f.read(43))
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.seek(8 * track_len, os.SEEK_CUR)
    return ColmapPoints(xyz.astype(np.float32), rgb, err.astype(np.float32))


def read_points3d_bin_full(path) -> ColmapPointsFull:
    """Like read_points3d_bin but keeps ids and track lengths."""
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        ids = np.empty((num,), np.int64)
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty((num,))
        tl = np.empty((num,), np.int64)
        for i in range(num):
            data = struct.unpack("<QdddBBBd", f.read(43))
            ids[i] = data[0]
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = struct.unpack("<Q", f.read(8))
            tl[i] = track_len
            f.seek(8 * track_len, os.SEEK_CUR)
    return ColmapPointsFull(ids, xyz.astype(np.float32), rgb,
                            err.astype(np.float32), tl)


def write_points3d_bin_full(path, pts: ColmapPointsFull):
    """Write points keeping their original ids; track_lens are preserved as
    zero-stub (image_id 0) track entries so the track LENGTH round-trips
    (the alignment output zeroes them, like the reference's
    transform_colmap.py:160-172 which writes empty image_ids)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", pts.xyz.shape[0]))
        for i in range(pts.xyz.shape[0]):
            f.write(struct.pack("<QdddBBBd", int(pts.ids[i]),
                                *pts.xyz[i].astype(float),
                                *[int(v) for v in pts.rgb[i]],
                                float(pts.errors[i])))
            tl = int(pts.track_lens[i])
            f.write(struct.pack("<Q", tl))
            if tl:
                f.write(b"\x00" * (8 * tl))


def read_cameras_txt(path) -> Dict[int, ColmapCamera]:
    out = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        t = line.split()
        cid = int(t[0])
        out[cid] = ColmapCamera(cid, t[1], int(t[2]), int(t[3]),
                                np.array([float(x) for x in t[4:]]))
    return out


def read_images_txt(path) -> Dict[int, ColmapImage]:
    """Every image is an IMAGE line followed by a POINTS2D line that may
    legally be EMPTY (zero observations) — so the pairing must alternate
    over raw lines like the reference read_extrinsics_text, not stride
    over a blank-filtered list (which would drop/misparse images)."""
    out = {}
    expect_points = False
    for raw in open(path):
        line = raw.strip()
        if line.startswith("#"):
            continue
        if expect_points:            # POINTS2D line (possibly empty)
            expect_points = False
            continue
        if not line:
            continue
        t = line.split()
        iid = int(t[0])
        qvec = np.array([float(x) for x in t[1:5]])
        tvec = np.array([float(x) for x in t[5:8]])
        out[iid] = ColmapImage(iid, qvec, tvec, int(t[8]), t[9],
                               np.zeros((0, 2)), np.zeros((0,), np.int64))
        expect_points = True
    return out


def read_points3d_txt(path) -> ColmapPoints:
    xyz, rgb, err = [], [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        t = line.split()
        xyz.append([float(x) for x in t[1:4]])
        rgb.append([int(x) for x in t[4:7]])
        err.append(float(t[7]))
    return ColmapPoints(np.array(xyz, np.float32),
                        np.array(rgb, np.uint8), np.array(err, np.float32))


def write_cameras_bin(path, cams: Dict[int, ColmapCamera]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            mid, n_params = MODEL_IDS[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack(f"<{n_params}d", *c.params))


def write_images_bin(path, images: Dict[int, ColmapImage]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = im.xys.shape[0]
            f.write(struct.pack("<Q", n))
            for j in range(n):
                f.write(struct.pack("<ddq", im.xys[j, 0], im.xys[j, 1],
                                    int(im.point3d_ids[j])))


def write_points3d_bin(path, pts: ColmapPoints):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", pts.xyz.shape[0]))
        for i in range(pts.xyz.shape[0]):
            f.write(struct.pack("<QdddBBBd", i, *pts.xyz[i].astype(float),
                                *[int(v) for v in pts.rgb[i]],
                                float(pts.errors[i])))
            f.write(struct.pack("<Q", 0))


def read_model(sparse_dir: str):
    """(cameras, images, points) from a COLMAP sparse dir (bin preferred)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
        pts_f = os.path.join(sparse_dir, "points3D.bin")
        pts = read_points3d_bin(pts_f) if os.path.exists(pts_f) else None
    else:
        cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_txt(os.path.join(sparse_dir, "images.txt"))
        pts_f = os.path.join(sparse_dir, "points3D.txt")
        pts = read_points3d_txt(pts_f) if os.path.exists(pts_f) else None
    return cams, imgs, pts


def focal2fov(focal, pixels):
    return 2 * np.arctan(pixels / (2 * focal))


def camera_intrinsics(cam: ColmapCamera):
    """(fovx, fovy, primx, primy) from a COLMAP camera
    (scene/dataset_readers.py:129-147)."""
    if cam.model == "SIMPLE_PINHOLE":
        fx = fy = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    elif cam.model == "PINHOLE":
        fx, fy, cx, cy = cam.params[:4]
    else:
        # distorted models (SIMPLE_RADIAL/OPENCV/...) must be undistorted
        # first — silently dropping the distortion coefficients shifts
        # reprojections by many pixels at the borders (the reference
        # asserts the same, dataset_readers.py:129-147)
        raise ValueError(
            f"unsupported camera model {cam.model}: undistort the "
            "reconstruction (colmap image_undistorter) to PINHOLE first")
    return (focal2fov(fx, cam.width), focal2fov(fy, cam.height),
            cx / cam.width, cy / cam.height)
