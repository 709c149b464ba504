"""3DGS PLY point-cloud IO, numpy only, no plyfile dependency (a copy of
hlod_gaussians_tpu/data/ply.py; the files are byte for byte the JAX
package's).

The reference's layout (scene/gaussian_model.py:1188-1212 save_ply /
:950-983 load_ply_file): binary little-endian PLY with properties
x y z nx ny nz f_dc_0..2 f_rest_0..K opacity scale_0..2 rot_0..3, where
f_rest is stored CHANNEL-major ((K,3) transposed to (3,K) then flattened) —
the quirk inherited from upstream 3DGS.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class GaussianPly(NamedTuple):
    xyz: np.ndarray           # [N,3] f32
    f_dc: np.ndarray          # [N,1,3]
    f_rest: np.ndarray        # [N,K,3]
    opacity: np.ndarray       # [N] raw logits
    log_scale: np.ndarray     # [N,3]
    quat: np.ndarray          # [N,4] (w,x,y,z)


def _rest_coeffs(sh_degree: int) -> int:
    return (sh_degree + 1) ** 2 - 1


def save_gaussian_ply(path: str, g: GaussianPly) -> None:
    n = g.xyz.shape[0]
    k = g.f_rest.shape[1]
    props = ["x", "y", "z", "nx", "ny", "nz"]
    props += [f"f_dc_{i}" for i in range(3)]
    props += [f"f_rest_{i}" for i in range(3 * k)]
    props += ["opacity"] + [f"scale_{i}" for i in range(3)] \
        + [f"rot_{i}" for i in range(4)]

    header = "ply\nformat binary_little_endian 1.0\n"
    header += f"element vertex {n}\n"
    header += "".join(f"property float {p}\n" for p in props)
    header += "end_header\n"

    f_dc = g.f_dc.reshape(n, 3)
    # channel-major f_rest flattening (gaussian_model.py:1199)
    f_rest = np.transpose(g.f_rest, (0, 2, 1)).reshape(n, 3 * k)
    data = np.concatenate([
        g.xyz, np.zeros((n, 3), np.float32), f_dc, f_rest,
        g.opacity.reshape(n, 1), g.log_scale, g.quat], axis=1
    ).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())


def load_gaussian_ply(path: str) -> GaussianPly:
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.find(b"end_header\n")
    if end < 0:
        raise ValueError("not a PLY file")
    header = raw[:end].decode("ascii").splitlines()
    body = raw[end + len(b"end_header\n"):]

    n = None
    props = []
    fmt = None
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element" and t[1] == "vertex":
            n = int(t[2])
        elif t[0] == "property" and len(t) == 3:
            props.append(t[2])
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")

    arr = np.frombuffer(body, dtype="<f4",
                        count=n * len(props)).reshape(n, len(props))
    col = {p: i for i, p in enumerate(props)}

    xyz = arr[:, [col["x"], col["y"], col["z"]]]
    f_dc = arr[:, [col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]]][:, None, :]
    rest_cols = sorted([p for p in props if p.startswith("f_rest_")],
                       key=lambda p: int(p.split("_")[-1]))
    k3 = len(rest_cols)
    k = k3 // 3
    if k3:
        f_rest = arr[:, [col[p] for p in rest_cols]].reshape(n, 3, k)
        f_rest = np.transpose(f_rest, (0, 2, 1))
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    opacity = arr[:, col["opacity"]]
    log_scale = arr[:, [col["scale_0"], col["scale_1"], col["scale_2"]]]
    quat = arr[:, [col["rot_0"], col["rot_1"], col["rot_2"], col["rot_3"]]]
    return GaussianPly(xyz=np.ascontiguousarray(xyz),
                       f_dc=np.ascontiguousarray(f_dc),
                       f_rest=np.ascontiguousarray(f_rest),
                       opacity=np.ascontiguousarray(opacity),
                       log_scale=np.ascontiguousarray(log_scale),
                       quat=np.ascontiguousarray(quat))


def load_points_ply(path: str):
    """Plain point-cloud PLY (x y z [r g b]) -> (points [N,3], colors [N,3]
    in [0,1]). Handles float or uchar colors (scene/dataset_readers.py:91-105)."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.find(b"end_header\n")
    header = raw[:end].decode("ascii").splitlines()
    body = raw[end + len(b"end_header\n"):]

    n = None
    fields = []  # (name, numpy dtype)
    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4",
                "short": "<i2", "ushort": "<u2", "char": "i1"}
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "element" and t[1] == "vertex":
            n = int(t[2])
        elif t[0] == "property" and len(t) == 3 and n is not None:
            fields.append((t[2], type_map[t[1]]))
    dt = np.dtype(fields)
    arr = np.frombuffer(body, dtype=dt, count=n)
    pts = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
    if "red" in dt.names:
        cols = np.stack([arr["red"], arr["green"], arr["blue"]], -1)
        cols = cols.astype(np.float32)
        if dict(fields)["red"] == "u1":
            cols /= 255.0
    else:
        cols = np.full((n, 3), 0.5, np.float32)
    return pts, cols


def save_points_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    n = points.shape[0]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "end_header\n")
    if colors is None:
        colors = np.full((n, 3), 0.5, np.float32)
    dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec = np.empty(n, dtype=dt)
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    c = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
