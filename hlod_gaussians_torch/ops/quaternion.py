"""Quaternion utilities, (w, x, y, z) convention (port of
hlod_gaussians_tpu/ops/quaternion.py). Batched over leading axes."""

from __future__ import annotations

import torch


def normalize(q, eps=1e-12):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)


def to_matrix(q):
    """Quaternion [..., 4] (w,x,y,z) -> rotation matrix [..., 3, 3] mapping
    body to world coordinates (reference build_rotation)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                        2 * (x * z + r * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - r * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def from_matrix(m):
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (w,x,y,z), w >= 0.

    Branch-free Shepperd extraction: all four candidates are built and the
    one with the largest squared component is selected."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12))

    sw = safe_sqrt(qw2) * 0.5
    cand_w = torch.stack([sw, (m21 - m12) / (4 * sw), (m02 - m20) / (4 * sw),
                          (m10 - m01) / (4 * sw)], dim=-1)
    sx = safe_sqrt(qx2) * 0.5
    cand_x = torch.stack([(m21 - m12) / (4 * sx), sx, (m01 + m10) / (4 * sx),
                          (m02 + m20) / (4 * sx)], dim=-1)
    sy = safe_sqrt(qy2) * 0.5
    cand_y = torch.stack([(m02 - m20) / (4 * sy), (m01 + m10) / (4 * sy), sy,
                          (m12 + m21) / (4 * sy)], dim=-1)
    sz = safe_sqrt(qz2) * 0.5
    cand_z = torch.stack([(m10 - m01) / (4 * sz), (m02 + m20) / (4 * sz),
                          (m12 + m21) / (4 * sz), sz], dim=-1)

    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return torch.where(q[..., 0:1] < 0, -q, q)


def multiply(a, b):
    """Hamilton product of two (w,x,y,z) quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)
