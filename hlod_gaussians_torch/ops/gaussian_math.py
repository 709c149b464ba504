"""Closed-form per-Gaussian math: 3D covariance, EWA projection, conics
(port of hlod_gaussians_tpu/ops/gaussian_math.py, reference preprocessCUDA
forward.cu:140-445).

The arithmetic is written per column in the JAX package's order, so the
discrete decisions downstream (radius ceil, tile rects) see the same floats.
Culling is expressed as masks, never as dropped rows.

Conventions: the view matrix is world-to-camera applied to row vectors
(p_view = p @ V[:3, :3] + V[3, :3]); full projection = view @ proj;
quaternions are (w, x, y, z); scales are linear (already activated).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _cols(a, k):
    """[..., k] -> tuple of k [...] columns."""
    return tuple(a[..., i] for i in range(k))


def _cov3d_cols(sx, sy, sz, qw, qx, qy, qz):
    """3D covariance as the 6 packed columns (xx,xy,xz,yy,yz,zz);
    quaternions are normalized defensively (forward.cu:190)."""
    inv = 1.0 / torch.sqrt(
        torch.clamp_min(qw * qw + qx * qx + qy * qy + qz * qz, 1e-24))
    r, x, y, z = qw * inv, qx * inv, qy * inv, qz * inv
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    a = sx * sx
    b = sy * sy
    c = sz * sz
    xx = a * r00 * r00 + b * r01 * r01 + c * r02 * r02
    xy = a * r00 * r10 + b * r01 * r11 + c * r02 * r12
    xz = a * r00 * r20 + b * r01 * r21 + c * r02 * r22
    yy = a * r10 * r10 + b * r11 * r11 + c * r12 * r12
    yz = a * r10 * r20 + b * r11 * r21 + c * r12 * r22
    zz = a * r20 * r20 + b * r21 * r21 + c * r22 * r22
    return xx, xy, xz, yy, yz, zz


def compute_cov3d(scale, quat, scale_modifier=1.0):
    """scale [...,3], quat [...,4] -> symmetric cov packed [...,6] in the
    order (xx, xy, xz, yy, yz, zz) of forward.cu:181-215."""
    sx, sy, sz = _cols(scale * scale_modifier, 3)
    qw, qx, qy, qz = _cols(quat, 4)
    return torch.stack(_cov3d_cols(sx, sy, sz, qw, qx, qy, qz), dim=-1)


def unpack_cov3d(cov6):
    """[...,6] packed -> [...,3,3] symmetric matrix."""
    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))
    return torch.stack([torch.stack([xx, xy, xz], dim=-1),
                        torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)


def _affine_cols(mx, my, mz, mat, j):
    """Column j of the row-vector transform p @ mat[:3] + mat[3]."""
    return mx * mat[0, j] + my * mat[1, j] + mz * mat[2, j] + mat[3, j]


def transform_points(points, mat4):
    """Row-vector 4x4 transform with homogeneous divide: points [...,3],
    mat4 [4,4] -> (projected xyz [...,3], w [...]). |w| < 1e-7 divides by
    1e-7, so such rows stay finite."""
    mx, my, mz = _cols(points, 3)
    h0 = _affine_cols(mx, my, mz, mat4, 0)
    h1 = _affine_cols(mx, my, mz, mat4, 1)
    h2 = _affine_cols(mx, my, mz, mat4, 2)
    w = _affine_cols(mx, my, mz, mat4, 3)
    w_safe = torch.where(torch.abs(w) < 1e-7, torch.full_like(w, 1e-7), w)
    inv_w = 1.0 / w_safe
    return torch.stack([h0 * inv_w, h1 * inv_w, h2 * inv_w], dim=-1), w


def transform_points_3x4(points, mat4):
    """The affine part only (world -> view): [...,3]."""
    mx, my, mz = _cols(points, 3)
    return torch.stack([_affine_cols(mx, my, mz, mat4, j) for j in range(3)],
                       dim=-1)


def _cov2d_cols(t0, t1, t2, cov6_cols, viewmatrix,
                focal_x, focal_y, tan_fovx, tan_fovy):
    """EWA 2D covariance (computeCov2D, forward.cu:141-176) from the
    view-space position columns; (cxx, cxy, cyy) WITHOUT the dilation."""
    tz = torch.where(torch.abs(t2) < 1e-6, torch.full_like(t2, 1e-6), t2)
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(t0 / tz, -limx, limx) * tz
    ty = torch.clamp(t1 / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2

    vxx, vxy, vxz, vyy, vyz, vzz = cov6_cols
    V = ((vxx, vxy, vxz), (vxy, vyy, vyz), (vxz, vyz, vzz))
    W = viewmatrix

    def vw(i, b):  # (V @ W)[i, b]
        return V[i][0] * W[0, b] + V[i][1] * W[1, b] + V[i][2] * W[2, b]

    vw00, vw01, vw02 = vw(0, 0), vw(0, 1), vw(0, 2)
    vw10, vw11, vw12 = vw(1, 0), vw(1, 1), vw(1, 2)
    vw20, vw21, vw22 = vw(2, 0), vw(2, 1), vw(2, 2)

    def wtvw(a, b0, b1, b2):  # (W^T (VW))[a, :] dot column
        return W[0, a] * b0 + W[1, a] * b1 + W[2, a] * b2

    a = wtvw(0, vw00, vw10, vw20)
    b = wtvw(1, vw00, vw10, vw20)
    c = wtvw(2, vw00, vw10, vw20)
    d = wtvw(1, vw01, vw11, vw21)
    e = wtvw(2, vw01, vw11, vw21)
    f = wtvw(2, vw02, vw12, vw22)

    cxx = j00 * j00 * a + 2 * j00 * j02 * c + j02 * j02 * f
    cxy = j00 * j11 * b + j00 * j12 * c + j02 * j11 * e + j02 * j12 * f
    cyy = j11 * j11 * d + 2 * j11 * j12 * e + j12 * j12 * f
    return cxx, cxy, cyy


def compute_cov2d(mean, cov6, viewmatrix, focal_x, focal_y, tan_fovx,
                  tan_fovy):
    """EWA 2D covariance of world-space means [...,3] and packed cov6
    [...,6] -> (cxx, cxy, cyy) [...,3], WITHOUT the dilation term."""
    mx, my, mz = _cols(mean, 3)
    t0 = _affine_cols(mx, my, mz, viewmatrix, 0)
    t1 = _affine_cols(mx, my, mz, viewmatrix, 1)
    t2 = _affine_cols(mx, my, mz, viewmatrix, 2)
    return torch.stack(_cov2d_cols(t0, t1, t2, _cols(cov6, 6), viewmatrix,
                                   focal_x, focal_y, tan_fovx, tan_fovy),
                       dim=-1)


class Projection(NamedTuple):
    """Per-Gaussian screen-space quantities (culled rows sanitized)."""

    xy: torch.Tensor       # [N,2] pixel-space mean
    depth: torch.Tensor    # [N] view-space z
    conic: torch.Tensor    # [N,3] inverse 2D covariance (cxx, cxy, cyy)
    opacity: torch.Tensor  # [N] effective opacity (incl. AA scaling if on)
    radius: torch.Tensor   # [N] int32 pixel radius (0 = culled)
    valid: torch.Tensor    # [N] bool — survives all culls
    ext: torch.Tensor      # [N,2] tight half-extents of the alpha>=alpha_min
                           #       iso-ellipse's AABB
    reff2: torch.Tensor    # [N] squared radius of its circumscribed circle


def ndc2pix(v, size):
    """NDC [-1,1] -> pixel centers (auxiliary.h ndc2Pix)."""
    return ((v + 1.0) * size - 1.0) * 0.5


def project_gaussians(
    means, cov6, opacities, viewmatrix, projmatrix,
    width: int, height: int, focal_x, focal_y, tan_fovx, tan_fovy,
    *, dilation: float = 0.3, antialiasing: bool = False, near: float = 0.2,
    valid_in=None, big_limit: float = float("inf"), max_scale=None,
    alpha_min: float = 1.0 / 255.0,
) -> Projection:
    """Project all Gaussians to screen space (reference preprocessCUDA).

    Beyond the reference's 3-sigma circle this emits the tight per-axis
    extents of the region where alpha = op*exp(-q/2) can reach alpha_min
    (q <= 2 log(op/alpha_min)), which the tight binning intersects with the
    reference rect.
    """
    mx, my, mz = _cols(means, 3)
    h0 = _affine_cols(mx, my, mz, projmatrix, 0)
    h1 = _affine_cols(mx, my, mz, projmatrix, 1)
    w = _affine_cols(mx, my, mz, projmatrix, 3)
    w_safe = torch.where(torch.abs(w) < 1e-7, torch.full_like(w, 1e-7), w)
    inv_w = 1.0 / w_safe

    t0 = _affine_cols(mx, my, mz, viewmatrix, 0)
    t1 = _affine_cols(mx, my, mz, viewmatrix, 1)
    t2 = _affine_cols(mx, my, mz, viewmatrix, 2)
    depth = t2

    cov_xx, cov_xy, cov_yy = _cov2d_cols(
        t0, t1, t2, _cols(cov6, 6), viewmatrix,
        focal_x, focal_y, tan_fovx, tan_fovy)
    det_orig = cov_xx * cov_yy - cov_xy ** 2
    cxx = cov_xx + dilation
    cyy = cov_yy + dilation
    cxy = cov_xy
    det = cxx * cyy - cxy * cxy

    valid = depth > near
    if valid_in is not None:
        valid = valid & valid_in
    valid = valid & (det > 0.0)
    if max_scale is not None and big_limit != float("inf"):
        valid = valid & (max_scale <= big_limit)

    det_inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], dim=-1)

    opacity = opacities
    if antialiasing:
        # alt-rasterizer AA: opacity * sqrt(det_orig / det_dilated), clamped
        h_conv = torch.sqrt(torch.clamp_min(det_orig * det_inv, 2.5e-5))
        opacity = opacity * h_conv

    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    # 2L is NOT clamped to 9 (3 sigma): near-opaque Gaussians reach
    # alpha_min out to q ~ 11, and the reference rect does blend there
    two_l = torch.clamp(
        2.0 * torch.log(torch.clamp_min(opacity, 1e-12) / alpha_min),
        0.0, 20.0)
    # +1e-3 px margin against rounding flips at an exact boundary pixel
    ext_x = torch.sqrt(two_l * torch.clamp_min(cxx, 0.0)) + 1e-3
    ext_y = torch.sqrt(two_l * torch.clamp_min(cyy, 0.0)) + 1e-3
    reff2 = (torch.sqrt(two_l * lam) + 1e-3) ** 2
    # Gaussians whose peak alpha is below the blend threshold never land
    valid = valid & (two_l > 0.0)

    px = ndc2pix(h0 * inv_w, width)
    py = ndc2pix(h1 * inv_w, height)

    radius = torch.where(valid, radius, torch.zeros_like(radius)).to(torch.int32)
    valid = valid & (radius > 0)

    # Sanitize culled rows: binning padding still gathers them, and NaNs
    # there would poison a tile-shared transmittance chain in backward.
    zero = torch.zeros_like(px)
    xy = torch.stack([torch.where(valid, px, zero),
                      torch.where(valid, py, zero)], dim=-1)
    conic = torch.where(valid[..., None], conic,
                        conic.new_tensor([1.0, 0.0, 1.0]))
    depth = torch.where(valid, depth, torch.ones_like(depth))
    opacity = torch.where(valid, opacity, torch.zeros_like(opacity))
    ext = torch.stack([torch.where(valid, ext_x, zero),
                       torch.where(valid, ext_y, zero)], dim=-1)
    reff2 = torch.where(valid, reff2, torch.zeros_like(reff2))
    return Projection(xy=xy, depth=depth, conic=conic, opacity=opacity,
                      radius=radius, valid=valid, ext=ext, reff2=reff2)
