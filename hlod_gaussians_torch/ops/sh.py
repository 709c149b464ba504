"""Spherical-harmonics evaluation, degrees 0..3 (port of
hlod_gaussians_tpu/ops/sh.py; reference utils/sh_utils.py and
forward.cu:25-76): real SH with the 3DGS signs, +0.5 offset, clamp at 0."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)

# number of SH coefficients for degree d
NUM_COEFFS = {0: 1, 1: 4, 2: 9, 3: 16}


def rgb_to_sh(rgb):
    """DC color -> SH coefficient (reference RGB2SH)."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    """SH DC coefficient -> color (reference SH2RGB)."""
    return sh * C0 + 0.5


def sh_basis(deg: int, x, y, z):
    """Real SH basis values at unit directions (x, y, z): list of K
    tensors, same polynomials and signs as forward.cu:25-76."""
    b = [torch.full_like(x, C0)]
    if deg > 0:
        b += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            b += [C2[0] * x * y, C2[1] * y * z,
                  C2[2] * (2.0 * zz - xx - yy),
                  C2[3] * x * z, C2[4] * (xx - yy)]
            if deg > 2:
                b += [C3[0] * y * (3.0 * xx - yy), C3[1] * x * y * z,
                      C3[2] * y * (4.0 * zz - xx - yy),
                      C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                      C3[4] * x * (4.0 * zz - xx - yy),
                      C3[5] * z * (xx - yy),
                      C3[6] * x * (xx - 3.0 * yy)]
    return b


def eval_sh(deg: int, sh, dirs):
    """SH [..., K, 3] (K >= NUM_COEFFS[deg]) at unit directions [..., 3]
    -> raw colors [..., 3], with no +0.5 offset and no clamp (the
    reference's eval_sh; `sh_color` is the rasterizer's form)."""
    k = NUM_COEFFS[deg]
    b = torch.stack(sh_basis(deg, dirs[..., 0], dirs[..., 1], dirs[..., 2]),
                    dim=-1)
    return torch.einsum("...k,...kc->...c", b, sh[..., :k, :])


def sh_color(deg: int, sh, means, campos):
    """SH [N,K,3] -> clamped RGB [N,3] as the rasterizer computes it
    (computeColorFromSH, forward.cu:25-76): direction from the camera to the
    mean, +0.5 offset, clamp at zero."""
    if deg == 0:
        # direction-independent: no normalize at all
        return torch.clamp_min(C0 * sh[..., 0, :] + 0.5, 0.0)
    d = means - campos
    # eps inside the sqrt keeps the gradient finite when means == campos
    inv = torch.rsqrt(torch.sum(d * d, dim=-1) + 1e-20)
    x, y, z = d[..., 0] * inv, d[..., 1] * inv, d[..., 2] * inv
    b = torch.stack(sh_basis(deg, x, y, z), dim=-1)        # [..., K]
    k = NUM_COEFFS[deg]
    out = torch.sum(b[..., None] * sh[..., :k, :], dim=-2)
    return torch.clamp_min(out + 0.5, 0.0)
