"""3D Morton (Z-order) codes (port of hlod_gaussians_tpu/ops/morton.py;
reference getMortonCodeCUDA, gaussianhierarchy/morton.cu:8-45).

21 bits per axis interleaved into one 63-bit code. The JAX package splits
the code into two uint32 words because TPUs default to 32-bit ints; torch
has int64, so the code is one tensor.
"""

from __future__ import annotations

import torch


def morton_codes(points, lo=None, hi=None):
    """Quantize [N,3] points to 21 bits per axis and interleave: [N] int64.

    Reference quantization exactly (morton.cu:29-32): multiply by 2^21 and
    truncate; a coordinate at the exact max maps to 2^21, whose set bit lies
    past the 21 interleaved bits and reads as 0 (the reference's quirk)."""
    if lo is None:
        lo = points.min(dim=0).values
    if hi is None:
        hi = points.max(dim=0).values
    scale = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    q = torch.clamp((points - lo) / scale * float(1 << 21), 0.0,
                    float(1 << 21))
    qi = q.to(torch.int64)
    code = torch.zeros(points.shape[:-1], dtype=torch.int64,
                       device=points.device)
    for i in range(21):
        for a in range(3):
            code |= ((qi[..., a] >> i) & 1) << (3 * i + a)
    return code


def morton_argsort(points, lo=None, hi=None):
    """Indices that sort points in Morton order (ties keep index order)."""
    return torch.sort(morton_codes(points, lo, hi), stable=True).indices
