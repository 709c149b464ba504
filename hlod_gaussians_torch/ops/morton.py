"""3D Morton (Z-order) codes (port of hlod_gaussians_tpu/ops/morton.py;
reference getMortonCodeCUDA, gaussianhierarchy/morton.cu:8-45).

21 bits per axis interleaved into one 63-bit code. The JAX package splits
the code into two uint32 words because TPUs default to 32-bit ints; torch
has int64, so the code is one tensor.
"""

from __future__ import annotations

import torch


def morton_codes(points, lo=None, hi=None, *, wrap_max: bool = True):
    """Quantize [N,3] points to 21 bits per axis and interleave: [N] int64.

    Reference quantization exactly (morton.cu:29-32): multiply by 2^21 and
    truncate; a coordinate at the exact max maps to 2^21, whose set bit lies
    past the 21 interleaved bits and reads as 0 (the reference's quirk,
    kept for order parity). With ``wrap_max=False`` it maps to 2^21 - 1,
    the last cell, so the point keeps its place on the curve beside its
    neighbours (every other coordinate quantizes as before)."""
    if lo is None:
        lo = points.min(dim=0).values
    if hi is None:
        hi = points.max(dim=0).values
    scale = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    top = float(1 << 21) if wrap_max else float((1 << 21) - 1)
    q = torch.clamp((points - lo) / scale * float(1 << 21), 0.0, top)
    qi = q.to(torch.int64)
    code = torch.zeros(points.shape[:-1], dtype=torch.int64,
                       device=points.device)
    for i in range(21):
        for a in range(3):
            code |= ((qi[..., a] >> i) & 1) << (3 * i + a)
    return code


def morton_argsort(points, lo=None, hi=None):
    """Indices that sort points in Morton order (ties keep index order),
    each axis's maximum in the last cell (``wrap_max=False``): the kNN's
    curves, on which the reference's wrap would put that point at 0."""
    return torch.sort(morton_codes(points, lo, hi, wrap_max=False),
                      stable=True).indices
