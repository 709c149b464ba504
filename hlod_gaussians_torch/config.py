"""Rasterizer configuration (port of hlod_gaussians_tpu/config.py:81-123).

Only `RasterizerConfig` is ported in this slice. The TPU-only `tpb` field
(tiles per Pallas grid program) has no counterpart: the CUDA kernel runs one
block per tile.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    """Shape budgets and blend constants of the tile rasterizer."""

    # "pallas" = the production blend path: tight binning and the
    # hand-written CUDA kernel (ops/rasterize_cuda.py); `truncated` reports
    # only max_dup overflow. "xla" = the plain scan path (circle rects,
    # `truncated` also trips when a tile exceeds k_max entries).
    backend: str = "xla"
    # Pixel tile shape; the CUDA kernel runs one thread per pixel, so
    # tile_w * tile_h <= 1024.
    tile_h: int = 8
    tile_w: int = 128
    # Alpha-aware tight tile coverage (pallas backend only): identical images
    # with about half the entries of the reference's 3-sigma circle rects.
    tight_binning: bool = True
    # Capacity of the duplicated (gaussian, tile) entry list; overflow is
    # reported through `truncated`.
    max_dup: int = 1 << 19
    # Early-exit transmittance threshold (forward.cu:563).
    t_eps: float = 1e-4
    # Minimum alpha for a contribution (forward.cu:560).
    alpha_min: float = 1.0 / 255.0
    # Near-plane cull distance (forward.cu:322).
    near: float = 0.2
    # Dilation added to the 2D covariance diagonal (forward.cu:361-364).
    dilation: float = 0.3
    # Cull Gaussians whose max scale exceeds this (forward.cu:351).
    big_limit: float = float("inf")
    # Render-only: differentiating such a render raises. The render_lod
    # entry point forces this on. (The kernel path has no backward yet, so
    # every pallas-backend render is render-only until it does.)
    inference: bool = False
