"""Production blend path: feature stack -> kernel B1 -> image (port of the
forward of hlod_gaussians_tpu/ops/rasterize.py::rasterize_tiles, :127-219).

The JAX package wraps the Pallas kernels in the `_blend`/`_expand` custom
VJPs. The backward (kernel B2 and the per-Gaussian gradient reduction) is
not ported yet, so this path is forward-only: called under grad mode on
tensors that require grad it raises, as the JAX package does for a render
binned without gradient bookkeeping (rasterize.py:92-95).
"""

from __future__ import annotations

from typing import Optional

import torch

from hlod_gaussians_torch.ops import rasterize_cuda
from hlod_gaussians_torch.ops.binning import TileBins
from hlod_gaussians_torch.ops.rasterize_xla import RenderOut, blend_features


def rasterize_tiles(
    bins: TileBins,
    xy: torch.Tensor,          # [N,2]
    conic: torch.Tensor,       # [N,3]
    opacity: torch.Tensor,     # [N]
    color: torch.Tensor,       # [N,3]
    invdepth_g: torch.Tensor,  # [N]
    bg: torch.Tensor,          # [3]
    ts: Optional[torch.Tensor] = None,
    kids: Optional[torch.Tensor] = None,
    *,
    width: int, height: int, tile_w: int, tile_h: int,
    t_eps: float = 1e-4, alpha_min: float = 1.0 / 255.0,
    want_seen: bool = False,
) -> RenderOut:
    """Blend the binned entries with kernel B1 (the plain version on CPU
    tensors). With ``want_seen`` the kernel flags every Gaussian that was
    applied to some pixel (the CUDA `seen` buffer, forward.cu:568)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (xy, conic, opacity, color, invdepth_g, ts)):
        raise RuntimeError(
            "the kernel blend path is forward-only: its backward (blend "
            "backward kernel + gradient reduction) is not ported yet — "
            "render under torch.no_grad() or use backend='xla'")
    feats = blend_features(xy, conic, opacity, color, invdepth_g, ts, kids)
    img4, final_t, n_contrib, seen = rasterize_cuda.blend_forward(
        feats, bins.sorted_gid, bins.tile_starts, bins.tile_counts,
        width=width, height=height, tile_w=tile_w, tile_h=tile_h,
        t_eps=t_eps, alpha_min=alpha_min,
        use_lod=ts is not None and kids is not None, want_seen=want_seen)
    if seen is None:
        seen = torch.zeros((xy.shape[0],), dtype=torch.bool, device=xy.device)
    return RenderOut(image=img4[:3] + final_t[None] * bg[:, None, None],
                     invdepth=img4[3], final_t=final_t, n_contrib=n_contrib,
                     seen=seen, truncated=bins.overflow)
