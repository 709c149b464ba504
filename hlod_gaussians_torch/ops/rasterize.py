"""Production blend path: feature stack -> kernel B1 -> image, with kernel
B2 as its backward (port of hlod_gaussians_tpu/ops/rasterize.py
::rasterize_tiles and its `_blend`/`_expand` custom VJPs, :42-219).

`_Blend` is the `torch.autograd.Function` around the kernels: its forward
runs B1 (`rasterize_cuda.blend_forward`) and saves final_t and n_contrib;
its backward runs B2 (`rasterize_cuda.blend_backward`) for per-entry
gradients and reduces them to the Gaussians with `gaussian_grads`. On CPU
tensors both wrappers run their plain PyTorch versions. Autograd through
the caller's `blend_features` and the background composite does the
rest.

A render made with ``inference=True`` (RasterizerConfig.inference; the
render_lod entry point forces it) raises when differentiated, as the JAX
package's does (rasterize.py:92-95).
"""

from __future__ import annotations

import torch

from hlod_gaussians_torch.ops import rasterize_cuda
from hlod_gaussians_torch.ops.binning import TileBins
from hlod_gaussians_torch.ops.rasterize_xla import RenderOut


_TAIL = 1024


def gaussian_grads(egrads: torch.Tensor, bins: TileBins, n: int):
    """Per-entry gradients [max_dup, 12] -> per-Gaussian [n, 12] (the
    `_expand` VJP, hlod_gaussians_tpu/ops/rasterize.py:88-121).

    Entries were generated contiguously per depth-sorted Gaussian, so
    permuting them back to generation order (`sorted_gen`) turns the
    reduction into segment sums over `gen_offsets`, and `order` maps the
    sorted Gaussians back to their rows. Both permutations are index writes
    of distinct rows and each segment is summed in entry order, so the
    result does not depend on thread timing: no scatter-add, no atomics."""
    md = egrads.shape[0]
    ggen = torch.empty_like(egrads)
    ggen[bins.sorted_gen.long()] = egrads
    ggen = torch.where(bins.gen_valid[:, None], ggen, torch.zeros_like(ggen))
    # entries past max_dup were dropped: clip their segments to the list.
    # The unused slots past the last candidate (zeros) are cut into extra
    # segments of at most _TAIL entries, dropped after the reduction: a
    # segment is summed by one thread, and the last Gaussian's segment
    # would otherwise run serially to max_dup
    starts = torch.clamp_max(bins.gen_offsets.long(), md)
    tail = torch.arange(1, -(-md // _TAIL) + 1, dtype=torch.long,
                        device=egrads.device) * _TAIL
    tail = torch.maximum(tail, bins.num_candidates.long()).clamp_max(md)
    seg = torch.segment_reduce(ggen, "sum",
                               offsets=torch.cat([starts, tail]), axis=0,
                               unsafe=True)[:n]                # [n, 12]
    out = torch.empty((n, egrads.shape[1]), dtype=egrads.dtype,
                      device=egrads.device)
    out[bins.order.long()] = seg
    return out


class _Blend(torch.autograd.Function):
    """feats [N, 12] -> (img4 [4, H, W], final_t [H, W], n_contrib, seen)."""

    @staticmethod
    def forward(ctx, feats, bins: TileBins, opts: dict, want_seen: bool,
                inference: bool):
        img4, final_t, n_contrib, seen = rasterize_cuda.blend_forward(
            feats, bins.sorted_gid, bins.tile_starts, bins.tile_counts,
            want_seen=want_seen, **opts)
        if seen is None:
            seen = torch.zeros((feats.shape[0],), dtype=torch.bool,
                               device=feats.device)
        ctx.mark_non_differentiable(n_contrib, seen)
        ctx.bins, ctx.opts, ctx.inference = bins, opts, inference
        if not inference:
            ctx.save_for_backward(feats, final_t, n_contrib)
        return img4, final_t, n_contrib, seen

    @staticmethod
    def backward(ctx, g_img4, g_final_t, _g_nc, _g_seen):
        if ctx.inference:
            raise RuntimeError(
                "this render was made with RasterizerConfig.inference (as "
                "render_lod makes every render) — it cannot be "
                "differentiated; render with a training config")
        feats, final_t, n_contrib = ctx.saved_tensors
        bins, opts = ctx.bins, ctx.opts
        egrads = rasterize_cuda.blend_backward(
            feats, bins.sorted_gid, bins.tile_starts, bins.tile_counts,
            final_t, n_contrib, g_img4.contiguous(), g_final_t.contiguous(),
            width=opts["width"], height=opts["height"],
            tile_w=opts["tile_w"], tile_h=opts["tile_h"],
            alpha_min=opts["alpha_min"], use_lod=opts["use_lod"])
        return gaussian_grads(egrads, bins, feats.shape[0]), None, None, \
            None, None


def rasterize_tiles(
    bins: TileBins,
    feats: torch.Tensor,       # [N, 12] rasterize_xla.blend_features
    bg: torch.Tensor,          # [3]
    *,
    width: int, height: int, tile_w: int, tile_h: int,
    use_lod: bool = False,
    t_eps: float = 1e-4, alpha_min: float = 1.0 / 255.0,
    want_seen: bool = False,
    inference: bool = False,
) -> RenderOut:
    """Blend the binned entries of the feature rows with kernel B1,
    differentiable through kernel B2 (the plain versions on CPU tensors);
    ``use_lod`` blends with the LOD alpha from the rows' t and 1/kids
    columns, which carry no gradient. With ``want_seen`` the kernel flags
    every Gaussian that was applied to some pixel (the CUDA `seen` buffer,
    forward.cu:568)."""
    opts = dict(width=width, height=height, tile_w=tile_w, tile_h=tile_h,
                t_eps=t_eps, alpha_min=alpha_min, use_lod=use_lod)
    img4, final_t, n_contrib, seen = _Blend.apply(feats, bins, opts,
                                                  want_seen, inference)
    return RenderOut(image=img4[:3] + final_t[None] * bg[:, None, None],
                     invdepth=img4[3], final_t=final_t, n_contrib=n_contrib,
                     seen=seen, truncated=bins.overflow)
