"""Plain PyTorch blend: sequential front-to-back tile blending (port of
hlod_gaussians_tpu/ops/rasterize_xla.py; reference renderCUDA,
forward.cu:450-596).

Step k processes the k-th depth-sorted entry of EVERY tile at once as dense
[tiles, pixels] math. The skips (power > 0, alpha < alpha_min) and the
sticky early stop (the first entry that would take T below t_eps is
dropped, and so is every later one) are masks, so this is the serial
per-pixel semantics of the CUDA kernel.

`blend_forward_plain` is the plain version of kernel B1
(`csrc/blend_forward.cu`, wrapper `ops/rasterize_cuda.py`): same inputs,
same outputs, the same arithmetic in the same order. `rasterize_scan` is the
`backend="xla"` render path built on it (differentiable through autograd).
`blend_backward_plain` is the plain version of kernel B2
(`csrc/blend_backward.cu`): the hand-derived backward of the blend, walking
the entry slots back to front.

LOD alpha correction (forward.cu:546-554), in the form the Pallas and CUDA
kernels evaluate it:
    kidsqrt_alpha = 1 - exp(inv_kids * log(max(1 - alpha, 1e-12)))
    alpha' = t * alpha + (1 - t) * kidsqrt_alpha
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from hlod_gaussians_torch.ops.binning import TileBins, tile_grid

# per-Gaussian blend feature columns (the Pallas entry_data rows 0:12)
(F_X, F_Y, F_S0, F_S1, F_S2, F_OP, F_R, F_G, F_B, F_INVD, F_T,
 F_IK) = range(12)
N_FEATS = 12


class RenderOut(NamedTuple):
    image: torch.Tensor      # [3, H, W] color (bg composited)
    invdepth: torch.Tensor   # [H, W] expected inverse depth
    final_t: torch.Tensor    # [H, W] final transmittance
    n_contrib: torch.Tensor  # [H, W] int32 — last contributing entry (1-based)
    seen: torch.Tensor       # [N] bool — Gaussian contributed to some pixel
    truncated: torch.Tensor  # 0-d bool


def lod_alpha(my_alpha, t, inv_kids):
    """LOD alpha correction (forward.cu:546-554)."""
    pw = torch.exp(inv_kids * torch.log(torch.clamp_min(1.0 - my_alpha, 1e-12)))
    return t * my_alpha + (1.0 - t) * (1.0 - pw)


def blend_features(xy, conic, opacity, color, invdepth_g, ts=None, kids=None):
    """[N, 12] float32 feature rows (rasterize.py:165-182): pixel mean, the
    PRE-SCALED quadratic coefficients (power = s0 dx^2 + s1 dx dy + s2 dy^2),
    opacity, rgb, inverse depth, LOD t and 1/kids (ones without LOD; the
    kids >= 1 guard keeps leaves, whose raw child count is 0, finite)."""
    n = xy.shape[0]
    if ts is not None and kids is not None:
        t_col = ts.to(torch.float32)
        ik_col = 1.0 / torch.clamp_min(kids, 1).to(torch.float32)
    else:
        t_col = ik_col = torch.ones((n,), dtype=torch.float32, device=xy.device)
    return torch.stack([
        xy[:, 0], xy[:, 1],
        -0.5 * conic[:, 0], -conic[:, 1], -0.5 * conic[:, 2],
        opacity, color[:, 0], color[:, 1], color[:, 2], invdepth_g,
        t_col, ik_col,
    ], dim=1).to(torch.float32).contiguous()


def entry_alpha(f, pxf, pyf, use_lod: bool):
    """Per-(entry, pixel) alpha and power for feature rows f [T, 12] against
    pixel centers [T, P]; the kernel's expression (rasterize_pallas.py:248)."""
    dx = f[:, F_X:F_X + 1] - pxf
    dy = f[:, F_Y:F_Y + 1] - pyf
    power = (dx * (f[:, F_S0:F_S0 + 1] * dx + f[:, F_S1:F_S1 + 1] * dy)
             + (f[:, F_S2:F_S2 + 1] * dy) * dy)
    alpha = torch.clamp_max(f[:, F_OP:F_OP + 1] * torch.exp(power), 0.99)
    if use_lod:
        alpha = lod_alpha(alpha, f[:, F_T:F_T + 1], f[:, F_IK:F_IK + 1])
    return alpha, power


def tile_pixels(width: int, height: int, tile_w: int, tile_h: int, device):
    """Pixel coordinates [T, P] of every tile slot, and the inside mask."""
    gw, gh = tile_grid(width, height, tile_w, tile_h)
    t_idx = torch.arange(gw * gh, device=device)
    p_idx = torch.arange(tile_w * tile_h, device=device)
    px = (t_idx % gw)[:, None] * tile_w + (p_idx % tile_w)[None, :]
    py = (t_idx // gw)[:, None] * tile_h + (p_idx // tile_w)[None, :]
    return px, py, (px < width) & (py < height)


def untile(x, width: int, height: int, tile_w: int, tile_h: int):
    """[T, P, ...] -> [H, W, ...]"""
    gw, gh = tile_grid(width, height, tile_w, tile_h)
    extra = x.shape[2:]
    x = x.reshape((gh, gw, tile_h, tile_w) + extra).transpose(1, 2)
    return x.reshape((gh * tile_h, gw * tile_w) + extra)[:height, :width]


def tile_image(x, width: int, height: int, tile_w: int, tile_h: int):
    """[..., H, W] -> [..., T, P], zero past the image (inverse of untile)."""
    gw, gh = tile_grid(width, height, tile_w, tile_h)
    x = F.pad(x, (0, gw * tile_w - width, 0, gh * tile_h - height))
    lead = tuple(x.shape[:-2])
    x = x.reshape(lead + (gh, tile_h, gw, tile_w)).transpose(-3, -2)
    return x.reshape(lead + (gh * gw, tile_h * tile_w))


def blend_forward_plain(feats, sorted_gid, tile_starts, tile_counts, *,
                        width: int, height: int, tile_w: int, tile_h: int,
                        t_eps: float = 1e-4, alpha_min: float = 1.0 / 255.0,
                        use_lod: bool = False, want_seen: bool = False,
                        k_max: Optional[int] = None):
    """Plain version of kernel B1.

    feats [N, 12] float32 (blend_features), sorted_gid [max_dup] int32,
    tile_starts / tile_counts [T] int32 -> (img4 [4, H, W] = rgb + inverse
    depth accumulations, final_t [H, W], n_contrib [H, W] int32, seen [N]
    bool or None). Processes the first `k_max` entries of every tile
    (default: the longest tile, which costs one host sync)."""
    n = feats.shape[0]
    dev = feats.device
    px, py, inside = tile_pixels(width, height, tile_w, tile_h, dev)
    pxf, pyf = px.to(torch.float32), py.to(torch.float32)
    num_tiles, p = px.shape
    if k_max is None:
        k_max = int(tile_counts.max()) if num_tiles else 0
    max_dup = sorted_gid.shape[0]

    t_run = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, p), dtype=torch.bool, device=dev)
    acc = torch.zeros((num_tiles, p, 4), dtype=torch.float32, device=dev)
    last = torch.zeros((num_tiles, p), dtype=torch.int32, device=dev)
    seen = torch.zeros((n,), dtype=torch.int32, device=dev)
    for k in range(k_max):
        valid_entry = k < tile_counts
        e = torch.clamp(tile_starts + k, 0, max(max_dup - 1, 0))
        gid = sorted_gid[e].long()
        f = feats[gid]                                       # [T, 12]
        alpha, power = entry_alpha(f, pxf, pyf, use_lod)
        pre = (valid_entry[:, None] & inside & (power <= 0.0)
               & (alpha >= alpha_min) & ~done)
        test_t = t_run * (1.0 - alpha)
        trigger = pre & (test_t < t_eps)
        apply = pre & ~trigger
        w = torch.where(apply, alpha * t_run, torch.zeros_like(alpha))
        acc = acc + w[:, :, None] * f[:, None, F_R:F_INVD + 1]
        t_run = torch.where(apply, test_t, t_run)
        done = done | trigger
        last = torch.where(apply, torch.full_like(last, k + 1), last)
        if want_seen:
            seen.scatter_reduce_(0, gid, apply.any(dim=1).to(torch.int32),
                                 "amax")

    img4 = untile(acc, width, height, tile_w, tile_h).permute(2, 0, 1)
    return (img4.contiguous(), untile(t_run, width, height, tile_w, tile_h),
            untile(last, width, height, tile_w, tile_h),
            seen.bool() if want_seen else None)


def blend_backward_plain(feats, sorted_gid, tile_starts, tile_counts,
                         final_t, n_contrib, g_img4, g_final_t, *,
                         width: int, height: int, tile_w: int, tile_h: int,
                         alpha_min: float = 1.0 / 255.0,
                         use_lod: bool = False):
    """Plain version of kernel B2: the hand-derived backward of
    blend_forward_plain (rasterize_pallas.py::_backward_tile :823-1061).

    feats [N, 12], sorted_gid [max_dup], tile_starts / tile_counts [T]; the
    forward's final_t [H, W] and n_contrib [H, W]; the cotangents g_img4
    [4, H, W] and g_final_t [H, W] -> per-entry gradients [max_dup, 12] in
    the blend_features column order (dgx, dgy, the three pre-scaled conic
    coefficients, opacity, rgb, inverse depth; F_T and F_IK carry none).

    Step k takes the k-th entry of every tile, from the longest n_contrib
    down to 0. An entry is applied iff it passes the forward's skips and
    k + 1 <= n_contrib, which is exactly the forward's applied set; T before
    it is rebuilt by division from final_t. Per pixel:
        dL/dalpha_k = cdotg_k T_k - (S_k + g_T * final_t) / (1 - alpha_k)
    with cdotg = sum_ch c_ch g_ch and the suffix S_k = sum_{j>k} alpha_j
    T_j cdotg_j; the LOD chain rule multiplies by dalpha/dmy, and where
    op * G >= 0.99 (the clip) power and opacity get no gradient."""
    dev = feats.device
    px, py, inside = tile_pixels(width, height, tile_w, tile_h, dev)
    pxf, pyf = px.to(torch.float32), py.to(torch.float32)
    max_dup = sorted_gid.shape[0]
    tiled = lambda x: tile_image(x, width, height, tile_w, tile_h)
    t_after = tiled(final_t)                          # [T, P]
    nc = tiled(n_contrib)
    g4 = tiled(g_img4)                                # [4, T, P]
    dtf = tiled(g_final_t) * t_after
    k_max = int(nc.max()) if nc.numel() else 0

    # one spare row takes the writes of tiles that have no entry k
    egrads = torch.zeros((max_dup + 1, N_FEATS), dtype=torch.float32,
                         device=dev)
    suf = torch.zeros_like(t_after)
    for k in range(k_max - 1, -1, -1):
        valid_entry = k < tile_counts
        e = torch.clamp(tile_starts + k, 0, max(max_dup - 1, 0))
        f = feats[sorted_gid[e].long()]                      # [T, 12]
        col = lambda i: f[:, i:i + 1]
        alpha, power = entry_alpha(f, pxf, pyf, use_lod)
        applied = (valid_entry[:, None] & inside & (power <= 0.0)
                   & (alpha >= alpha_min) & (k < nc))
        a = torch.where(applied, alpha, torch.zeros_like(alpha))
        one_m = 1.0 - a
        t_before = t_after / one_m
        contrib = a * t_before
        cdotg = (col(F_R) * g4[0] + col(F_G) * g4[1] + col(F_B) * g4[2]
                 + col(F_INVD) * g4[3])
        dcolor = torch.sum(contrib[None] * g4, dim=2).t()         # [T, 4]
        dal = cdotg * t_before - (suf + dtf) / one_m
        dal = torch.where(applied, dal, torch.zeros_like(dal))

        opg = col(F_OP) * torch.exp(power)
        if use_lod:
            one_m_my = torch.clamp_min(1.0 - torch.clamp_max(opg, 0.99),
                                       1e-12)
            pw = torch.exp(col(F_IK) * torch.log(one_m_my))
            dal = dal * (col(F_T) + (1.0 - col(F_T)) * col(F_IK) * pw
                         / one_m_my)
        dpower = torch.where(opg < 0.99, opg * dal, torch.zeros_like(dal))
        # factored spatial reductions (rasterize_pallas.py:991-1012)
        dx = col(F_X) - pxf
        dy = col(F_Y) - pyf
        u = dx * dpower
        v = dy * dpower
        su, sv = u.sum(1), v.sum(1)
        g12 = torch.stack([
            2.0 * f[:, F_S0] * su + f[:, F_S1] * sv,
            2.0 * f[:, F_S2] * sv + f[:, F_S1] * su,
            (dx * u).sum(1), (dy * u).sum(1), (dy * v).sum(1),
            dpower.sum(1) / torch.clamp_min(f[:, F_OP], 1e-30),
            dcolor[:, 0], dcolor[:, 1], dcolor[:, 2], dcolor[:, 3],
            torch.zeros_like(su), torch.zeros_like(su)], dim=1)
        egrads[torch.where(valid_entry, e, max_dup).long()] = g12
        suf = suf + contrib * cdotg
        t_after = t_before
    return egrads[:max_dup]


def rasterize_scan(
    bins: TileBins,
    feats: torch.Tensor,       # [N, 12] blend_features
    bg: torch.Tensor,          # [3]
    *,
    width: int, height: int, tile_w: int, tile_h: int, k_max: int,
    use_lod: bool = False,
    t_eps: float = 1e-4, alpha_min: float = 1.0 / 255.0,
) -> RenderOut:
    """The backend="xla" render: plain blend of the first k_max entries per
    tile (rounded up to whole 32-entry groups, as the JAX scan's remat
    chunks are) with `truncated` raised when a tile holds more;
    ``use_lod`` as for ops/rasterize.py::rasterize_tiles."""
    chunk = max(1, min(32, k_max))
    k_bound = -(-k_max // chunk) * chunk
    img4, final_t, n_contrib, seen = blend_forward_plain(
        feats, bins.sorted_gid, bins.tile_starts, bins.tile_counts,
        width=width, height=height, tile_w=tile_w, tile_h=tile_h,
        t_eps=t_eps, alpha_min=alpha_min, use_lod=use_lod, want_seen=True,
        k_max=k_bound)
    truncated = torch.any(bins.tile_counts > k_bound) | bins.overflow
    return RenderOut(image=img4[:3] + final_t[None] * bg[:, None, None],
                     invdepth=img4[3], final_t=final_t, n_contrib=n_contrib,
                     seen=seen, truncated=truncated)
