"""The masked LOD path's per-row preparation of the renderer's inputs: the
InterpTable lerped at the cut's weights, the skybox prepended, the
quaternions normalised, cov3d, the EWA projection, SH colour, inverse depth
and kernel B1's feature rows, for every row of the tree.

`lod_preprocess` is the one entry point. On CPU tensors it runs
`lod_preprocess_plain`, which is that chain as the renderer has always run
it (cut.interpolate_all_masked, the skybox prepend, then
gaussian_math.compute_cov3d, project_gaussians, sh.sh_color and
rasterize_xla.blend_features), so the CPU parity tests hold the masked
path to the JAX package unchanged. On CUDA tensors it launches the
hand-written kernel `csrc/lod_preprocess.cu` (built with the blend kernels
by `rasterize_cuda.build()`) or raises. The kernel replaces no TPU kernel:
the JAX package leaves this chain to XLA's fusion; its header note gives
the byte bound and the design. `lod_preprocess.launches` counts the kernel
launches.

Only render.render_lod_masked calls it, a render that is never
differentiated; the training and budgeted paths project through
render.render_arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hlod_gaussians_torch.hierarchy import cut as cut_mod
from hlod_gaussians_torch.ops import gaussian_math, rasterize_cuda
from hlod_gaussians_torch.ops import sh as sh_ops
from hlod_gaussians_torch.ops.rasterize_xla import N_FEATS, blend_features


class LodRows(NamedTuple):
    """The renderer's inputs for M = n_skybox + C rows, culled rows
    sanitised as project_gaussians sanitises them."""
    feats: torch.Tensor    # [M, 12] blend_features' layout; xy is [:, :2]
    depth: torch.Tensor    # [M] view-space z
    radius: torch.Tensor   # [M] int32 (0 = culled)
    valid: torch.Tensor    # [M] bool
    ext: torch.Tensor      # [M, 2] tight half-extents
    reff2: torch.Tensor    # [M]


def lod_preprocess_plain(table, mask, ts, kids, alive, world_view,
                         full_proj, campos, tan_fovx, tan_fovy, *,
                         width: int, height: int, sh_degree: int,
                         n_skybox: int = 0, dilation: float = 0.3,
                         near: float = 0.2,
                         big_limit: float = float("inf"),
                         antialiasing: bool = False,
                         alpha_min: float = 1.0 / 255.0) -> LodRows:
    """Plain version of kernel lod_preprocess: the InterpTable ``table``
    lerped at ``ts`` where ``mask`` (t = 1 elsewhere); the skybox, the
    table's first ``n_skybox`` rows at t = 1, valid where ``alive``,
    prepended; the renderer's projection and SH colour of every row; LOD
    columns t (1 outside the mask) and 1/max(kids, 1). ``alpha_min`` is
    the projection's, for the tight extents."""
    d = table.feats.shape[1] // 2
    interp = cut_mod.interpolate_all_masked(table, ts, mask)
    valid = mask
    ts_r = torch.where(mask, ts, torch.ones_like(ts))
    kids_r = torch.clamp_min(kids, 1)
    if n_skybox > 0:
        sky = cut_mod._unpack(table.feats[:n_skybox, :d])
        interp = {k: torch.cat([sky[k], v]) for k, v in interp.items()}
        valid = torch.cat([alive[:n_skybox], valid])
        ts_r = torch.cat([torch.ones((n_skybox,), device=ts.device), ts_r])
        kids_r = torch.cat([torch.ones((n_skybox,), dtype=torch.int32,
                                       device=ts.device), kids_r])
    means, scales = interp["means3d"], interp["scales"]
    quats = interp["quats"]
    quats = quats / torch.linalg.norm(quats, dim=-1,
                                      keepdim=True).clamp_min(1e-12)
    cov6 = gaussian_math.compute_cov3d(scales, quats)
    proj = gaussian_math.project_gaussians(
        means, cov6, interp["opacities"], world_view, full_proj, width,
        height, width / (2.0 * tan_fovx), height / (2.0 * tan_fovy),
        tan_fovx, tan_fovy, dilation=dilation, antialiasing=antialiasing,
        near=near, valid_in=valid, big_limit=big_limit,
        max_scale=torch.max(scales, dim=-1).values, alpha_min=alpha_min)
    color = sh_ops.sh_color(sh_degree, interp["shs"], means, campos)
    invdepth = 1.0 / torch.clamp_min(proj.depth, 1e-6)
    feats = blend_features(proj.xy, proj.conic, proj.opacity, color,
                           invdepth, ts_r, kids_r)
    return LodRows(feats=feats, depth=proj.depth, radius=proj.radius,
                   valid=proj.valid, ext=proj.ext, reff2=proj.reff2)


def _tan(tan, name: str, dev):
    """(device pointer or None, value) of a tangent given as a float or a
    one-element float32 tensor on the card, read there by the kernel (a
    host read would wait for the work queued ahead)."""
    if isinstance(tan, torch.Tensor):
        if tan.device != dev or tan.dtype != torch.float32 or tan.numel() != 1:
            raise ValueError(f"{name} must be a float or a one-element "
                             f"float32 tensor on {dev}")
        return tan.data_ptr(), 0.0
    return None, float(tan)


def lod_preprocess(table, mask, ts, kids, alive, world_view, full_proj,
                   campos, tan_fovx, tan_fovy, *, width: int, height: int,
                   sh_degree: int, n_skybox: int = 0, dilation: float = 0.3,
                   near: float = 0.2, big_limit: float = float("inf"),
                   antialiasing: bool = False,
                   alpha_min: float = 1.0 / 255.0) -> LodRows:
    """table: cut.InterpTable [C, 2D] float32; mask [C] bool, ts [C]
    float32, kids [C] int32 (the cut's render_mask, ts and kids); alive [C]
    bool; the camera (4x4 row-vector matrices, campos [3], the tangents) ->
    LodRows of n_skybox + C rows. The contract of lod_preprocess_plain; on
    CUDA tensors one launch of the kernel on the current stream."""
    feats_t = table.feats
    if feats_t.device.type == "cpu":
        return lod_preprocess_plain(
            table, mask, ts, kids, alive, world_view, full_proj, campos,
            tan_fovx, tan_fovy, width=width, height=height,
            sh_degree=sh_degree, n_skybox=n_skybox, dilation=dilation,
            near=near, big_limit=big_limit, antialiasing=antialiasing,
            alpha_min=alpha_min)

    dev = feats_t.device
    check = rasterize_cuda._check      # a contiguous CUDA tensor
    c, two_d = feats_t.shape
    d = two_d // 2
    if two_d % 2 or (d - 11) % 3 or sh_ops.NUM_COEFFS[sh_degree] > \
            (d - 11) // 3 or d > 59:
        raise ValueError(f"table width {two_d}: the kernel takes 2 x (11 + "
                         "3 K) columns with K <= 16 coefficients, at least "
                         f"the {sh_ops.NUM_COEFFS[sh_degree]} of SH degree "
                         f"{sh_degree}")
    if not 0 <= n_skybox <= c:
        raise ValueError(f"n_skybox {n_skybox} outside [0, {c}]")
    check(feats_t, "table.feats", torch.float32, (c, two_d))
    if feats_t.data_ptr() % 8:
        raise ValueError("table.feats must be 8-byte aligned (float2 copies)")
    check(mask, "mask", torch.bool, (c,))
    check(ts, "ts", torch.float32, (c,))
    check(kids, "kids", torch.int32, (c,))
    check(alive, "alive", torch.bool, (c,))
    cam = [world_view.contiguous(), full_proj.contiguous(),
           campos.contiguous()]
    for t, name, shape in zip(cam, ("world_view", "full_proj", "campos"),
                              ((4, 4), (4, 4), (3,))):
        check(t, name, torch.float32, shape)
    tx_ptr, tx = _tan(tan_fovx, "tan_fovx", dev)
    ty_ptr, ty = _tan(tan_fovy, "tan_fovy", dev)

    m = n_skybox + c
    out = LodRows(
        feats=torch.empty((m, N_FEATS), dtype=torch.float32, device=dev),
        depth=torch.empty((m,), dtype=torch.float32, device=dev),
        radius=torch.empty((m,), dtype=torch.int32, device=dev),
        valid=torch.empty((m,), dtype=torch.bool, device=dev),
        ext=torch.empty((m, 2), dtype=torch.float32, device=dev),
        reff2=torch.empty((m,), dtype=torch.float32, device=dev))
    lib = rasterize_cuda._library("lod_preprocess")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lod_preprocess_launch(
            feats_t.data_ptr(), mask.data_ptr(), ts.data_ptr(),
            kids.data_ptr(), alive.data_ptr(),
            *(t.data_ptr() for t in cam), tx_ptr, ty_ptr, tx, ty, c, d,
            n_skybox, width, height, sh_degree, float(dilation), float(near),
            float(big_limit), float(alpha_min), int(antialiasing),
            *(t.data_ptr() for t in out), stream)
    if err != 0:
        raise RuntimeError("lod_preprocess kernel launch failed: "
                           f"{lib.lod_preprocess_error_string(err).decode()}")
    lod_preprocess.launches += 1
    return out


lod_preprocess.launches = 0
