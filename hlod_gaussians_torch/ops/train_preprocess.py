"""The training step's per-row chain from the raw parameters to kernel B1's
feature rows and the binning's inputs, differentiable: the activations
(models/gaussians.py::activate), cov3d, the EWA projection, SH colour and
blend_features' row, and their gradient.

`train_preprocess` is the entry point, for CUDA tensors only: a
torch.autograd.Function whose forward is one launch of the hand-written
kernel train_preprocess_forward and whose backward is one launch of
train_preprocess_backward (`csrc/train_preprocess.cu`, built with the other
kernels by `rasterize_cuda.build()`), which recomputes the forward from the
parameters and writes every parameter's gradient in its own shape. The
kernels replace no TPU kernel: the JAX package leaves this chain and its
derivative to XLA's fusion; the source's header note gives the byte bound
and the design. `train_preprocess_forward.launches` and
`train_preprocess_backward.launches` count the launches, and each forward
launch adds the rows it covers (the capacity) to
counters["project.rows_fused"].

`train_preprocess_plain` is its plain version: that chain as separate
PyTorch operations, in the order render.render_arrays runs them after
activate, differentiated by autograd. It has the same signature, so a
test can run one in the other's place.

render.render_params calls `train_preprocess` on CUDA tensors; on CPU
tensors it runs activate and render_arrays, the chain the CPU parity tests
hold to the JAX package.
"""

from __future__ import annotations

import torch

from hlod_gaussians_torch.ops import gaussian_math, rasterize_cuda
from hlod_gaussians_torch.ops import sh as sh_ops
from hlod_gaussians_torch.ops.lod_preprocess import LodRows, _tan
from hlod_gaussians_torch.ops.rasterize_xla import N_FEATS, blend_features
from hlod_gaussians_torch.utils.metrics import counters


def train_preprocess_plain(xyz, log_scale, quat, opacity_logit, f_dc,
                           f_rest, mask, world_view, full_proj, campos,
                           tan_fovx, tan_fovy, xy_offset=None, *, width: int,
                           height: int, sh_degree: int,
                           dilation: float = 0.3, near: float = 0.2,
                           big_limit: float = float("inf"),
                           antialiasing: bool = False,
                           alpha_min: float = 1.0 / 255.0) -> LodRows:
    """Plain version of the train_preprocess kernels: the raw parameters
    (xyz [C, 3], log_scale [C, 3], quat [C, 4], opacity_logit [C, 1], f_dc
    [C, 1, 3], f_rest [C, K, 3]) activated as activate does, projected and
    coloured at SH degree ``sh_degree`` where ``mask`` [C] bool, with
    ``xy_offset`` [C, 2] added to the projected means -> LodRows of C
    rows, its feats differentiable with respect to every parameter and
    the offset."""
    quats = quat / torch.linalg.norm(quat, dim=-1,
                                     keepdim=True).clamp_min(1e-12)
    scales = torch.exp(log_scale)
    cov6 = gaussian_math.compute_cov3d(scales, quats)
    proj = gaussian_math.project_gaussians(
        xyz, cov6, torch.sigmoid(opacity_logit[..., 0]), world_view,
        full_proj, width, height, width / (2.0 * tan_fovx),
        height / (2.0 * tan_fovy), tan_fovx, tan_fovy, dilation=dilation,
        antialiasing=antialiasing, near=near, valid_in=mask,
        big_limit=big_limit, max_scale=torch.max(scales, dim=-1).values,
        alpha_min=alpha_min)
    xy = proj.xy if xy_offset is None else proj.xy + xy_offset
    color = sh_ops.sh_color(sh_degree, torch.cat([f_dc, f_rest], dim=1), xyz,
                            campos)
    feats = blend_features(xy, proj.conic, proj.opacity, color,
                           1.0 / torch.clamp_min(proj.depth, 1e-6))
    return LodRows(feats=feats, depth=proj.depth, radius=proj.radius,
                   valid=proj.valid, ext=proj.ext, reff2=proj.reff2)


_PARAMS = ("xyz", "log_scale", "quat", "opacity_logit", "f_dc", "f_rest")


def _common_args(p, mask, xy_offset, cam, c, k_rest, kw):
    """The arguments both C launchers take first: the parameters, the
    offset, the mask, the camera and the projection's settings."""
    tx_ptr, tx = _tan(cam[3], "tan_fovx", mask.device)
    ty_ptr, ty = _tan(cam[4], "tan_fovy", mask.device)
    return ([t.data_ptr() for t in p]
            + [None if xy_offset is None else xy_offset.data_ptr(),
               mask.data_ptr()] + [t.data_ptr() for t in cam[:3]]
            + [tx_ptr, ty_ptr, tx, ty, c, k_rest, kw["width"], kw["height"],
               kw["sh_degree"], float(kw["dilation"]), float(kw["near"]),
               float(kw["big_limit"]), float(kw["alpha_min"]),
               int(kw["antialiasing"])])


def launch_forward(lib, p, mask, xy_offset, cam, kw, stream) -> LodRows:
    """The forward's C call into ``lib`` (the built kernel, or its
    emulation on the CPU in the tests), with no checks: ``p`` the six
    contiguous parameter tensors in _PARAMS' order, ``cam`` (world_view,
    full_proj, campos, tan_fovx, tan_fovy), ``kw`` the projection's
    keywords. Allocates the outputs and raises on a launch error."""
    c, k_rest = p[0].shape[0], p[5].shape[1]
    dev = p[0].device
    out = LodRows(
        feats=torch.empty((c, N_FEATS), dtype=torch.float32, device=dev),
        depth=torch.empty((c,), dtype=torch.float32, device=dev),
        radius=torch.empty((c,), dtype=torch.int32, device=dev),
        valid=torch.empty((c,), dtype=torch.bool, device=dev),
        ext=torch.empty((c, 2), dtype=torch.float32, device=dev),
        reff2=torch.empty((c,), dtype=torch.float32, device=dev))
    err = lib.train_preprocess_forward_launch(
        *_common_args(p, mask, xy_offset, cam, c, k_rest, kw),
        *(t.data_ptr() for t in out), stream)
    if err != 0:
        raise RuntimeError("train_preprocess forward launch failed: "
                           f"{lib.train_preprocess_error_string(err).decode()}")
    return out


def launch_backward(lib, p, mask, xy_offset, cam, kw, g_feats, stream):
    """The backward's C call into ``lib``, with no checks: as
    launch_forward, and the feature rows' gradient g_feats [C, 12]
    (contiguous). Returns the gradients of the six parameters in their
    shapes and of xy_offset (None without one); raises on a launch
    error."""
    grads = [torch.empty_like(t) for t in p]
    g_xy = None if xy_offset is None else torch.empty_like(xy_offset)
    err = lib.train_preprocess_backward_launch(
        *_common_args(p, mask, xy_offset, cam, p[0].shape[0], p[5].shape[1],
                      kw),
        g_feats.data_ptr(), *(t.data_ptr() for t in grads),
        None if g_xy is None else g_xy.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("train_preprocess backward launch failed: "
                           f"{lib.train_preprocess_error_string(err).decode()}")
    return grads, g_xy


def train_preprocess_forward(p, mask, xy_offset, cam, kw) -> LodRows:
    """One launch of kernel train_preprocess_forward on the current
    stream; counts it and the rows it covers."""
    lib = rasterize_cuda._library("train_preprocess")
    with torch.cuda.device(mask.device):
        out = launch_forward(lib, p, mask, xy_offset, cam, kw,
                             torch.cuda.current_stream().cuda_stream)
    train_preprocess_forward.launches += 1
    counters["project.rows_fused"] += mask.shape[0]
    return out


def train_preprocess_backward(p, mask, xy_offset, cam, kw, g_feats):
    """One launch of kernel train_preprocess_backward on the current
    stream; counts it."""
    lib = rasterize_cuda._library("train_preprocess")
    with torch.cuda.device(mask.device):
        out = launch_backward(lib, p, mask, xy_offset, cam, kw,
                              g_feats.contiguous(),
                              torch.cuda.current_stream().cuda_stream)
    train_preprocess_backward.launches += 1
    return out


train_preprocess_forward.launches = 0
train_preprocess_backward.launches = 0


class _TrainPreprocess(torch.autograd.Function):
    """The six parameters and xy_offset -> (feats, depth, radius, valid,
    ext, reff2); only feats is differentiable."""

    @staticmethod
    def forward(ctx, xyz, log_scale, quat, opacity_logit, f_dc, f_rest,
                xy_offset, mask, cam, kw):
        p = [t.contiguous() for t in (xyz, log_scale, quat, opacity_logit,
                                      f_dc, f_rest)]
        out = train_preprocess_forward(p, mask, xy_offset, cam, kw)
        ctx.mark_non_differentiable(*out[1:])
        ctx.save_for_backward(*p, mask, xy_offset)
        ctx.cam, ctx.kw = cam, kw
        return tuple(out)

    @staticmethod
    def backward(ctx, g_feats, *_):
        *p, mask, xy_offset = ctx.saved_tensors
        grads, g_xy = train_preprocess_backward(p, mask, xy_offset, ctx.cam,
                                                ctx.kw, g_feats)
        return (*grads, g_xy, None, None, None)


def train_preprocess(xyz, log_scale, quat, opacity_logit, f_dc, f_rest,
                     mask, world_view, full_proj, campos, tan_fovx, tan_fovy,
                     xy_offset=None, *, width: int, height: int,
                     sh_degree: int, dilation: float = 0.3,
                     near: float = 0.2, big_limit: float = float("inf"),
                     antialiasing: bool = False,
                     alpha_min: float = 1.0 / 255.0) -> LodRows:
    """The contract of train_preprocess_plain on CUDA tensors, as the
    train_preprocess kernels on the current stream (one launch forward, one
    when differentiated). Checks the inputs: float32 parameters of C rows
    (quat [C, 4], opacity_logit [C, 1], f_dc [C, 1, 3], f_rest [C, K, 3]
    with K of 0, 3, 8 or 15 and at least the degree's), mask [C] bool,
    xy_offset [C, 2] or None, all on one CUDA device."""
    p = (xyz, log_scale, quat, opacity_logit, f_dc, f_rest)
    dev = xyz.device
    if dev.type != "cuda":
        raise ValueError("train_preprocess runs the CUDA kernels: the "
                         f"parameters are on {dev} (train_preprocess_plain "
                         "is the plain version)")
    c = xyz.shape[0]
    k = f_rest.shape[1] if f_rest.ndim == 3 else -1
    shapes = dict(xyz=(c, 3), log_scale=(c, 3), quat=(c, 4),
                  opacity_logit=(c, 1), f_dc=(c, 1, 3), f_rest=(c, k, 3))
    for name, t in zip(_PARAMS, p):
        if t.device != dev or t.dtype != torch.float32 or \
                tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be float32 of shape "
                             f"{shapes[name]} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if k + 1 not in sh_ops.NUM_COEFFS.values() or \
            sh_ops.NUM_COEFFS[sh_degree] > k + 1:
        raise ValueError(f"f_rest holds {k} coefficients: the kernels take "
                         "0, 3, 8 or 15, at least the "
                         f"{sh_ops.NUM_COEFFS[sh_degree] - 1} of SH degree "
                         f"{sh_degree}")
    rasterize_cuda._check(mask, "mask", torch.bool, (c,))
    if xy_offset is not None:
        rasterize_cuda._check(xy_offset, "xy_offset", torch.float32, (c, 2))
    cam = [world_view.contiguous(), full_proj.contiguous(),
           campos.contiguous()]
    for t, name, shape in zip(cam, ("world_view", "full_proj", "campos"),
                              ((4, 4), (4, 4), (3,))):
        rasterize_cuda._check(t, name, torch.float32, shape)
    kw = dict(width=width, height=height, sh_degree=sh_degree,
              dilation=dilation, near=near, big_limit=big_limit,
              antialiasing=antialiasing, alpha_min=alpha_min)
    return LodRows(*_TrainPreprocess.apply(
        *p, xy_offset, mask, (*cam, tan_fovx, tan_fovy), kw))
