"""Sparse per-Gaussian Adam + learning-rate schedules (port of
hlod_gaussians_tpu/optim.py).

One functional transform: a dense masked update. Rows outside the
``visible`` mask keep parameters AND moments untouched (the fused
SparseGaussianAdam kernel's semantics, alt-rasterizer adam.cu:9-38); the
exposure table updates the rows whose gradient is nonzero (OurAdam's
``step(relevant)``, scene/OurAdam.py:117-135). Bias correction uses the
global step count (scene/OurAdam.py:137-149).

The step counters are host ints: PyTorch runs eagerly, so the learning-rate
schedule and the bias corrections are host scalars and a step needs no
device sync. They are computed in float32, as the JAX package computes
them, so both packages take the same step.

On CUDA tensors the step is one launch of the hand-written kernel
sparse_adam (csrc/sparse_adam.cu, wrapper `sparse_adam_cuda`), which
equals the plain chain on the card bit for bit; on CPU tensors it is that
chain, `sparse_adam_plain`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from hlod_gaussians_torch.config import OptimizationConfig
from hlod_gaussians_torch.ops import rasterize_cuda
from hlod_gaussians_torch.utils.metrics import counters


class AdamState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: int


def init_adam(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(m={k: torch.zeros_like(p) for k, p in params.items()},
                     v={k: torch.zeros_like(p) for k, p in params.items()},
                     step=0)


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-lerp LR schedule with sine delay (reference
    utils/general_utils.py:get_expon_lr_func), in float32."""
    f32 = np.float32
    step = f32(step)
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * math.pi) * np.clip(step / f32(lr_delay_steps),
                                         f32(0), f32(1)))
    else:
        delay_rate = f32(1)
    t = np.clip(step / f32(max_steps), f32(0), f32(1))
    # frozen parameter (both rates 0, e.g. the coarse stage's xyz): the
    # log-lerp would be exp(log(0)) = NaN; the reference special-cases it
    # to 0 (get_expon_lr_func's `if lr_init == lr_final == 0` guard)
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                      + np.log(f32(lr_final)) * t)
    return float(f32(delay_rate * log_lerp))


def param_lrs(cfg: OptimizationConfig, step, spatial_lr_scale: float,
              lr_multiplier: float = 1.0) -> Dict[str, float]:
    """Per-tensor learning rates (reference training_setup,
    scene/gaussian_model.py:921-948): xyz scheduled and scaled by scene
    extent; f_rest at feature_lr/20; exposure on its own delayed schedule,
    which lr_multiplier does not scale."""
    f32 = np.float32
    xyz_lr = expon_lr(step, f32(cfg.position_lr_init) * f32(spatial_lr_scale),
                      f32(cfg.position_lr_final) * f32(spatial_lr_scale),
                      lr_delay_mult=cfg.position_lr_delay_mult,
                      max_steps=cfg.position_lr_max_steps)
    exp_lr = expon_lr(step, cfg.exposure_lr_init, cfg.exposure_lr_final,
                      lr_delay_steps=cfg.exposure_lr_delay_steps,
                      lr_delay_mult=cfg.exposure_lr_delay_mult,
                      max_steps=cfg.iterations)
    m = lr_multiplier
    return dict(
        xyz=float(f32(xyz_lr) * f32(m)),
        f_dc=float(f32(cfg.feature_lr * m)),
        f_rest=float(f32(cfg.feature_lr / 20.0 * m)),
        opacity_logit=float(f32(cfg.opacity_lr * m)),
        log_scale=float(f32(cfg.scaling_lr * m)),
        quat=float(f32(cfg.rotation_lr * m)),
        exposure=float(exp_lr),     # no multiplier, as in the JAX package
    )


def _bias_terms(step: int, b1: float, b2: float):
    """(bc1, bc2, 1 - b1, 1 - b2) of a step in float32, as host floats."""
    f32 = np.float32
    return (float(f32(1) - f32(b1) ** f32(step)),
            float(f32(1) - f32(b2) ** f32(step)),
            float(f32(1 - b1)), float(f32(1 - b2)))


def sparse_adam_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: AdamState,
    lrs: Dict[str, float],
    visible: Optional[torch.Tensor] = None,   # [C] bool mask over Gaussian rows
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15,
):
    """One masked Adam step -> (new params, new AdamState), out of place.

    ``visible`` masks rows of every per-Gaussian tensor (leading dim C);
    tensors with a different leading dim (exposure) are updated where their
    gradient is nonzero. On CUDA tensors one launch of kernel sparse_adam
    (`sparse_adam_cuda`); on CPU tensors the plain chain
    (`sparse_adam_plain`)."""
    if any(p.is_cuda for p in params.values()):
        return sparse_adam_cuda(params, grads, state, lrs, visible, b1, b2,
                                eps)
    return sparse_adam_plain(params, grads, state, lrs, visible, b1, b2, eps)


def _row_mask(k: str, p: torch.Tensor, g: torch.Tensor,
              visible: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The rows of tensor ``k`` that take the step, or None for all:
    ``visible`` on a tensor of C rows, the rows with a nonzero gradient on
    the exposure table."""
    if k == "exposure":
        return torch.any((g != 0.0).reshape(g.shape[0], -1), dim=1)
    if visible is not None and p.ndim >= 1 and p.shape[0] == visible.shape[0]:
        return visible
    return None


def sparse_adam_plain(params, grads, state: AdamState, lrs, visible=None,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    """Plain version of kernel sparse_adam: sparse_adam_update as separate
    PyTorch operations, in the order the kernel follows."""
    step = state.step + 1
    bc1, bc2, one_m_b1, one_m_b2 = _bias_terms(step, b1, b2)
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        p, g = params[k], grads[k]
        m0, v0 = state.m[k], state.v[k]
        mask = _row_mask(k, p, g, visible)
        m1 = b1 * m0 + one_m_b1 * g
        v1 = b2 * v0 + one_m_b2 * g * g
        p1 = p - lrs[k] * (m1 / bc1) / (torch.sqrt(v1 / bc2) + eps)
        if mask is not None:
            msk = mask.reshape((mask.shape[0],) + (1,) * (p.ndim - 1))
            m1 = torch.where(msk, m1, m0)
            v1 = torch.where(msk, v1, v0)
            p1 = torch.where(msk, p1, p)
        new_p[k], new_m[k], new_v[k] = p1, m1, v1
    return new_p, AdamState(m=new_m, v=new_v, step=step)


def _row_stride(t: torch.Tensor, width: int) -> Optional[int]:
    """Floats from one row of ``t`` to the next where each of its rows is
    contiguous (a packed tensor, or a view of whole rows of a wider one),
    else None."""
    if t.is_contiguous():
        return width
    if t.shape[0] > 1 and t.stride(0) >= width and t[0].is_contiguous():
        return t.stride(0)
    return None


def sparse_adam_cuda(params, grads, state: AdamState, lrs, visible=None,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    """Kernel sparse_adam (csrc/sparse_adam.cu): sparse_adam_plain's step,
    bit for bit as the plain chain gives it on the card, for every tensor
    in one launch on the current stream. Checks every input before it
    launches: float32 and p's shape, and p, m and v with contiguous rows
    (packed, or views of whole rows as the out-of-core trainer's; a
    gradient may come in any layout), and at most eight tensors, each
    under 2^32 floats (the kernel refuses more); counts its launches in
    ``sparse_adam_cuda.launches`` and the rows it covers (the capacity) in
    counters["adam.rows_fused"]."""
    tensors = [visible] if visible is not None else []
    for k, p in params.items():
        for name, t in (("param", p), ("grad", grads[k]),
                        ("m", state.m[k]), ("v", state.v[k])):
            if t.dtype != torch.float32:
                raise ValueError(f"{name} {k} must be torch.float32, got "
                                 f"{t.dtype}")
            if t.shape != p.shape:
                raise ValueError(f"{name} {k} must have shape "
                                 f"{tuple(p.shape)}, got {tuple(t.shape)}")
            if name != "grad" and p.ndim and p.numel() and _row_stride(
                    t, p.numel() // p.shape[0]) is None:
                raise ValueError(f"{name} {k} must have contiguous rows")
            tensors.append(t)
    if visible is not None:
        if visible.dtype != torch.bool or visible.ndim != 1 or \
                not visible.is_contiguous():
            raise ValueError("visible must be a contiguous 1-D torch.bool "
                             f"tensor, got {visible.dtype} of shape "
                             f"{tuple(visible.shape)}")
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("every tensor must be on one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")

    lib = rasterize_cuda._library("sparse_adam")
    with torch.cuda.device(dev):
        out = launch_sparse_adam(
            lib, params, grads, state, lrs, visible, b1, b2, eps,
            torch.cuda.current_stream(dev).cuda_stream)
    if any(p.numel() for p in params.values()):      # else no launch
        sparse_adam_cuda.launches += 1
        counters["adam.rows_fused"] += (
            visible.shape[0] if visible is not None
            else next(iter(params.values())).shape[0])
    return out


def launch_sparse_adam(lib, params, grads, state: AdamState, lrs, visible,
                       b1: float, b2: float, eps: float, stream):
    """The C call that sparse_adam_cuda makes into ``lib`` (the built
    kernel, or its emulation on the CPU in the tests), with no checks:
    allocates the outputs, the row masks and the segment table, launches
    on ``stream`` and raises on a launch error."""
    step = state.step + 1
    bc1, bc2, one_m_b1, one_m_b2 = _bias_terms(step, b1, b2)
    f32 = np.float32
    new_p, new_m, new_v = {}, {}, {}
    ptrs, numel, width, strides, lr = [], [], [], [], []
    held = []       # masks and gradient copies, alive until the launch
    for k, p in params.items():
        g, m0, v0 = grads[k], state.m[k], state.v[k]
        mask = _row_mask(k, p, g, visible)
        w = 1 if p.ndim == 0 or p.numel() == 0 else p.numel() // p.shape[0]
        if _row_stride(g, w) is None:        # autograd's choice of layout
            g = g.contiguous()
        held += [mask, g]
        out = [torch.empty(p.shape, dtype=p.dtype, device=p.device)
               for _ in range(3)]
        new_p[k], new_m[k], new_v[k] = out
        ptrs += [t.data_ptr() for t in (p, g, m0, v0, *out)]
        ptrs.append(None if mask is None else mask.data_ptr())
        numel.append(p.numel())
        width.append(w)
        strides += [_row_stride(t, w) for t in (p, g, m0, v0)]
        lr.append(lrs[k])
    n = len(numel)
    # PyTorch divides by a host scalar as a product with its float32
    # reciprocal, so the kernel takes 1 / bc1 and 1 / bc2
    err = lib.sparse_adam_launch(
        n, (ctypes.c_void_p * (8 * n))(*ptrs),
        (ctypes.c_longlong * n)(*numel), (ctypes.c_int * n)(*width),
        (ctypes.c_longlong * (4 * n))(*strides), (ctypes.c_float * n)(*lr),
        b1, b2, one_m_b1, one_m_b2, float(f32(1) / f32(bc1)),
        float(f32(1) / f32(bc2)), eps, stream)
    if err != 0:
        raise RuntimeError("sparse_adam kernel launch failed: "
                           f"{lib.sparse_adam_error_string(err).decode()}")
    return new_p, AdamState(m=new_m, v=new_v, step=step)


sparse_adam_cuda.launches = 0


def zero_rows(state: AdamState, mask: torch.Tensor, keys=None) -> AdamState:
    """Reset moments of masked rows (respawned / densified Gaussians —
    reference replace_tensors_to_optimizer, scene/gaussian_model.py
    :1531-1553). With ``keys``, only those tensors' moments are reset (the
    opacity reset must not erase xyz/SH momentum)."""
    def z(k, t):
        if keys is not None and k not in keys:
            return t
        if t.ndim >= 1 and t.shape[0] == mask.shape[0]:
            msk = mask.reshape((mask.shape[0],) + (1,) * (t.ndim - 1))
            return torch.where(msk, torch.zeros_like(t), t)
        return t
    return AdamState(m={k: z(k, t) for k, t in state.m.items()},
                     v={k: z(k, t) for k, t in state.v.items()},
                     step=state.step)
