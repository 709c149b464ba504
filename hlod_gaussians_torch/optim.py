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
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from hlod_gaussians_torch.config import OptimizationConfig


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


def sparse_adam_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: AdamState,
    lrs: Dict[str, float],
    visible: Optional[torch.Tensor] = None,   # [C] bool mask over Gaussian rows
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15,
):
    """One masked Adam step -> (new params, new AdamState).

    ``visible`` masks rows of every per-Gaussian tensor (leading dim C);
    tensors with a different leading dim (exposure) are updated where their
    gradient is nonzero."""
    f32 = np.float32
    step = state.step + 1
    bc1 = float(f32(1) - f32(b1) ** f32(step))
    bc2 = float(f32(1) - f32(b2) ** f32(step))
    one_m_b1, one_m_b2 = float(f32(1 - b1)), float(f32(1 - b2))

    new_p, new_m, new_v = {}, {}, {}
    cap = None
    for k in params:
        p, g = params[k], grads[k]
        m0, v0 = state.m[k], state.v[k]
        mask = None
        if visible is not None and p.ndim >= 1 and k != "exposure":
            if cap is None:
                cap = visible.shape[0]
            mask = visible if p.shape[0] == cap else None
        if mask is None and k == "exposure":
            # rows (images) with any nonzero grad
            mask = torch.any((g != 0.0).reshape(g.shape[0], -1), dim=1)
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
