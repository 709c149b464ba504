"""Weights-free perceptual metric: GMSD (port of
hlod_gaussians_tpu/ops/perceptual.py).

The reference's eval reports LPIPS (render_hierarchy.py:108-120), whose VGG
weights must be downloaded. This module gives the standing-in perceptual
column: Gradient Magnitude Similarity Deviation (Xue, Zhang, Mou, Bovik
2013), closed-form, no learned weights. Reported as `gmsd` (lower is
better, 0 = identical), never under the name lpips.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Prewitt kernels (the GMSD paper's choice), applied at half resolution
_HX = [[1.0 / 3.0, 0.0, -1.0 / 3.0]] * 3
# T = 170 on [0,255] gradient magnitudes -> 170/255^2 on [0,1] images
_C = 170.0 / (255.0 ** 2)


def _luminance(img: torch.Tensor) -> torch.Tensor:
    """[3,H,W] in [0,1] -> [H,W] luma (Rec.601, the paper's L channel)."""
    return 0.299 * img[0] + 0.587 * img[1] + 0.114 * img[2]


def _avgpool2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    x = x[: h - h % 2, : w - w % 2]
    return (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2]
            + x[1::2, 1::2]) * 0.25


def _gradient_magnitude(y: torch.Tensor) -> torch.Tensor:
    """|Prewitt gradient| of [H,W], zero padded to the same size: one
    depthwise F.conv2d (a cross-correlation, as XLA's convolution) with
    both kernels."""
    hx = torch.tensor(_HX, dtype=y.dtype, device=y.device)
    k = torch.stack([hx, hx.T])[:, None]                   # [2,1,3,3]
    g = F.conv2d(y[None, None], k, padding=1)[0]
    return torch.sqrt(g[0] ** 2 + g[1] ** 2 + 1e-12)


def gmsd(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Gradient Magnitude Similarity Deviation of two [3,H,W] images in
    [0,1]: a 0-d tensor, 0 for identical images, larger = worse."""
    gm1 = _gradient_magnitude(_avgpool2(_luminance(img1)))
    gm2 = _gradient_magnitude(_avgpool2(_luminance(img2)))
    gms = (2.0 * gm1 * gm2 + _C) / (gm1 ** 2 + gm2 ** 2 + _C)
    return torch.std(gms, correction=0)
