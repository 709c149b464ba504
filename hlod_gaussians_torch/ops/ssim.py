"""Image losses: L1, SSIM (11x11 Gaussian window), PSNR (port of
hlod_gaussians_tpu/ops/ssim.py; reference utils/loss_utils.py:17-63,
utils/image_utils.py:15-19).

SSIM uses an 11-tap sigma-1.5 separable Gaussian window with zero padding,
C1 = 0.01^2, C2 = 0.03^2. The JAX package blurs by shift-and-add; here the
five blurs of one SSIM run as two depthwise `F.conv2d` calls over the
stacked [5C, H, W] images. A float32 depthwise convolution on CUDA runs in
PyTorch's own kernel in full float32 (not cuDNN's TF32).

Images are [C, H, W] float in [0, 1] (channel-first like the reference).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(a, b):
    return torch.abs(a - b).mean()


def psnr(img1, img2):
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


@functools.lru_cache()
def _gaussian_window_np(window_size: int = 11, sigma: float = 1.5):
    x = np.arange(window_size, dtype=np.float32) - window_size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur(x, window_size: int = 11, sigma: float = 1.5):
    """Separable Gaussian blur of every channel of [C, H, W], zero padded
    to the same size."""
    c = x.shape[0]
    r = window_size // 2
    w = torch.as_tensor(_gaussian_window_np(window_size, sigma),
                        dtype=x.dtype, device=x.device)
    x = F.conv2d(x[None], w.reshape(1, 1, -1, 1).expand(c, 1, -1, 1),
                 padding=(r, 0), groups=c)
    x = F.conv2d(x, w.reshape(1, 1, 1, -1).expand(c, 1, 1, -1),
                 padding=(0, r), groups=c)
    return x[0]


def ssim(img1, img2, window_size: int = 11):
    """Mean SSIM over a [C, H, W] image pair (reference
    utils/loss_utils.py:38-63)."""
    c = img1.shape[0]
    mu1, mu2, b11, b22, b12 = torch.split(
        _blur(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2]),
              window_size), c)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = b11 - mu1_sq
    sigma2_sq = b22 - mu2_sq
    sigma12 = b12 - mu1_mu2

    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()
