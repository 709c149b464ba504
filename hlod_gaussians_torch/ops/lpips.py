"""LPIPS perceptual distance with a VGG16 backbone (port of
hlod_gaussians_tpu/ops/lpips.py; reference lpipsPyTorch/).

The conv feature pyramid, unit-normalisation at five taps and the linear
heads, as an `nn.Module` whose weights come from a local `.npz` (nothing is
downloaded):

    lpips_fn = make_lpips("/path/to/lpips_vgg.npz")   # or None

Expected npz keys: `convN_M_w` [out,in,3,3] / `convN_M_b` for the VGG16
conv stack, and `lin{0..4}_w` [1,C,1,1] for the LPIPS linear heads (a
missing head averages over channels instead). The convolutions run in full
float32: TF32 is switched off for the call, whatever the process-wide
setting.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 conv layout: (name, out_channels); 'M' = maxpool; slices end after
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 (the 5 LPIPS taps)
VGG16_CFG = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
]
TAPS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3")

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _normalize(feat, eps=1e-10):
    n = torch.sqrt(torch.sum(feat ** 2, dim=1, keepdim=True))
    return feat / (n + eps)


class LPIPS(nn.Module):
    """LPIPS distance of two [3,H,W] images in [0,1] -> a 0-dim tensor."""

    def __init__(self, weights, device=None):
        super().__init__()
        device = torch.device("cuda") if device is None else device
        for name, arr in weights.items():
            self.register_buffer(name, torch.tensor(
                np.asarray(arr, np.float32), device=device))
        self.register_buffer("shift", torch.tensor(
            _SHIFT, device=device).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(
            _SCALE, device=device).reshape(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for item in VGG16_CFG:
            if item == "M":
                x = F.max_pool2d(x, 2)
            else:
                name, _ = item
                x = F.relu(F.conv2d(x, getattr(self, f"{name}_w"),
                                    getattr(self, f"{name}_b"), padding=1))
                if name in TAPS:
                    feats.append(x)
        return feats

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        # PARITY QUIRK: the reference wrapper z-scores the [0,1] image
        # DIRECTLY with the [-1,1]-era constants (render_hierarchy.py:113
        # feeds clamped [0,1] renders, modules/networks.py:50-54 applies
        # (x - mean)/std with no *2-1 mapping)
        prep = lambda img: (img[None] - self.shift) / self.scale
        cudnn = torch.backends.cudnn
        with torch.no_grad(), cudnn.flags(
                enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic, allow_tf32=False):
            f1 = self.features(prep(img1))
            f2 = self.features(prep(img2))
            total = torch.zeros((), device=img1.device)
            for i, (a, b) in enumerate(zip(f1, f2)):
                d = (_normalize(a) - _normalize(b)) ** 2
                w = getattr(self, f"lin{i}_w", None)
                if w is not None:
                    # 1x1 conv, no bias, no clamp (modules/networks.py:23-30)
                    d = torch.sum(d * w.reshape(1, -1, 1, 1), dim=1,
                                  keepdim=True)
                else:
                    d = torch.mean(d, dim=1, keepdim=True)
                total = total + torch.mean(d)
        return total


def make_lpips(weights_path: Optional[str] = None, device=None
               ) -> Optional[Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]]:
    """The LPIPS distance on ``device`` (the card by default), or None when
    the weights file is not given or missing. The returned module takes two
    [3,H,W] images in [0,1] on that device."""
    if weights_path is None or not os.path.exists(weights_path):
        return None
    with np.load(weights_path) as z:
        weights = {k: z[k] for k in z.files}
    return LPIPS(weights, device=device).eval()
