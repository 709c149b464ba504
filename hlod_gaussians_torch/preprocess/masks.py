"""Mask pipeline: alpha-channel -> binary masks -> masked training images.

A copy of hlod_gaussians_tpu/preprocess/masks.py, the equivalents of the
reference's mask utilities:

* ``alpha_to_mask`` / ``make_masks``  — reference
  ``preprocess/make_mask_uint8.py``: threshold the alpha channel at >250
  and ERODE 3x3 (shrink the valid region one pixel so soft edges never
  leak), emit uint8 {0, 255}.
* ``apply_mask`` / ``apply_masks``   — reference
  ``preprocess/black_mask.py``: DILATE the mask 5x5 and zero image pixels
  where the dilated mask is 0 (the dilation keeps a safety margin of real
  pixels alive around the mask boundary).

Morphology is pure numpy (min/max over shifted views) — cv2 is not in
this environment and a 2-line sliding window needs no dependency.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def _shift_reduce(m: np.ndarray, k: int, op) -> np.ndarray:
    """kxk morphological min (erode) / max (dilate) with edge replication."""
    r = k // 2
    p = np.pad(m, r, mode="edge")
    out = m.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out = op(out, p[r + dy:r + dy + m.shape[0],
                            r + dx:r + dx + m.shape[1]])
    return out


def erode(mask: np.ndarray, k: int = 3) -> np.ndarray:
    return _shift_reduce(mask, k, np.minimum)


def dilate(mask: np.ndarray, k: int = 5) -> np.ndarray:
    return _shift_reduce(mask, k, np.maximum)


def alpha_to_mask(rgba: np.ndarray) -> np.ndarray:
    """[H,W,4] (or [H,W] alpha) uint8 -> {0,255} uint8 mask, eroded 3x3
    (make_mask_uint8.py:28-33: threshold >250, erode, re-threshold)."""
    alpha = rgba[..., -1] if rgba.ndim == 3 else rgba
    mask = (alpha > 250).astype(np.uint8) * 255
    return (erode(mask, 3) > 250).astype(np.uint8) * 255


def apply_mask(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Zero pixels outside the 5x5-DILATED mask (black_mask.py:27-31)."""
    d = dilate(mask, 5)
    out = img.copy()
    out[d == 0] = 0
    return out


def _list_images(root: str, exts=(".png", ".jpg", ".jpeg")) -> List[str]:
    """Flat dir of images, or one level of subfolders (the reference
    handles both layouts, make_mask_uint8.py:17-25)."""
    names = []
    for entry in sorted(os.listdir(root)):
        p = os.path.join(root, entry)
        if os.path.isdir(p):
            names += [os.path.join(entry, n) for n in sorted(os.listdir(p))
                      if n.lower().endswith(exts)]
        elif entry.lower().endswith(exts):
            names.append(entry)
    return names


def make_masks(in_dir: str, out_dir: str) -> int:
    """RGBA images in in_dir -> uint8 masks in out_dir. Returns count."""
    from PIL import Image

    n = 0
    for name in _list_images(in_dir, exts=(".png",)):
        img = np.asarray(Image.open(os.path.join(in_dir, name)))
        if img.ndim != 3 or img.shape[-1] < 4:
            continue
        dst = os.path.join(out_dir, name)
        os.makedirs(os.path.dirname(dst) or out_dir, exist_ok=True)
        Image.fromarray(alpha_to_mask(img)).save(dst)
        n += 1
    return n


def apply_masks(images_dir: str, masks_dir: str,
                quality: int = 95) -> int:
    """Black out masked regions of every image IN PLACE (black_mask.py).
    Mask file shares the image's stem with a .png extension. Returns the
    number of images rewritten."""
    from PIL import Image

    n = 0
    for name in _list_images(images_dir):
        mask_path = os.path.join(masks_dir, os.path.splitext(name)[0] + ".png")
        if not os.path.exists(mask_path):
            continue
        ip = os.path.join(images_dir, name)
        img = np.asarray(Image.open(ip))
        mask = np.asarray(Image.open(mask_path).convert("L"))
        out = apply_mask(img, mask)
        kw = {"quality": quality} if name.lower().endswith(
            (".jpg", ".jpeg")) else {}
        Image.fromarray(out).save(ip, **kw)
        n += 1
    return n
