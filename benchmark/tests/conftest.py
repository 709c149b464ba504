"""Tiny sizes of the cells for CPU runs, and the `card` fixture for the
tests marked `cuda`."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

def _config(name):
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        return json.load(f)


# a few hundred Gaussians at 64 px: the scales of the 100,000-Gaussian and
# 2^19-leaf scenes, so that each covers a few pixels
_FLAT = dict(n_gaussians=300, width=64, height=48, tile=[16, 16],
             max_dup=1 << 14,
             scene=dict(_config("flat-3dgs3M-sh3")["scene"],
                        scale_median=0.025))
_LOD = dict(n_leaves=512, width=64, height=48, tile=[16, 16],
            max_dup=1 << 15, max_budget=1 << 10,
            leaves=dict(_config("lod-8M-sh3")["leaves"],
                        log_scale_mean=-3.2))
TINY = {
    "train-flat3M-1080p": {"config": _FLAT, "traffic": dict(views=4)},
    "serve-lod8M-1080p-tau0": {"config": _LOD,
                               "traffic": dict(views=3, check_frames=2)},
    # at 64 px a tau of 15 px covers a quarter of the frame and draws
    # nothing; tau 2 keeps the cell's coarse, interior cut
    "serve-lod8M-1080p-tau15": {"config": _LOD,
                                "traffic": dict(views=3, check_frames=2,
                                                tau=2.0)},
}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")
