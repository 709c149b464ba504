"""Scene, training and rasterizer configuration (port of
hlod_gaussians_tpu/config.py:16-191).

`ModelConfig`, `PipelineConfig`, `OptimizationConfig`, `RasterizerConfig`,
`PostConfig`, `MeshConfig` and the JSON pair `save_config` / `load_config`
are ported. The TPU-only `tpb` field (tiles per Pallas grid program) has no
counterpart: the CUDA kernels run one block per tile.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model / scene loading parameters (reference arguments/__init__.py:114-147)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    alpha_masks: str = ""
    depths: str = ""
    resolution: int = -1
    white_background: bool = False
    train_test_exp: bool = False
    eval: bool = False
    skip_scale_big_gauss: bool = False
    hierarchy: str = ""
    pretrained: str = ""
    skybox_num: int = 0
    scaffold_file: str = ""
    skybox_locked: bool = False
    cap_max: int = -1  # MCMC capacity target (-1 = keep PostConfig.max_cap)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Render pipeline switches (reference arguments/__init__.py:149-154)."""

    antialiasing: bool = False
    debug: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """Training hyperparameters (reference arguments/__init__.py:156-185)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00002
    position_lr_final: float = 0.0000002
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    exposure_lr_init: float = 0.001
    exposure_lr_final: float = 0.0001
    exposure_lr_delay_steps: int = 5000
    exposure_lr_delay_mult: float = 0.001
    lambda_dssim: float = 0.2
    densification_interval: int = 300
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.015
    depth_l1_weight_init: float = 1.0
    depth_l1_weight_final: float = 0.01
    # As in the JAX package: no percent_dense (the fork's live densify
    # criterion is grad * radii * opacity^0.2) and no MCMC terms.


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    """Shape budgets and blend constants of the tile rasterizer."""

    # "pallas" = the production blend path: tight binning and the
    # hand-written CUDA kernel (ops/rasterize_cuda.py); `truncated` reports
    # only max_dup overflow. "xla" = the plain scan path (circle rects,
    # `truncated` also trips when a tile exceeds k_max entries).
    backend: str = "xla"
    # Pixel tile shape; the CUDA kernels cover a tile with one block, so
    # tile_w * tile_h <= 1024 (the backward: a multiple of 32).
    tile_h: int = 8
    tile_w: int = 128
    # Alpha-aware tight tile coverage (pallas backend only): identical images
    # with about half the entries of the reference's 3-sigma circle rects.
    tight_binning: bool = True
    # Capacity of the duplicated (gaussian, tile) entry list; overflow is
    # reported through `truncated`.
    max_dup: int = 1 << 19
    # Early-exit transmittance threshold (forward.cu:563).
    t_eps: float = 1e-4
    # Minimum alpha for a contribution (forward.cu:560).
    alpha_min: float = 1.0 / 255.0
    # Near-plane cull distance (forward.cu:322).
    near: float = 0.2
    # Dilation added to the 2D covariance diagonal (forward.cu:361-364).
    dilation: float = 0.3
    # Cull Gaussians whose max scale exceeds this (forward.cu:351).
    big_limit: float = float("inf")
    # Render-only: differentiating a pallas-backend render made with it
    # raises (its kernel B2 backward is refused). The render_lod entry point
    # forces this on.
    inference: bool = False


@dataclasses.dataclass(frozen=True)
class PostConfig:
    """Hierarchy post-optimization settings (reference train_post.py:63-109)."""

    densify_interval: int = 5000
    lr_multiplier: float = 1.0
    max_cap: int = 50_000_000
    mcmc_densification: bool = True
    mcmc_noise_lr: float = 0.0
    lambda_scaling: float = 0.0
    lambda_opacity: float = 0.01
    # As in the JAX package: no Gaussian_Interpolation, Gradient_Propagation,
    # Propagation_Strength or lambda_hierarchy (the fork never reads them).
    # exact subtree bounding spheres for the SPT frustum culls; False = the
    # node's own 3*max_scale (the reference default, which may clip
    # protruding SPT members)
    use_bounding_spheres: bool = True
    use_occlusion_culling: bool = False
    use_frustum_culling: bool = True
    use_mip_respawn: bool = False
    spt_root_volume: float = 100.0
    spt_target_granularity: float = 0.00228
    min_spt_size: int = 256
    cache_spts: bool = True
    reuse_spt_tolerance: float = 0.9
    max_gaussian_budget: int = 100_000_000
    distance_multiplier_until_budget: float = 1.5
    max_sh_degree: int = 1
    dead_opacity: float = 0.005     # relocate_gs threshold (gaussian_model.py:1594)
    grow_fraction: float = 0.05     # add_new_gs growth per round (gaussian_model.py:1703)


def save_config(path: str, **configs) -> None:
    """Write config dataclasses to JSON as {"ClassName": {field: value}}
    (the reference's `cfg_args` dump, train_single.py:194-206); the JAX
    package writes and reads the same layout."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    out = {type(c).__name__: dataclasses.asdict(c) for c in configs.values()}
    with open(path, "w") as f:
        json.dump(out, f, indent=2, default=float)


def load_config(path: str, overrides: Optional[dict] = None) -> dict:
    """Read saved configs, applying {"ClassName": {field: value}} overrides
    on top (the reference's get_combined_args merge, arguments/__init__.py
    :187-207) -> {class name: instance}. Classes this package does not
    define and fields a class does not have are skipped."""
    classes = {c.__name__: c for c in (ModelConfig, PipelineConfig,
                                       OptimizationConfig, RasterizerConfig,
                                       PostConfig, MeshConfig)}
    with open(path) as f:
        raw = json.load(f)
    out = {}
    for name, kv in raw.items():
        cls = classes.get(name)
        if cls is None:
            continue
        if overrides and name in overrides:
            kv = {**kv, **overrides[name]}
        fields = {f.name for f in dataclasses.fields(cls)}
        out[name] = cls(**{k: v for k, v in kv.items() if k in fields})
    return out


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process mesh layout for multi-process training (JAX config.py
    :194-212). The reference scales out with one SLURM job a chunk
    (scripts/full_train.py:79-236); here chunks and views map onto the
    `data` axis of a torch.distributed world and image bands (or a state's
    rows) onto the `tile` axis. `parallel.data_parallel.make_mesh_from_config`
    consumes it, axis names included; `parallel.tile_parallel` takes
    `tile_axis` as its band axis."""

    data_axis: str = "data"
    tile_axis: str = "tile"
    data: int = 1
    tile: int = 1

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data, self.tile)
