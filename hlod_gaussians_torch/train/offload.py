"""Out-of-core post-optimization: host-resident parameters, device working
sets (port of hlod_gaussians_tpu/train/offload.py; reference
scene/gaussian_model.py:399-492 and the [WRITE-BACK]/[LOAD] phases of
train_post.py:440-479).

All Gaussians and their Adam moments live in host memory; each view's SPT
cut names the rows it trains, those rows go to the card, one step renders
(kernel B1), differentiates (kernel B2) and applies masked Adam to them, and
the updated rows come back. On a CUDA device the host tensors are
page-locked (pinned), so copies between them and the card run
asynchronously. Four forms, as in the JAX package:

* `make_offloaded_step` over a `HostStore` (per-key host tensors with one
  scratch row that padding lanes write to);
* `make_numpy_offloaded_step` over a `NumpyStore` (numpy fancy indexing);
* `make_packed_offloaded_step` over a `PackedStore`: parameters and moments
  packed into one [cap, D] float32 matrix, one gather and one scatter a
  step;
* `DeviceResidentTrainer`: the card keeps `budget` row slots of the packed
  store, and a step pages only the rows that entered or left the working
  set (the fork's SPT cache). `post_optimize_offloaded` drives it over
  `CachedCutter`'s cuts with the next view's rows prefetched.

Left out: the JAX package's pinned_host XLA placement (`host_memory_kind`
and its shardings), its transposed [D, budget] slot buffer, power-of-two
bucket padding and three-program split, which only serve the TPU runtime
and XLA's compiles.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hlod_gaussians_torch import optim, render as render_mod
from hlod_gaussians_torch.config import (OptimizationConfig, PostConfig,
                                         RasterizerConfig)
from hlod_gaussians_torch.hierarchy import spt as spt_mod
from hlod_gaussians_torch.models.gaussians import GaussianState
from hlod_gaussians_torch.ops import ssim as ssim_ops

_ROW_KEYS = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit")


def host_empty(shape, device, dtype=torch.float32) -> torch.Tensor:
    """An uninitialized CPU tensor serving `device`: page-locked when the
    device is a CUDA device, so copies to and from it are asynchronous."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array on `device`; through page-locked memory to a CUDA
    device, so the copy does not wait for the device."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostStore(NamedTuple):
    """Host master storage: parameters + Adam moments, [cap + 1, ...] each
    (the last row is the scratch row)."""

    params: Dict[str, torch.Tensor]
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: int


def to_host_store(state: GaussianState,
                  adam: Optional[optim.AdamState] = None) -> HostStore:
    """The state's rows (and moments, zero without `adam`) in host memory,
    pinned when the state lies on a CUDA device, each with ONE extra
    SCRATCH row (index cap): the write-back routes padding lanes there, so
    they never clobber a real row. Fetches clip to cap-1, so the scratch row
    is never read back."""
    dev = state.xyz.device

    def pad1(x):
        out = host_empty((x.shape[0] + 1,) + tuple(x.shape[1:]), dev)
        out[:-1] = x.detach().cpu()
        out[-1] = 0.0
        return out

    if adam is None:
        adam = optim.init_adam(state.params())
    return HostStore(params={k: pad1(getattr(state, k)) for k in _ROW_KEYS},
                     m={k: pad1(adam.m[k]) for k in _ROW_KEYS},
                     v={k: pad1(adam.v[k]) for k in _ROW_KEYS},
                     step=int(adam.step))


def from_host_store(store: HostStore, template: GaussianState
                    ) -> Tuple[GaussianState, optim.AdamState]:
    """The store's rows back in a state on the template's device (the
    template supplies the node table, alive mask and exposure table)."""
    dev = template.xyz.device
    state = template.replace_params(
        {k: store.params[k][:-1].to(dev) for k in _ROW_KEYS})
    exp = template.exposure
    adam = optim.AdamState(
        m={**{k: store.m[k][:-1].to(dev) for k in _ROW_KEYS},
           "exposure": torch.zeros_like(exp)},
        v={**{k: store.v[k][:-1].to(dev) for k in _ROW_KEYS},
           "exposure": torch.zeros_like(exp)},
        step=store.step)
    return state, adam


def _compute_phase(
    rows, m_rows, v_rows, step_count: int,
    idx_valid: torch.Tensor,    # [K] bool
    world_view, full_proj, campos, tan_fovx, tan_fovy,
    gt_image, bg,
    *,
    opt, post, cfg, width, height, k_max, sh_degree, antialiasing,
    scene_extent,
):
    """Device phase: render + backward + masked Adam on compact rows ->
    (new params, new m, new v, loss, visible rows). Lanes outside
    `idx_valid` keep their input values."""
    p = {k: rows[k].detach().requires_grad_(True) for k in _ROW_KEYS}
    q = p["quat"] / torch.linalg.norm(p["quat"], dim=-1,
                                      keepdim=True).clamp_min(1e-12)
    shs = torch.cat([p["f_dc"], p["f_rest"]], dim=1)
    out = render_mod.render_arrays(
        p["xyz"], torch.exp(p["log_scale"]), q,
        torch.sigmoid(p["opacity_logit"][..., 0]), shs, idx_valid,
        world_view, full_proj, campos, tan_fovx, tan_fovy, bg,
        sh_degree=sh_degree, width=width, height=height, cfg=cfg,
        k_max=k_max, antialiasing=antialiasing)
    image = out.image
    l1 = torch.abs(image - gt_image).mean()
    ssim_v = ssim_ops.ssim(image, gt_image)
    loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1.0 - ssim_v)
    n_ws = torch.clamp_min(torch.sum(idx_valid), 1)
    if post.lambda_opacity > 0:
        op = torch.sigmoid(p["opacity_logit"][:, 0])
        loss = loss + post.lambda_opacity * torch.sum(
            torch.where(idx_valid, torch.abs(op), 0.0)) / n_ws
    if post.lambda_scaling > 0:
        sc = torch.exp(p["log_scale"])
        loss = loss + post.lambda_scaling * torch.sum(
            torch.where(idx_valid[:, None], torch.abs(sc), 0.0)) / n_ws
    grads = dict(zip(_ROW_KEYS, torch.autograd.grad(
        loss, [p[k] for k in _ROW_KEYS])))

    lrs = optim.param_lrs(opt, step_count, scene_extent)
    visible = out.visible & idx_valid
    new_rows, adam2 = optim.sparse_adam_update(
        {k: p[k].detach() for k in _ROW_KEYS}, grads,
        optim.AdamState(m=m_rows, v=v_rows, step=step_count),
        {k: lrs[k] for k in _ROW_KEYS}, visible=visible)

    def keep_valid(upd, old):
        msk = idx_valid.reshape((-1,) + (1,) * (upd.ndim - 1))
        return torch.where(msk, upd, old)

    new_p = {k: keep_valid(new_rows[k], rows[k]) for k in _ROW_KEYS}
    new_m = {k: keep_valid(adam2.m[k], m_rows[k]) for k in _ROW_KEYS}
    new_v = {k: keep_valid(adam2.v[k], v_rows[k]) for k in _ROW_KEYS}
    return (new_p, new_m, new_v, loss.detach(), torch.sum(visible),
            out.truncated)


def _compute_kwargs(opt, post, cfg, width, height, k_max, sh_degree,
                    antialiasing, scene_extent):
    return dict(opt=opt, post=post, cfg=cfg, width=width, height=height,
                k_max=k_max, sh_degree=sh_degree, antialiasing=antialiasing,
                scene_extent=scene_extent)


def make_offloaded_step(
    *,
    opt: OptimizationConfig = OptimizationConfig(),
    post: PostConfig = PostConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    width: int, height: int, k_max: int = 1024,
    sh_degree: int = 1,
    antialiasing: bool = False,
    scene_extent: float = 1.0,
):
    """The out-of-core step over a HostStore: gather the indexed rows from
    the host tensors, copy them to the camera's device, compute, and
    scatter the result back (padding lanes into the scratch row).

    step(store, idx [K], idx_valid [K], camera..., gt_image, bg) ->
    (store with step + 1, loss, visible rows). The store's tensors are
    updated in place."""
    kw = _compute_kwargs(opt, post, cfg, width, height, k_max, sh_degree,
                         antialiasing, scene_extent)

    def step(store: HostStore, idx, idx_valid, world_view, full_proj,
             campos, tan_fovx, tan_fovy, gt_image, bg):
        dev = world_view.device
        cap = store.params["xyz"].shape[0] - 1     # last row = scratch
        idx_c = torch.clamp(torch.as_tensor(idx).cpu().long(), 0, cap - 1)
        valid_h = torch.as_tensor(idx_valid).cpu()
        idx_wb = torch.where(valid_h, idx_c, cap)

        def fetch(group):
            return {k: group[k].index_select(0, idx_c).to(dev)
                    for k in _ROW_KEYS}

        new_p, new_m, new_v, loss, n_vis, _ = _compute_phase(
            fetch(store.params), fetch(store.m), fetch(store.v), store.step,
            valid_h.to(dev), world_view, full_proj, campos, tan_fovx,
            tan_fovy, gt_image, bg, **kw)
        for group, new in ((store.params, new_p), (store.m, new_m),
                           (store.v, new_v)):
            for k in _ROW_KEYS:
                group[k].index_copy_(0, idx_wb, new[k].cpu())
        return store._replace(step=store.step + 1), loss, n_vis

    return step


def cut_to_indices(mask: torch.Tensor, budget: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact a working-set mask into a padded index list -> (idx [budget]
    int32, padded with cap; idx < cap), with no host sync.

    Rows past `budget` are DROPPED (as jnp.nonzero truncates at `size`);
    `spt_cut_budgeted` can return an over-budget cut when even its largest
    distance multiplier does not fit, so offloaded callers compare the
    cut's n_selected with `budget`."""
    cap = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    keep = mask & (pos < budget)
    out = torch.full((budget + 1,), cap, dtype=torch.int32,
                     device=mask.device)
    # rows not kept all land in the spare slot `budget`, cut off below
    out[torch.where(keep, pos, budget)] = torch.arange(
        cap, dtype=torch.int32, device=mask.device)
    idx = out[:budget]
    return idx, idx < cap


def reuse_diff(prev_idx, prev_dist: torch.Tensor, new_dist: torch.Tensor,
               rtol: float):
    """The fork's SPT cache reuse rule (train_post.py:362-394): an SPT's
    resident rows can be kept when its camera distance changed by less than
    `rtol` relative. Returns a bool mask over the previous SPT set."""
    lo = prev_dist * rtol
    hi = prev_dist / max(rtol, 1e-6)
    return (new_dist >= lo) & (new_dist <= hi)


def post_optimize_offloaded(
    store: "PackedStore",
    forest: spt_mod.SPTForest,
    views,
    *,
    budget: int,
    post: PostConfig = PostConfig(),
    opt: OptimizationConfig = OptimizationConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    width: int, height: int, k_max: int = 1024,
    scene_extent: float = 1.0,
    n_iters: Optional[int] = None,
    bg: Optional[torch.Tensor] = None,
    device=torch.device("cuda"),
):
    """Out-of-core post-training loop (the reference train_post,
    train_post.py:323-491): per view the SPT cut with the cache reuse rule,
    the device-resident row cache paging only the cut's delta, and the next
    view's rows gathered while the card runs the current step. The packed
    host store may exceed device memory many times over (50M rows = ~14 GB
    at SH 1). `views` are Cameras with their target `image`; the forest
    lies on `device`.

    Returns (trainer, losses). The caller flushes the trainer to bring the
    store up to date."""
    trainer = DeviceResidentTrainer(
        store, budget, opt=opt, post=post, cfg=cfg, width=width,
        height=height, k_max=k_max, scene_extent=scene_extent, device=device)
    cutter = CachedCutter(forest, store.capacity, post)
    bg = torch.zeros(3, device=device) if bg is None else bg
    n_iters = len(views) if n_iters is None else n_iters

    def rows_for(v):
        c = cutter.cut(v.campos, v.full_proj)
        idx, valid = cut_to_indices(c.gaussian_mask, budget)
        return idx[valid].cpu().numpy()

    losses = []
    next_rows = rows_for(views[0])
    for it in range(n_iters):
        v = views[it % len(views)]
        rows = next_rows
        if it + 1 < n_iters:
            next_rows = rows_for(views[(it + 1) % len(views)])
        else:
            next_rows = None
        loss, _ = trainer.step(
            rows, v.world_view, v.full_proj, v.campos, v.tan_fovx,
            v.tan_fovy, v.image, bg, prefetch_rows=next_rows)
        losses.append(loss)
    return trainer, losses


class CachedCutter:
    """Per-view SPT working-set cuts with the fork's cache-reuse rule.

    Wires PostConfig.cache_spts + reuse_spt_tolerance: with caching on,
    SPTs whose camera distance moved < rtol keep the PREVIOUS view's cut
    distance, so their rows are the same frame to frame and the out-of-core
    cache (DeviceResidentTrainer) pages only the real delta
    (train_post.py:323-394)."""

    def __init__(self, forest: spt_mod.SPTForest, capacity: int,
                 post: PostConfig = PostConfig(),
                 use_frustum: Optional[bool] = None):
        self.forest = forest
        self.capacity = capacity
        self.post = post
        self.use_frustum = (post.use_frustum_culling
                            if use_frustum is None else use_frustum)
        self._prev = None

    def cut(self, campos, full_proj, distance_multiplier=1.0
            ) -> spt_mod.SPTCut:
        if not self.post.cache_spts or self._prev is None:
            c = spt_mod.spt_cut(
                self.forest, self.capacity, campos, full_proj,
                distance_multiplier, use_frustum=self.use_frustum)
        else:
            sel, dist = self._prev
            c = spt_mod.spt_cut_cached(
                self.forest, self.capacity, campos, full_proj, sel, dist,
                self.post.reuse_spt_tolerance, distance_multiplier,
                use_frustum=self.use_frustum)
        if self.post.cache_spts:
            self._prev = (c.spt_selected, c.spt_distance)
        return c


class NumpyStore:
    """Mutable numpy master storage (the plain out-of-core backend)."""

    def __init__(self, params: Dict[str, np.ndarray],
                 m: Dict[str, np.ndarray], v: Dict[str, np.ndarray],
                 step: int = 0):
        self.params = params
        self.m = m
        self.v = v
        self.step = step

    @property
    def capacity(self) -> int:
        return self.params["xyz"].shape[0]


def to_numpy_store(state: GaussianState,
                   adam: Optional[optim.AdamState] = None) -> NumpyStore:
    def host(t):
        return t.detach().cpu().numpy().copy()

    params = {k: host(getattr(state, k)) for k in _ROW_KEYS}
    if adam is None:
        return NumpyStore(params,
                          {k: np.zeros_like(params[k]) for k in _ROW_KEYS},
                          {k: np.zeros_like(params[k]) for k in _ROW_KEYS})
    return NumpyStore(params, {k: host(adam.m[k]) for k in _ROW_KEYS},
                      {k: host(adam.v[k]) for k in _ROW_KEYS},
                      step=int(adam.step))


def make_numpy_offloaded_step(
    *,
    opt: OptimizationConfig = OptimizationConfig(),
    post: PostConfig = PostConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    width: int, height: int, k_max: int = 1024,
    sh_degree: int = 1,
    antialiasing: bool = False,
    scene_extent: float = 1.0,
):
    """Out-of-core step over a NumpyStore: numpy gather -> device compute
    on the camera's device -> numpy write-back (the reference's paging
    loop, train_post.py:440-479). Indices >= capacity are padding."""
    kw = _compute_kwargs(opt, post, cfg, width, height, k_max, sh_degree,
                         antialiasing, scene_extent)

    def step(store: NumpyStore, idx_np: np.ndarray, world_view, full_proj,
             campos, tan_fovx, tan_fovy, gt_image, bg):
        dev = world_view.device
        valid_np = idx_np < store.capacity
        idx_c = np.minimum(idx_np, store.capacity - 1)

        def fetch(group):
            return {k: torch.as_tensor(group[k][idx_c], device=dev)
                    for k in _ROW_KEYS}

        new_p, new_m, new_v, loss, n_vis, _ = _compute_phase(
            fetch(store.params), fetch(store.m), fetch(store.v), store.step,
            torch.as_tensor(valid_np, device=dev), world_view, full_proj,
            campos, tan_fovx, tan_fovy, gt_image, bg, **kw)

        wb = idx_c[valid_np]
        for group, new in ((store.params, new_p), (store.m, new_m),
                           (store.v, new_v)):
            for k in _ROW_KEYS:
                group[k][wb] = new[k].cpu().numpy()[valid_np]
        store.step += 1
        return loss, n_vis

    return step


# ---------------------------------------------------------------------------
# Packed layout and the device-resident row cache
# ---------------------------------------------------------------------------
#
# The packed store holds params + Adam moments as ONE row-major [cap, D]
# float32 matrix, so paging a row set is one gather and one copy. The device
# side unpacks and repacks by column slices.

def _packed_layout(sh_degree: int):
    """Column layout of one packed row: params then m then v, each group the
    keys of _ROW_KEYS -> ({(group, key): (lo, hi)}, D, SH rest coeffs). At
    SH 1 a row is D = 69 float32 values."""
    k_rest = {0: 0, 1: 3, 2: 8, 3: 15}[sh_degree]
    sizes = dict(xyz=3, f_dc=3, f_rest=3 * k_rest, log_scale=3, quat=4,
                 opacity_logit=1)
    cols = {}
    off = 0
    for group in ("p", "m", "v"):
        for k in _ROW_KEYS:
            cols[(group, k)] = (off, off + sizes[k])
            off += sizes[k]
    return cols, off, k_rest


def pack_store(state: GaussianState,
               adam: Optional[optim.AdamState] = None,
               device=None) -> torch.Tensor:
    """GaussianState (+Adam) -> packed [cap, D] float32 host tensor, pinned
    when `device` (default: the state's) is a CUDA device. Moments are zero
    without `adam`."""
    device = state.xyz.device if device is None else device
    cols, d, _ = _packed_layout(state.sh_degree)
    cap = state.capacity
    out = host_empty((cap, d), device)
    out.zero_()

    def put(group, key, t):
        lo, hi = cols[(group, key)]
        out[:, lo:hi] = t.detach().reshape(cap, -1).cpu()

    for k in _ROW_KEYS:
        put("p", k, getattr(state, k))
        if adam is not None:
            put("m", k, adam.m[k])
            put("v", k, adam.v[k])
    return out


def unpack_rows(packed: torch.Tensor, sh_degree: int):
    """[K, D] rows -> (params dict, m dict, v dict) of column views."""
    cols, _, k_rest = _packed_layout(sh_degree)
    k = packed.shape[0]
    shapes = dict(xyz=(k, 3), f_dc=(k, 1, 3), f_rest=(k, k_rest, 3),
                  log_scale=(k, 3), quat=(k, 4), opacity_logit=(k, 1))

    def grab(group):
        return {key: packed[:, cols[(group, key)][0]:cols[(group, key)][1]]
                .reshape(shapes[key]) for key in _ROW_KEYS}

    return grab("p"), grab("m"), grab("v")


def pack_rows(p: Dict, m: Dict, v: Dict, sh_degree: int) -> torch.Tensor:
    """(params, m, v) row dicts -> [K, D] packed matrix on their device."""
    k = p["xyz"].shape[0]
    return torch.cat([src[key].reshape(k, -1) for src in (p, m, v)
                      for key in _ROW_KEYS], dim=1)


class PackedStore:
    """Packed mutable host store: params + Adam moments in one [cap, D]
    float32 CPU tensor (`data`; pinned when it serves a CUDA device), whose
    `data.numpy()` view shares its memory."""

    def __init__(self, packed: torch.Tensor, sh_degree: int, step: int = 0):
        self.data = packed
        self.sh_degree = sh_degree
        self.step = step

    @classmethod
    def from_state(cls, state: GaussianState,
                   adam: Optional[optim.AdamState] = None,
                   device=None) -> "PackedStore":
        return cls(pack_store(state, adam, device), state.sh_degree,
                   step=0 if adam is None else int(adam.step))

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


def make_packed_offloaded_step(
    *,
    opt: OptimizationConfig = OptimizationConfig(),
    post: PostConfig = PostConfig(),
    cfg: RasterizerConfig = RasterizerConfig(),
    width: int, height: int, k_max: int = 1024,
    sh_degree: int = 1,
    antialiasing: bool = False,
    scene_extent: float = 1.0,
):
    """Returns (dispatch, writeback): the two host-side halves of a step
    over a PackedStore.

    dispatch(store, idx_np, camera..., gt_image, bg) -> handle: gathers the
    rows, copies them to the camera's device and queues the compute
    (returns without waiting for the device).
    writeback(store, handle) -> (loss, visible rows): waits for the result
    and scatters it into the store.
    """
    kw = _compute_kwargs(opt, post, cfg, width, height, k_max, sh_degree,
                         antialiasing, scene_extent)

    def dispatch(store: PackedStore, idx_np, world_view, full_proj, campos,
                 tan_fovx, tan_fovy, gt_image, bg):
        dev = world_view.device
        valid_np = idx_np < store.capacity
        idx_c = np.minimum(idx_np, store.capacity - 1)
        staged = host_empty((len(idx_c), store.data.shape[1]), dev)
        torch.index_select(store.data, 0, torch.from_numpy(
            idx_c.astype(np.int64)), out=staged)
        rows, m_rows, v_rows = unpack_rows(
            staged.to(dev, non_blocking=True), sh_degree)
        new_p, new_m, new_v, loss, n_vis, _ = _compute_phase(
            rows, m_rows, v_rows, store.step,
            _to_device(valid_np, dev), world_view, full_proj, campos,
            tan_fovx, tan_fovy, gt_image, bg, **kw)
        store.step += 1
        return pack_rows(new_p, new_m, new_v, sh_degree), loss, n_vis, \
            idx_c, valid_np

    def writeback(store: PackedStore, handle):
        packed_new, loss, n_vis, idx_c, valid_np = handle
        store.data.numpy()[idx_c[valid_np]] = \
            packed_new.cpu().numpy()[valid_np]
        return loss, n_vis

    return dispatch, writeback


class DeviceResidentTrainer:
    """Out-of-core training with a device-resident working-set cache.

    The reference's SPT cache (train_post.py:323-491): parameters + Adam
    moments live packed in host memory; the device owns `budget` row slots
    (`buf`, [budget, D]). Per view, rows ENTERING the working set are
    fetched, rows LEAVING are read back and scattered into the host store,
    and retained rows never move, so a step's transfer follows the cut's
    DELTA. Every row has exactly one live copy, so the results equal the
    sequential paging path's.

    Slots are assigned as the JAX package assigns them (`free` starts as
    budget-1 ... 0, and a fetch takes slots from the front of free +
    evicted slots), so `slot_of_row` and `row_of_slot` match it row for
    row.

    On a CUDA device `step` does not wait for its own compute: the missing
    rows are gathered into page-locked memory and copied on a side stream
    that the compute stream waits for before the slot write; the evicted
    rows are copied back asynchronously and land in the store at the start
    of the next `prepare` (or `flush`), before anything is gathered from
    it. That landing is the one wait, for the copy queued before the
    current compute.
    """

    def __init__(self, store: PackedStore, budget: int, *,
                 opt: OptimizationConfig = OptimizationConfig(),
                 post: PostConfig = PostConfig(),
                 cfg: RasterizerConfig = RasterizerConfig(),
                 width: int, height: int, k_max: int = 1024,
                 antialiasing: bool = False, scene_extent: float = 1.0,
                 device=torch.device("cuda")):
        self.store = store
        self.budget = budget
        self.sh_degree = store.sh_degree
        self.device = torch.device(device)
        self.slot_of_row = np.full(store.capacity, -1, np.int32)
        self.row_of_slot = np.full(budget, -1, np.int32)
        self._need = np.zeros(store.capacity, bool)   # scratch, reset per use
        self.free = np.arange(budget - 1, -1, -1, dtype=np.int32)
        self.buf = torch.zeros((budget, store.data.shape[1]),
                               device=self.device)
        self.valid = torch.zeros((budget,), dtype=torch.bool,
                                 device=self.device)
        self._kw = _compute_kwargs(opt, post, cfg, width, height, k_max,
                                   store.sh_degree, antialiasing,
                                   scene_extent)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._pending = None      # evicted rows still on their way back
        self._prefetched = None
        self.last_fetch = 0
        self.last_evict = 0
        self.last_truncated = None

    def _land_writeback(self) -> None:
        """Scatter the rows the last apply() evicted into the store."""
        if self._pending is None:
            return
        rows, vals, done = self._pending
        if done is not None:
            done.synchronize()
        self.store.data.index_copy_(0, rows, vals)
        self._pending = None

    def prepare(self, rows_needed: np.ndarray) -> dict:
        """HOST half of the cache sync: land the last write-back, compute
        the evict/fetch sets and gather the missing rows from the store,
        their copy to the device queued. Safe while the device still runs
        the previous step (the prefetch overlap of the reference's [LOAD]
        phase, train_post.py:440-479)."""
        self._land_writeback()
        rows_needed = np.asarray(rows_needed, np.int32)
        # the `need` flags stay allocated and are reset sparsely, and
        # residency is enumerated through the budget-sized row_of_slot, so
        # this costs O(working set), not O(store)
        self._need[rows_needed] = True
        res_rows = self.row_of_slot[self.row_of_slot >= 0]
        ev_rows = res_rows[~self._need[res_rows]]
        miss_rows = np.unique(
            rows_needed[self.slot_of_row[rows_needed] < 0]).astype(np.int32)
        self._need[rows_needed] = False
        if len(miss_rows) > len(self.free) + len(ev_rows):
            n_ws = len(res_rows) - len(ev_rows) + len(miss_rows)
            raise RuntimeError(f"working set {n_ws} rows > budget "
                               f"{self.budget}")
        staged = ready = None
        if len(miss_rows):
            idx = torch.from_numpy(miss_rows.astype(np.int64))
            host = host_empty((len(miss_rows), self.store.data.shape[1]),
                              self.device)
            torch.index_select(self.store.data, 0, idx, out=host)
            if self._copy_stream is None:
                staged = host.to(self.device)
            else:
                with torch.cuda.stream(self._copy_stream):
                    staged = host.to(self.device, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(self._copy_stream)
        return dict(evict=ev_rows, missing=miss_rows, staged=staged,
                    ready=ready)

    def apply(self, prep: dict) -> None:
        """DEVICE/bookkeeping half: read back the evicted slots, then write
        the staged rows into their slots (the read is queued first, so a
        fetched row may reuse a just-evicted slot). The evicted values land
        in the store at the next prepare() or flush()."""
        ev_rows, miss = prep["evict"], prep["missing"]
        self.last_fetch, self.last_evict = len(miss), len(ev_rows)
        if not len(ev_rows) and not len(miss):
            return
        ev_slots = self.slot_of_row[ev_rows]
        pool = np.concatenate([self.free, ev_slots])
        slots = pool[:len(miss)]
        self.free = pool[len(miss):]

        if len(ev_rows):
            ev_idx = _to_device(ev_slots.astype(np.int64), self.device)
            vals = self.buf.index_select(0, ev_idx)
            self.valid.index_fill_(0, ev_idx, False)
            done = None
            if self._copy_stream is not None:
                host = host_empty(vals.shape, self.device)
                host.copy_(vals, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                vals = host
            self._pending = (torch.from_numpy(ev_rows.astype(np.int64)),
                             vals, done)
            self.slot_of_row[ev_rows] = -1
            self.row_of_slot[ev_slots] = -1
        if len(miss):
            staged = prep["staged"]
            if prep["ready"] is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(prep["ready"])
                staged.record_stream(stream)
            sl = _to_device(slots.astype(np.int64), self.device)
            self.buf.index_copy_(0, sl, staged)
            self.valid.index_fill_(0, sl, True)
            self.slot_of_row[miss] = slots
            self.row_of_slot[slots] = miss
        if self._copy_stream is None:
            self._land_writeback()

    def _sync(self, rows_needed: np.ndarray) -> None:
        """Evict slots whose rows left the set; fetch missing rows."""
        self.apply(self.prepare(rows_needed))

    def step(self, rows_needed: np.ndarray, world_view, full_proj, campos,
             tan_fovx, tan_fovy, gt_image, bg,
             prefetch_rows: Optional[np.ndarray] = None):
        """One training step on the given working-set rows (host indices)
        -> (loss, visible rows), device tensors.

        With ``prefetch_rows`` (the NEXT view's working set) the host
        gathers the next delta while the device runs this step; the next
        step() call with those rows consumes it."""
        rows_needed = np.asarray(rows_needed, np.int32)
        if self._prefetched is not None and np.array_equal(
                self._prefetched[0], rows_needed):
            self.apply(self._prefetched[1])
        else:
            self._sync(rows_needed)
        self._prefetched = None
        rows, m_rows, v_rows = unpack_rows(self.buf, self.sh_degree)
        new_p, new_m, new_v, loss, n_vis, truncated = _compute_phase(
            rows, m_rows, v_rows, self.store.step, self.valid, world_view,
            full_proj, campos, tan_fovx, tan_fovy, gt_image, bg, **self._kw)
        self.buf = pack_rows(new_p, new_m, new_v, self.sh_degree)
        self.last_truncated = truncated
        self.store.step += 1
        if prefetch_rows is not None:
            prefetch_rows = np.asarray(prefetch_rows, np.int32)
            self._prefetched = (prefetch_rows, self.prepare(prefetch_rows))
        return loss, n_vis

    def flush(self) -> None:
        """Write every resident row back to the host store."""
        self._land_writeback()
        rows = np.where(self.slot_of_row >= 0)[0]
        if len(rows):
            slots = _to_device(self.slot_of_row[rows].astype(np.int64),
                               self.device)
            self.store.data.index_copy_(
                0, torch.from_numpy(rows.astype(np.int64)),
                self.buf.index_select(0, slots).cpu())
