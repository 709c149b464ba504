"""The per-view entry point of hierarchy post-optimization
(`pipeline/full_train.py::post_iteration`) and its one-copy feedback
(`read_post_step`): `post_optimize` is a loop of the entry point, through
MCMC rounds and their SPT rebuilds, with its log as it was; the feedback
comes over in one copy. Port only, on the CPU (65 leaves, 64x64)."""

import numpy as np
import pytest
import torch

from hlod_gaussians_torch.config import PostConfig, RasterizerConfig
from hlod_gaussians_torch.data.dhier import DHier
from hlod_gaussians_torch.hierarchy import build
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.pipeline import full_train
from hlod_gaussians_torch.train import post
from hlod_gaussians_torch.utils import metrics
from hlod_gaussians_torch.utils.camera import make_camera

CPU = torch.device("cpu")
W = H = 64
CAP = 400
EXTENT = 2.0
CFG = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16, max_dup=4096)
# an SPT cut that forms real SPTs on the 129-node tree
POST = PostConfig(spt_root_volume=5e-3, min_spt_size=4,
                  spt_target_granularity=0.05)
PCFG = full_train.PipelineConfig(post_densify_interval=4)
ITERS = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: PyTorch's intra-op threads only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def post_tree(n=65, seed=0):
    """A 129-node tree (SH 1) of anisotropic, rotated leaves, every 7th
    leaf dead (opacity 0.001), so that a round relocates; f_dc + 0.3."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    pts[:, 2] += 4.0
    scales = (0.06 * np.exp(rng.normal(size=(n, 3)) * 0.4)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    ops = rng.uniform(0.5, 0.95, n).astype(np.float32)
    shs = rng.random((n, 4, 3)).astype(np.float32) - 0.5
    h = build.build_hierarchy(pts, scales, quats, ops, shs, device=CPU)
    op = np.clip(h.opacity, 0.01, 0.99).astype(np.float32)
    leaf = np.where(h.nodes[:, gm.NODE_CHILD_COUNT] == 0)[0]
    op[leaf[::7]] = 0.001
    return DHier(sh_degree=1, pos=h.pos, quat=h.quat,
                 log_scale=np.log(np.maximum(h.scale, 1e-9)).astype(
                     np.float32),
                 opacity=op, shs=h.sh.astype(np.float32) + np.float32(0.3),
                 nodes=h.nodes)


def post_views(n=3):
    """Cameras at the origin, yawing 0.1 rad a view, each with a flat
    grey target."""
    out = []
    for i in range(n):
        a = 0.1 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        out.append(make_camera(R, np.zeros(3, np.float32), 0.9, 0.9, W, H,
                               image=np.full((3, H, W), 0.4, np.float32),
                               device=CPU))
    return out


class Log:
    def __init__(self):
        self.lines = []

    def log(self, **kv):
        self.lines.append(kv)


def test_post_optimize_is_a_loop_of_the_entry_point(monkeypatch):
    """post_optimize takes every step through post_iteration, once an
    iteration and in order; its log keeps its fields and their types, with
    one MCMC round at step 4 and 8; and the counters add up the steps it
    reads (every third) and no other. Its results against the JAX loop
    are tests/test_torch_post.py's."""
    calls = []

    def counted(ts, forest, it, *a, _orig=full_train.post_iteration, **kw):
        calls.append(it)
        return _orig(ts, forest, it, *a, **kw)
    monkeypatch.setattr(full_train, "post_iteration", counted)
    before = dict(metrics.counters)
    log = Log()
    got = full_train.post_optimize(post_tree(), post_views(), EXTENT, ITERS,
                                   CAP, post=POST, cfg=CFG, pcfg=PCFG,
                                   logger=log, log_every=3, device=CPU)

    assert calls == list(range(ITERS)) and got.step == ITERS
    rounds = [kv for kv in log.lines if kv["stage"] == "post_densify"]
    assert [kv["it"] for kv in rounds] == [4, 8]
    assert rounds[0]["n_relocated"] > 0
    assert all(kv["densify_s"] >= 0 and kv["rebuild_s"] >= 0
               for kv in rounds)
    steps = [kv for kv in log.lines if kv["stage"] == "post"]
    assert [kv["it"] for kv in steps] == list(range(0, ITERS, 3))
    for kv in steps:
        assert list(kv) == ["stage", "it", "loss", "n_rendered", "n_cut",
                            "truncated"]
        assert type(kv["loss"]) is float and np.isfinite(kv["loss"])
        assert type(kv["n_rendered"]) is int and type(kv["n_cut"]) is int
        assert kv["truncated"] is False
        assert 0 < kv["n_rendered"] <= kv["n_cut"] < CAP
    assert metrics.counters["post.ws_rows"] - before.get(
        "post.ws_rows", 0) == sum(kv["n_cut"] for kv in steps)
    assert metrics.counters["post.rows_projected"] - before.get(
        "post.rows_projected", 0) == CAP * len(steps)


def test_read_post_step_is_the_step_in_one_copy(monkeypatch):
    """read_post_step gives the feedback's values as their own host reads
    would, with one tolist and no other read, and adds the working-set
    and capacity rows to the counters."""
    d, views = post_tree(), post_views(1)
    ts = post.init_post_train(post.create_from_dhier(
        d, CAP, scene_radius=EXTENT, n_exposures=8, device=CPU))
    forest = post.rebuild_spt(ts.gaussians, post=POST)
    _, _, fb = full_train.post_iteration(
        ts, forest, 0, views[0], torch.zeros(3), EXTENT, post=POST, cfg=CFG)
    assert fb.round is None and fb.rows_projected == CAP
    want = dict(loss=float(fb.loss), n_rendered=int(fb.n_rendered),
                n_cut=int(fb.n_cut), truncated=bool(fb.truncated))
    reads = []
    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "cpu", "numpy"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    before = dict(metrics.counters)
    got = full_train.read_post_step(fb)
    monkeypatch.undo()
    assert reads == ["tolist"]
    assert got == want
    assert metrics.counters["post.ws_rows"] - before.get(
        "post.ws_rows", 0) == want["n_cut"]
    assert metrics.counters["post.rows_projected"] - before.get(
        "post.rows_projected", 0) == CAP
