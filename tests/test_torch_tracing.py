"""The port's tracing (`hlod_gaussians_torch/utils/metrics.py`): the
`hlod.*` spans that train_step, render_lod_stream and post_iteration open
are host events on torch.profiler's clock that the profiler does not
mirror onto the device, they change no output, and render_lod_stream and
read_post_step add to `counters` exactly the feedback they read."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hlod_gaussians_torch import render
from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.hierarchy import build, cut
from hlod_gaussians_torch.hierarchy import spt
from hlod_gaussians_torch.models import gaussians as gm
from hlod_gaussians_torch.pipeline import full_train
from hlod_gaussians_torch.train import flat, post
from hlod_gaussians_torch.utils import metrics
from hlod_gaussians_torch.utils.camera import make_camera
from tests.test_torch_post_iteration import (CAP, EXTENT, POST, post_tree,
                                             post_views)

CPU = torch.device("cpu")
W = H = 64
CFG = RasterizerConfig(backend="pallas", tile_w=16, tile_h=16, max_dup=4096)
TRAIN_SPANS = {"hlod.train_step", "hlod.project", "hlod.bin", "hlod.blend",
               "hlod.loss", "hlod.backward", "hlod.adam"}
STREAM_SPANS = {"hlod.lod_stream", "hlod.cut", "hlod.interp", "hlod.project",
                "hlod.bin", "hlod.blend"}
POST_SPANS = {"hlod.post_step", "hlod.spt_cut", "hlod.project", "hlod.bin",
              "hlod.blend", "hlod.loss", "hlod.backward", "hlod.adam"}
ROUND_SPANS = {"hlod.densify", "hlod.rebuild_spt"}
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "cpu",
              "numpy")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: PyTorch's intra-op threads only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera(yaw=0.0):
    a = np.deg2rad(yaw)
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]])
    return make_camera(rot, np.zeros(3), 0.8, 0.8, W, H, device=CPU)


def _train_inputs():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(64, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 4.0
    state = gm.create_from_points(pts, rng.random((64, 3)).astype(np.float32),
                                  capacity=96, sh_degree=1, scene_radius=0.5,
                                  opacity_init=0.5, device=CPU)
    gt = torch.full((3, H, W), 0.4)
    pert = dataclasses.replace(state, f_dc=state.f_dc + 0.3)
    return flat.init_flat_train(pert), gt


def _train(ts, gt, steps=2):
    cam = _camera()
    for _ in range(steps):
        ts, aux = flat.train_step(
            ts, cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
            cam.tan_fovy, gt, torch.zeros(3), exposure_idx=0,
            scene_extent=5.0, cfg=CFG, width=W, height=H, sh_degree=1)
    return ts, aux


@pytest.fixture(scope="module")
def tree():
    rng = np.random.default_rng(13)
    n = 48
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 4.0
    h = build.build_hierarchy(
        pts, np.full((n, 3), 0.05, np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        np.full((n,), 0.8, np.float32),
        rng.random((n, 1, 3)).astype(np.float32) - 0.5, device=CPU)
    t = {k: torch.as_tensor(v) for k, v in dict(
        means3d=h.pos, scales=h.scale, quats=h.quat,
        opacities=np.clip(h.opacity, 0, 1), shs=h.sh, nodes=h.nodes).items()}
    t["alive"] = torch.ones(h.nodes.shape[0], dtype=torch.bool)
    return t


def _stream(tree, frames, crossover, targets=(1e-9, 0.05)):
    """`frames` frames of a yawing camera, the granularity alternating
    between `targets`; returns the images and, after each frame, the
    pending feedback (n_selected, budget) the next frame reads."""
    keys = ("means3d", "scales", "quats", "opacities", "shs")
    table = cut.build_interp_table({k: tree[k] for k in keys}, tree["nodes"])
    state, images, pending = {}, [], []
    for i in range(frames):
        cam = _camera(2.0 * i)
        out, _ = render.render_lod_stream(
            *(tree[k] for k in keys + ("nodes", "alive")), cam.world_view,
            cam.full_proj, cam.campos, cam.tan_fovx, cam.tan_fovy,
            torch.zeros(3), targets[i % len(targets)], state,
            interp_table=table, sh_degree=0, width=W, height=H,
            cfg=CFG, k_max=128, use_frustum=False, min_budget=8,
            md_floor=64, masked_crossover=crossover)
        (fb, _), budget, _ = state["pending"]
        images.append(out.image)
        pending.append((int(fb[0]), budget))
    return images, pending


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("hlod.")]


def test_spans_are_host_events_without_a_device_annotation(tree):
    """Every `hlod.*` event is a CPU event of scope FUNCTION, not a user
    annotation, so the profiler adds no device-side copy of it; each span
    of the train step and of both stream paths is there."""
    ts, gt = _train_inputs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(ts, gt, steps=1)
        _stream(tree, 3, 1e9)
        _stream(tree, 3, 0.0)
    spans = _spans(prof)
    assert spans
    for e in spans:
        assert e.device_type == torch.autograd.DeviceType.CPU, e.name
        assert not e.is_user_annotation, e.name
        assert e.scope == 0, e.name
    names = {e.name for e in spans}
    assert names == TRAIN_SPANS | STREAM_SPANS | {"hlod.compact"}
    # layer spans nest inside their entry point's span
    entry = [e for e in spans if e.name in ("hlod.train_step",
                                            "hlod.lod_stream")]
    for e in spans:
        if e in entry:
            continue
        assert any(p.time_range.start <= e.time_range.start
                   and e.time_range.end <= p.time_range.end
                   for p in entry), e.name


def test_spans_change_no_output(tree, monkeypatch):
    """The train step and the stream give the same tensors bit for bit
    with the spans, under a profiler, and with every span replaced by a
    no-op."""
    def run():
        ts, aux = _train(*_train_inputs())
        images, _ = _stream(tree, 3, 1e9)
        return [ts.gaussians.xyz, ts.gaussians.f_dc, ts.adam.m["xyz"],
                aux.loss, aux.image] + images

    plain = run()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run()
    for mod in (render, flat):
        monkeypatch.setattr(mod, "span",
                            lambda name: contextlib.nullcontext())
    bare = run()
    for a, b, c in zip(plain, traced, bare):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("crossover", [1e9, 0.0], ids=["masked", "budget"])
def test_stream_counts_the_feedback_it_reads(tree, crossover):
    """Each frame reads the previous frame's feedback and adds its nodes
    drawn and rows interpolated: the tree's rows on the masked path, the
    budget on the budgeted one."""
    before = dict(metrics.counters)
    _, pending = _stream(tree, 5, crossover)
    cap = tree["nodes"].shape[0]
    read = pending[:-1]          # the last frame's is still pending
    rows = [cap if b == "MASKED" else b for _, b in read]
    drawn = [min(n, r) for (n, _), r in zip(read, rows)]
    assert all(b == "MASKED" for _, b in read) == (crossover > 1)
    assert 0 < sum(drawn) < sum(rows)
    added = {k: metrics.counters[k] - before.get(k, 0)
             for k in ("lod.nodes_drawn", "lod.rows_interpolated")}
    assert added == {"lod.nodes_drawn": sum(drawn),
                     "lod.rows_interpolated": sum(rows)}


def _post_start():
    """A post state over post_tree's 129 nodes, its forest and one view."""
    ts = post.init_post_train(post.create_from_dhier(
        post_tree(), CAP, scene_radius=EXTENT, n_exposures=8, device=CPU))
    return ts, post.rebuild_spt(ts.gaussians, post=POST), post_views(1)[0]


def _post_step(ts, forest, view, it=0):
    return full_train.post_iteration(
        ts, forest, it, view, torch.zeros(3), EXTENT, post=POST, cfg=CFG,
        densify_every=4, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("it", [3, 4], ids=["step", "round"])
def test_post_step_opens_its_spans(it):
    """post_iteration opens `hlod.post_step` around the cut's
    `hlod.spt_cut`, render_arrays' three spans and post_train_step's
    `hlod.loss`, `hlod.backward` and `hlod.adam`; a step that is due a
    round adds `hlod.densify` and `hlod.rebuild_spt`. Each is a host event
    without a device annotation, inside the entry span."""
    ts, forest, view = _post_start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, fb = _post_step(ts, forest, view, it)
    assert (fb.round is not None) == (it == 4)
    spans = _spans(prof)
    for e in spans:
        assert e.device_type == torch.autograd.DeviceType.CPU, e.name
        assert not e.is_user_annotation and e.scope == 0, e.name
    want = POST_SPANS | (ROUND_SPANS if it == 4 else set())
    assert {e.name for e in spans} == want
    entry, = [e for e in spans if e.name == "hlod.post_step"]
    for e in spans:
        assert (entry.time_range.start <= e.time_range.start
                and e.time_range.end <= entry.time_range.end), e.name


def test_post_step_adds_no_host_read(monkeypatch):
    """The entry point reads nothing back to the host beyond what the cut
    and the step it calls read, and adds no counter: the counters move
    only when read_post_step reads the step."""
    ts, forest, view = _post_start()
    reads = []
    for name in HOST_READS:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    before = dict(metrics.counters)
    _post_step(ts, forest, view)
    entry = list(reads)
    assert dict(metrics.counters) == before
    del reads[:]
    cut = spt.spt_cut_budgeted(forest, CAP, view.campos, view.full_proj,
                               POST.max_gaussian_budget,
                               grow=POST.distance_multiplier_until_budget,
                               use_frustum=POST.use_frustum_culling)
    post.post_train_step(ts, cut.gaussian_mask, view.world_view,
                         view.full_proj, view.campos, view.tan_fovx,
                         view.tan_fovy, view.image, torch.zeros(3), EXTENT,
                         post=POST, cfg=CFG, width=W, height=H, k_max=1024,
                         sh_degree=1)
    assert entry == reads


def test_post_spans_change_no_output(monkeypatch):
    """A post step with a round gives the same state bit for bit with the
    spans, under a profiler, and with every span replaced by a no-op."""
    def run():
        ts, forest, view = _post_start()
        ts, forest, fb = _post_step(ts, forest, view, 4)
        return [ts.gaussians.xyz, ts.gaussians.f_dc, ts.gaussians.nodes,
                ts.adam.m["xyz"], fb.loss, forest.entry_gid]

    plain = run()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run()
    for mod in (render, full_train, post):
        monkeypatch.setattr(mod, "span",
                            lambda name: contextlib.nullcontext())
    bare = run()
    for a, b, c in zip(plain, traced, bare):
        assert torch.equal(a, b) and torch.equal(a, c)
