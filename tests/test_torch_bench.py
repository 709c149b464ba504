"""bench_torch.py, the port's twin of bench.py, against the JAX package on
the CPU at small sizes: the train-style step (bench.py:60-91) against the
same step built from the JAX package's render_arrays and jax.grad (its
Pallas kernels in interpret mode), the LOD bench tree against the JAX
build on bench.py's draws (bench.py:147-158) node for node, one stream
frame at tau 0 and 15 against JAX render_lod_stream, and main()'s line.

Tolerances: the loss rtol 1e-5 and each gradient atol 3e-4 of its largest
JAX magnitude (the reference's scaled-gradient bound,
test_rasterize_pallas.py:80-147); the tree's nodes exactly and its float
fields at tests/test_torch_hier_build.py's tolerances; stream images atol
1e-4 (the LOD paths' bound in chip_smoke.py)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from hlod_gaussians_tpu import render as jrender
from hlod_gaussians_tpu.config import RasterizerConfig as JConfig
from hlod_gaussians_tpu.hierarchy import build as jbuild
from hlod_gaussians_tpu.hierarchy import cut as jcut
from hlod_gaussians_tpu.utils import camera as jcam
from test_torch_hier_build import _assert_moments

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline",
              "lod_stream_tau0_mpix_s", "lod_stream_tau15_mpix_s")
STEP = dict(width=160, height=96, n_pts=2000, max_dup=1 << 13)
N_LEAVES = 1 << 10
STREAM_W, STREAM_H, STREAM_MAX_DUP = 128, 96, 1 << 14


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: PyTorch's intra-op threads only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench_py_draws(n):
    """bench.py:147-158's leaves, written out here as bench.py has them."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 10.0
    pts[:, 2] += 30.0
    scales = np.exp(rng.normal(size=(n, 3)) * 0.3 - 3.2).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    ops = rng.uniform(0.3, 0.9, n).astype(np.float32)
    shs = rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3
    return pts, scales, quats, ops, shs


def _jax_step(p, width, height, max_dup):
    """bench.py's step (bench.py:60-91) on the CPU: (loss, grads,
    truncated)."""
    n = p["xyz"].shape[0]
    cam = jcam.make_camera(np.eye(3), np.zeros(3), fovx=1.2, fovy=0.8,
                           width=width, height=height)
    cfg = JConfig(backend="pallas", tile_w=32, tile_h=32, max_dup=max_dup,
                  tight_binning=True)
    gt = jnp.zeros((3, height, width), jnp.float32)
    valid = jnp.ones((n,), bool)

    def render(xyz, log_scale, quat, op_logit, f_dc, f_rest):
        q = quat / jnp.linalg.norm(quat, axis=-1, keepdims=True).clip(1e-12)
        shs = jnp.concatenate([f_dc, f_rest], axis=1)
        return jrender.render_arrays(
            xyz, jnp.exp(log_scale), q, jax.nn.sigmoid(op_logit[..., 0]),
            shs, valid, cam.world_view, cam.full_proj, cam.campos,
            cam.tan_fovx, cam.tan_fovy, jnp.zeros(3), sh_degree=3,
            width=width, height=height, cfg=cfg, k_max=384)

    def loss_fn(*args):
        out = render(*args)
        return jnp.abs(out.image - gt).mean(), out.truncated

    args = tuple(jnp.asarray(p[k]) for k in bench_torch.STEP_KEYS)
    (loss, trunc), grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2, 3, 4, 5), has_aux=True))(*args)
    return float(loss), [np.asarray(g) for g in grads], bool(trunc)


def test_bench_step_matches_jax():
    leaves, render = bench_torch.bench_step(CPU, **STEP)
    with torch.no_grad():
        assert not bool(render(*leaves).truncated)
    loss, grads = bench_torch.step_grads(render, leaves)
    j_loss, j_grads, j_trunc = _jax_step(
        bench_torch.bench_scene(STEP["n_pts"]), STEP["width"],
        STEP["height"], STEP["max_dup"])
    assert not j_trunc
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=1e-5)
    for name, g, jg in zip(bench_torch.STEP_KEYS, grads, j_grads):
        scale = max(float(np.abs(jg).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, jg / scale, rtol=0,
                                   atol=3e-4, err_msg=name)


def test_bench_step_raises_on_truncation():
    with pytest.raises(RuntimeError, match="overflows max_dup"):
        bench_torch.bench_step_rate(CPU, **dict(STEP, max_dup=256))


@pytest.fixture(scope="module")
def lod_tree():
    return bench_torch.build_lod_tree(N_LEAVES, CPU)


def _resolved_subtrees(nodes, scale, gap=1e-3):
    """Rows whose merge, and every merge below them, splits its two
    smaller eigenvalues by more than `gap` of the largest. A merge of two
    leaves far apart for their size is a rank-1 covariance plus two nearly
    equal small eigenvalues, where both packages' float32 closed-form
    sym_eigh3 (build.py:54) returns rounding noise, each its own: the
    reference fault of test_torch_full_pipeline.py::
    test_reference_eigensolver_is_noise_on_repeated_eigenvalues. The noise
    then reaches every ancestor's covariance."""
    s2 = np.sort(scale.astype(np.float64) ** 2, axis=1)
    ok = (nodes[:, 2] == 0) | ((s2[:, 1] - s2[:, 0]) > gap * s2[:, 2])
    for depth in range(int(nodes[:, 0].max()), 0, -1):
        bad = np.nonzero((nodes[:, 0] == depth) & ~ok)[0]
        ok[nodes[bad, 1]] = False
    return ok


def test_build_lod_tree_matches_jax(lod_tree):
    """The node table exactly, positions and SH at every node; the
    covariances, and interior opacities, where both builds resolve every
    merge below the node (_resolved_subtrees: all 1,024 leaves and 128 of
    the 1,023 interior nodes of this tree)."""
    draws = _bench_py_draws(N_LEAVES)
    for a, b in zip(bench_torch.leaf_draws(N_LEAVES), draws):
        np.testing.assert_array_equal(a, b)
    j = jbuild.build_hierarchy(*draws)
    t = lod_tree
    assert t["nodes"].shape == (2 * N_LEAVES - 1, 6)
    np.testing.assert_array_equal(t["nodes"], j.nodes)
    np.testing.assert_allclose(t["pos"], j.pos, rtol=0, atol=2e-5)
    np.testing.assert_allclose(t["sh"], j.sh, rtol=0, atol=1e-4)
    ok = _resolved_subtrees(j.nodes, j.scale)
    interior = t["nodes"][:, 2] > 0
    assert (ok & interior).sum() >= 100 and ok[~interior].all()
    _assert_moments(t["pos"][ok], t["scale"][ok], t["quat"][ok],
                    t["opacity"][ok], t["sh"][ok], j.pos[ok], j.scale[ok],
                    j.quat[ok], j.opacity[ok], j.sh[ok], interior[ok])


def test_lod_tree_cache_round_trips(lod_tree, tmp_path):
    path = str(tmp_path / "lodtree_torch.npz")
    built = bench_torch.load_lod_tree(N_LEAVES, CPU, path)
    assert os.path.exists(path)
    cached = bench_torch.load_lod_tree(N_LEAVES, CPU, path)
    for k, v in lod_tree.items():
        np.testing.assert_array_equal(built[k], v)
        np.testing.assert_array_equal(cached[k], v)


@pytest.mark.parametrize("tau", [0.0, 15.0])
def test_stream_frame_matches_jax(lod_tree, tau):
    cam = bench_torch.bench_camera(CPU, STREAM_W, STREAM_H, 0.02)
    target = bench_torch.stream_target(tau, cam, STREAM_W)
    t_st, j_st = {}, {}
    out = bench_torch.stream_frame(
        bench_torch.lod_inputs(lod_tree, CPU), cam, target, t_st,
        width=STREAM_W, height=STREAM_H, max_dup=STREAM_MAX_DUP)

    tr = {k: jnp.asarray(v) for k, v in lod_tree.items()}
    op = jnp.clip(tr["opacity"], 0, 1)
    a = 0.02
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    jc = jcam.make_camera(R, np.zeros(3), fovx=1.2, fovy=0.8,
                          width=STREAM_W, height=STREAM_H)
    pcache = jcut.build_parent_cache(tr["nodes"], tr["pos"],
                                     jnp.max(tr["scale"].T, axis=0))
    itab = jcut.build_interp_table(
        dict(means3d=tr["pos"], scales=tr["scale"], quats=tr["quat"],
             opacities=op, shs=tr["sh"]), tr["nodes"])
    tgt = jnp.float32(max(float(jrender.tau_to_threshold(
        tau, float(jc.tan_fovx), STREAM_W)), 1e-9))
    j_out, _ = jrender.render_lod_stream(
        tr["pos"], tr["scale"], tr["quat"], op, tr["sh"], tr["nodes"],
        jnp.ones((tr["nodes"].shape[0],), bool), jc.world_view,
        jc.full_proj, jc.campos, jc.tan_fovx, jc.tan_fovy, jnp.zeros(3),
        tgt, j_st, pcache=pcache, interp_table=itab, sh_degree=0,
        width=STREAM_W, height=STREAM_H,
        cfg=JConfig(backend="pallas", tile_w=32, tile_h=32,
                    max_dup=STREAM_MAX_DUP, tight_binning=True),
        k_max=512, use_frustum=False)
    assert not bool(out.truncated) and not bool(j_out.truncated)
    assert float(out.image.max()) > 0.0
    np.testing.assert_allclose(out.image.numpy(), np.asarray(j_out.image),
                               rtol=0, atol=1e-4)


def test_main_prints_bench_py_keys(capsys, tmp_path):
    size = bench_torch.Size(width=64, height=48, n_pts=500, max_dup=1 << 12,
                            n_leaves=1 << 8, lod_max_dup=1 << 12)
    assert bench_torch.main("cpu", size, cache=str(tmp_path / "t.npz")) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    with open(os.path.join(ROOT, "bench.py")) as f:
        bench_py = f.read()
    assert all(f'"{k}"' in bench_py for k in BENCH_KEYS)
    assert tuple(line) == BENCH_KEYS
    assert line["metric"] == "rasterizer_fwd_bwd_1080p"
    assert line["unit"] == "Mpix/s"
    assert all(line[k] is not None for k in BENCH_KEYS)
    assert abs(line["vs_baseline"] - line["value"] / 124.4) < 1e-3


def test_main_without_a_card_exits_nonzero(monkeypatch, capsys):
    def no_cpu_run(*a, **k):
        raise AssertionError("the bench ran on the CPU")
    card = torch.cuda.is_available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_torch, "bench_step_rate", no_cpu_run)
    assert bench_torch.main() != 0
    assert capsys.readouterr().out == ""
    if not card:
        run = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode != 0 and run.stdout == ""
