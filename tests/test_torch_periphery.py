"""Port parity for the periphery: LPIPS against the JAX make_lpips on a
VGG16-shaped random weight set (rtol 1e-5); the debug renders and curves
against hlod_gaussians_tpu.debug (images 1e-5 through the xla path, 2e-5
through the plain pallas path, counts, polylines and colours exact); the
`eval` CLI on both routes against the JAX CLI's JSON lines (PSNR, SSIM and
GMSD 1e-4, mean_rendered exact); `create-hierarchy` against the JAX CLI's
.dhier and .gdf, and the native creator against the port's builder; the
native image loader against PIL; the small SH and projection helpers."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlod_gaussians_tpu import cli as jcli
from hlod_gaussians_tpu import debug as jdebug
from hlod_gaussians_tpu.config import RasterizerConfig as JConfig
from hlod_gaussians_tpu.data import dhier as jdhier
from hlod_gaussians_tpu.ops import gaussian_math as jgmath
from hlod_gaussians_tpu.ops import lpips as jlpips
from hlod_gaussians_tpu.ops import sh as jsh
from hlod_gaussians_tpu.utils.camera import make_camera as jmake_camera
from hlod_gaussians_torch import cli as tcli
from hlod_gaussians_torch import convert, native
from hlod_gaussians_torch import debug as tdebug
from hlod_gaussians_torch.config import RasterizerConfig
from hlod_gaussians_torch.data import colmap as cm
from hlod_gaussians_torch.data import dhier as tdhier
from hlod_gaussians_torch.data import ply as ply_io
from hlod_gaussians_torch.hierarchy import boxes as tboxes
from hlod_gaussians_torch.hierarchy import build as tbuild
from hlod_gaussians_torch.models.gaussians import (NODE_CHILD_COUNT,
                                                   NODE_PARENT, GaussianState)
from hlod_gaussians_torch.ops import gaussian_math as tgmath
from hlod_gaussians_torch.ops import lpips as tlpips
from hlod_gaussians_torch.ops import sh as tsh
from hlod_gaussians_torch.utils.camera import make_camera
from tests.test_hierarchy_build import random_gaussians
from tests.test_mcmc import hier_state
from tests.test_perceptual import _synthetic_weights
from tests.test_torch_hier_build import _cov

CPU = torch.device("cpu")
FIELDS = tuple(f.name for f in dataclasses.fields(GaussianState)
               if f.name not in ("n_skybox", "n_scaffold"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: PyTorch's intra-op threads only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(js):
    return convert.state_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in FIELDS},
        n_skybox=js.n_skybox, device=CPU)


# ---- LPIPS -----------------------------------------------------------------

@pytest.mark.parametrize("heads", [True, False])
def test_lpips_matches_jax(tmp_path, heads):
    """With the linear heads, and without them (a channel mean a tap)."""
    path, weights = _synthetic_weights(tmp_path)
    if not heads:
        weights = {k: v for k, v in weights.items() if not k.startswith("lin")}
        path = str(tmp_path / "no_heads.npz")
        np.savez(path, **weights)
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (3, 64, 64)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape).astype(np.float32), 0, 1)
    fn = tlpips.make_lpips(path, device=CPU)
    got = float(fn(torch.as_tensor(x), torch.as_tensor(y)))
    ref = float(jlpips.make_lpips(path)(jnp.asarray(x), jnp.asarray(y)))
    assert got == pytest.approx(ref, rel=1e-5), (got, ref)
    assert float(fn(torch.as_tensor(x), torch.as_tensor(x))) == 0.0


def test_lpips_none_without_weights(tmp_path):
    assert tlpips.make_lpips(None) is None
    assert tlpips.make_lpips(str(tmp_path / "missing.npz")) is None


# ---- debug -----------------------------------------------------------------

CFG = dict(tile_w=16, tile_h=16, max_dup=4096)


@pytest.fixture(scope="module")
def debug_scene():
    """tests/test_debug_cli.py's scene: the 33-leaf tree (seed 1) in both
    packages and its camera at z = 20."""
    js, _ = hier_state(n=33, cap=128, seed=1)
    pose = (np.eye(3), np.asarray([0, 0, 20.0]), 0.9, 0.9, 32, 32)
    return js, to_port(js), jmake_camera(*pose), make_camera(*pose,
                                                             device=CPU)


@pytest.mark.parametrize("backend,atol", [("xla", 1e-5), ("pallas", 2e-5)])
def test_render_depth_slice_matches_jax(debug_scene, backend, atol):
    js, ts, jcam, tcam = debug_scene
    for depth in (0, 2, 63):
        got, n = tdebug.render_depth_slice(
            ts, tcam, depth, cfg=RasterizerConfig(backend=backend, **CFG),
            k_max=64)
        ref, n_ref = jdebug.render_depth_slice(
            js, jcam, depth, cfg=JConfig(backend=backend, **CFG), k_max=64)
        assert isinstance(n, int) and n == n_ref, (depth, n, n_ref)
        assert got.shape == (3, 32, 32) and isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def test_false_color_and_path_to_root_match_jax(debug_scene):
    js, ts = debug_scene[:2]
    nodes = np.asarray(js.nodes)
    roots = np.where(nodes[:, NODE_CHILD_COUNT] == 2)[0][:4].tolist()
    np.testing.assert_array_equal(tdebug.false_color_by_subtree(ts, roots),
                                  jdebug.false_color_by_subtree(js, roots))
    for node in np.where(np.asarray(js.alive))[0]:
        np.testing.assert_array_equal(tdebug.path_to_root(ts, int(node)),
                                      jdebug.path_to_root(js, int(node)))


def test_render_level_slices_matches_jax():
    """tests/test_debug_cli.py's level-slice scene (seed 0, 64x64)."""
    js, _ = hier_state(n=33, cap=128)
    ts = to_port(js)
    pose = (np.eye(3), np.zeros(3), 0.8, 0.8, 64, 64)
    got = tdebug.render_level_slices(
        ts, make_camera(*pose, device=CPU), cfg=RasterizerConfig(**CFG),
        k_max=128)
    ref = jdebug.render_level_slices(js, jmake_camera(*pose),
                                     cfg=JConfig(**CFG), k_max=128)
    assert [n for _, n in got] == [n for _, n in ref]
    assert len(got) >= 2
    for (a, _), (b, _) in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_gaussians_per_limit_matches_jax(debug_scene):
    js, ts = debug_scene[:2]
    limits = [1e-9, 0.003, 0.01, 0.03, 0.1, 1.0]
    for campos, zdir in (([0, 0, -20.0], [0, 0, 1.0]),
                         ([1.0, 0.5, 3.0], [0.0, 0.6, 0.8])):
        got = tdebug.gaussians_per_limit(ts, torch.tensor(campos),
                                         np.asarray(zdir), limits)
        ref = jdebug.gaussians_per_limit(js, campos, zdir, limits)
        assert got == ref and all(isinstance(n, int) for n in got)
        assert got == sorted(got, reverse=True)


# ---- small helpers ----------------------------------------------------------

def _rand(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32) * scale


def test_sh_helpers_match_jax():
    rgb = np.random.default_rng(0).random((7, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.sh_to_rgb(torch.as_tensor(rgb)).numpy(),
                               np.asarray(jsh.sh_to_rgb(jnp.asarray(rgb))),
                               rtol=0, atol=1e-7)
    coeffs = _rand(5, 16, 3, seed=1)
    dirs = _rand(5, 3, seed=2)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for deg in range(4):
        got = tsh.eval_sh(deg, torch.as_tensor(coeffs), torch.as_tensor(dirs))
        ref = jsh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    # batched [B, N] directions, as the JAX function takes them
    got = tsh.eval_sh(3, torch.as_tensor(coeffs[None]),
                      torch.as_tensor(dirs[None]))
    assert tuple(got.shape) == (1, 5, 3)


def test_projection_helpers_match_jax():
    """tests/test_core_math.py's cases: the centre point, view depth, and
    the 2D covariance of 20 random Gaussians at z ~ 6."""
    pose = (np.eye(3), np.zeros(3), 1.0, 1.0, 64, 48)
    jcam, tcam = jmake_camera(*pose), make_camera(*pose, device=CPU)
    means = _rand(20, 3, seed=9, scale=0.3) + np.array([0, 0, 6.0], np.float32)
    means[0] = [0.0, 0.0, 5.0]
    means[1] = [0.3, -0.2, 7.5]
    means[2] = [0.0, 0.0, 0.0]           # w == 0: the guarded divide
    for tfn, jfn, mat in ((tgmath.transform_points, jgmath.transform_points,
                           "full_proj"),
                          (tgmath.transform_points, jgmath.transform_points,
                           "world_view")):
        (p, w) = tfn(torch.as_tensor(means), getattr(tcam, mat))
        (jp, jw) = jfn(jnp.asarray(means), getattr(jcam, mat))
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
    got = tgmath.transform_points_3x4(torch.as_tensor(means), tcam.world_view)
    ref = jgmath.transform_points_3x4(jnp.asarray(means), jcam.world_view)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    assert float(got[1, 2]) == pytest.approx(7.5, abs=1e-5)

    scales = np.exp(_rand(20, 3, seed=10, scale=0.3)) * 0.05
    quats = _rand(20, 4, seed=11)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    cov6 = tgmath.compute_cov3d(torch.as_tensor(scales),
                                torch.as_tensor(quats))
    jcov6 = jgmath.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats))
    got = tgmath.compute_cov2d(torch.as_tensor(means[3:]), cov6[3:],
                               tcam.world_view, tcam.focal_x, tcam.focal_y,
                               tcam.tan_fovx, tcam.tan_fovy)
    ref = jgmath.compute_cov2d(jnp.asarray(means[3:]), jcov6[3:],
                               jcam.world_view, jcam.focal_x, jcam.focal_y,
                               jcam.tan_fovx, jcam.tan_fovy)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)
    # without the dilation term: the conic inverts cov2d + 0.3
    proj = tgmath.project_gaussians(
        torch.as_tensor(means[3:]), cov6[3:], torch.ones(17),
        tcam.world_view, tcam.full_proj, 64, 48, tcam.focal_x, tcam.focal_y,
        tcam.tan_fovx, tcam.tan_fovy)
    a, b, c = got[:, 0] + 0.3, got[:, 1], got[:, 2] + 0.3
    det = a * c - b * b
    np.testing.assert_allclose(proj.conic.numpy(),
                               torch.stack([c / det, -b / det, a / det],
                                           -1).numpy(), rtol=1e-4)


# ---- create-hierarchy and the native creator ---------------------------------

def _write_ply(path, n, seed, sh_k):
    means, scales, quats, ops, shs = random_gaussians(n, seed=seed,
                                                      sh_k=sh_k)
    ply_io.save_gaussian_ply(path, ply_io.GaussianPly(
        xyz=means, f_dc=shs[:, :1], f_rest=shs[:, 1:],
        opacity=np.log(ops / (1 - ops)).astype(np.float32),
        log_scale=np.log(scales).astype(np.float32), quat=quats))
    return means, scales, quats, ops, shs


def _port_cli(argv, device=CPU):
    args = tcli.build_parser().parse_args(argv)
    return args.fn(args, device=device)


@pytest.mark.parametrize("sh_k", [1, 4])
def test_create_hierarchy_matches_jax(tmp_path, sh_k, capsys):
    """33 random leaves through both CLIs: node tables exact, positions and
    SH to rtol 1e-6, covariances and opacities to 1e-4 relative, the .gdf
    files byte-equal."""
    inp = str(tmp_path / "in.ply")
    _write_ply(inp, 33, seed=5, sh_k=sh_k)
    out_t, out_j = str(tmp_path / "t.dhier"), str(tmp_path / "j.dhier")
    _port_cli(["create-hierarchy", inp, out_t])
    jcli.main(["create-hierarchy", inp, out_j])
    lines = capsys.readouterr().out.splitlines()
    name = lambda line, x: line.replace(f"{x}.dhier", "").replace(f"{x}.gdf",
                                                                 "")
    assert name(lines[0], "t") == name(lines[1], "j")
    t, j = tdhier.load_dhier(out_t), jdhier.load_dhier(out_j)
    assert t.sh_degree == j.sh_degree == {1: 0, 4: 1}[sh_k]
    np.testing.assert_array_equal(t.nodes, j.nodes)
    assert t.nodes.shape[0] == 65
    for k in ("pos", "shs"):
        np.testing.assert_allclose(getattr(t, k), getattr(j, k), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    # the closed-form eigensolver splits each merged covariance into scales
    # and a rotation; XLA's and PyTorch's float32 arithmetic move those
    # (and the merge weights' ellipse surface) more than the covariance
    cov, ref = _cov(np.exp(t.log_scale), t.quat), _cov(np.exp(j.log_scale),
                                                       j.quat)
    assert (np.abs(cov - ref).max(axis=(1, 2))
            / np.abs(ref).max(axis=(1, 2))).max() < 1e-4
    np.testing.assert_allclose(t.opacity, j.opacity, rtol=1e-4, atol=0)
    with open(str(tmp_path / "t.gdf"), "rb") as f1, \
            open(str(tmp_path / "j.gdf"), "rb") as f2:
        assert f1.read() == f2.read()


def test_native_creator_matches_port_builder(tmp_path, capsys):
    """tests/test_native.py:84-121 with the port's builder and the port's
    build of native/src/hierarchy_creator.cpp, through the --native CLI."""
    n = 33
    inp = str(tmp_path / "in.ply")
    means, scales, quats, ops, shs = _write_ply(inp, n, seed=5, sh_k=1)
    out = str(tmp_path / "out.dhier")
    _port_cli(["create-hierarchy", inp, out, "--native"])
    assert f"wrote {2 * n - 1} nodes" in capsys.readouterr().out
    assert os.path.exists(str(tmp_path / "out.gdf"))
    assert native.build_hierarchy_file(inp, out) == 2 * n - 1
    d = tdhier.load_dhier(out)
    leaves = d.nodes[:, NODE_CHILD_COUNT] == 0
    assert leaves.sum() == n and (d.nodes[:, NODE_PARENT] == -1).sum() == 1
    h = tbuild.build_hierarchy(means, scales, quats, ops, shs, device=CPU)
    root_cpp = int(np.where(d.nodes[:, NODE_PARENT] == -1)[0][0])
    root_port = int(np.where(h.nodes[:, NODE_PARENT] == -1)[0][0])
    np.testing.assert_allclose(d.pos[root_cpp], h.pos[root_port], atol=1e-3)
    np.testing.assert_allclose(np.sort(np.exp(d.log_scale[root_cpp])),
                               np.sort(h.scale[root_port]), rtol=1e-2)
    np.testing.assert_allclose(d.opacity[root_cpp], h.opacity[root_port],
                               rtol=1e-2)
    np.testing.assert_allclose(np.sort(d.pos[leaves], axis=0),
                               np.sort(means, axis=0), atol=1e-5)


def test_native_build_failure_raises_compiler_output(tmp_path, monkeypatch):
    """A creator source that does not compile: build_hierarchy_file raises
    with the compiler's message, and nothing is left in the build dir."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "hierarchy_creator.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="hierarchy_creator.cpp"
                           ) as err:
            native.build_hierarchy_file("in.ply", "out.dhier")
        assert "error" in str(err.value)
        assert "hierarchy_creator" not in native.native_available()
    finally:
        native._library.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))


# ---- the native image loader ------------------------------------------------

def _png(path, h=37, w=53, seed=0):
    from PIL import Image
    img = np.random.default_rng(seed).integers(0, 255, (h, w, 3)).astype(
        np.uint8)
    Image.fromarray(img).save(path)
    return img


def test_loader_png_matches_pil(tmp_path):
    p = str(tmp_path / "a.png")
    ref = _png(p)
    loader = native.NativeImageLoader([p], n_threads=2, max_width=0)
    assert loader.library == "image_loader"
    got = loader.get(0)
    loader.close()
    np.testing.assert_allclose(
        got, np.transpose(ref.astype(np.float32) / 255.0, (2, 0, 1)),
        atol=1e-6)


def test_loader_jpeg_close_to_pil(tmp_path):
    from PIL import Image
    p = str(tmp_path / "b.jpg")
    img = np.random.default_rng(1).integers(0, 255, (40, 64, 3)).astype(
        np.uint8)
    Image.fromarray(img).save(p, quality=95)
    loader = native.NativeImageLoader([p], n_threads=2, max_width=0)
    got, pil = loader.get(0), loader._pil_get(0)
    loader.close()
    assert got.shape == pil.shape
    # decoders may differ by small IDCT rounding
    assert np.abs(got - pil).mean() < 0.02


def test_loader_resize_and_prefetch(tmp_path):
    p = str(tmp_path / "c.png")
    _png(p, h=64, w=128)
    loader = native.NativeImageLoader([p], n_threads=1, max_width=32)
    assert loader.get(0).shape == (3, 16, 32)
    loader.close()
    paths = []
    for i in range(8):
        paths.append(str(tmp_path / f"i{i}.png"))
        _png(paths[-1], h=16 + i, w=20, seed=i)
    loader = native.NativeImageLoader(paths, n_threads=4, max_width=0)
    loader.prefetch(list(range(8)))
    for i in range(8):
        assert loader.get(i).shape == (3, 16 + i, 20)
    loader.close()


def test_loader_falls_back_to_pil(tmp_path, monkeypatch):
    p = str(tmp_path / "a.png")
    ref = _png(p)
    monkeypatch.setattr(native, "_loaded", lambda name: None)
    loader = native.NativeImageLoader([p], max_width=0)
    assert loader.library == "PIL"
    np.testing.assert_array_equal(
        loader.get(0), np.transpose(ref.astype(np.float32) / 255.0, (2, 0, 1)))


# ---- the eval CLI -------------------------------------------------------------

EW, EH = 48, 32


@pytest.fixture(scope="module")
def eval_scene(tmp_path_factory):
    """A 64-leaf tree as a .dhier and as an upstream .hier, and a COLMAP
    scene of four views (two named in test.txt) whose images are the
    leaves' render, noised, written as PNGs."""
    from PIL import Image

    from hlod_gaussians_torch import render
    from hlod_gaussians_torch.models import gaussians as gm
    from hlod_gaussians_torch.train import post as tpost

    root = tmp_path_factory.mktemp("eval_scene")
    rng = np.random.default_rng(0)
    n = 64
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    pts[:, 2] += 5.0
    sc = np.exp(rng.uniform(-3.2, -2.4, (n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    op = rng.uniform(0.4, 0.9, n).astype(np.float32)
    sh = rng.normal(size=(n, 4, 3)).astype(np.float32) * 0.3
    h = tbuild.build_hierarchy(pts, sc, q, op, sh, device=CPU)
    d = tdhier.DHier(
        sh_degree=1, pos=h.pos, quat=h.quat,
        log_scale=np.log(np.maximum(h.scale, 1e-12)).astype(np.float32),
        opacity=np.clip(h.opacity, 1e-4, 1.0 - 1e-6).astype(np.float32),
        shs=h.sh, nodes=h.nodes)
    tdhier.save_dhier(str(root / "tree.dhier"), d)
    tdhier.save_hier(str(root / "tree.hier"), tboxes.dhier_to_upstream(d))

    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    fx, fy = EW / (2 * np.tan(0.45)), EH / (2 * np.tan(0.35))
    cm.write_cameras_bin(str(sparse / "cameras.bin"), {1: cm.ColmapCamera(
        1, "PINHOLE", EW, EH, np.array([fx, fy, EW / 2, EH / 2]))})
    state = tpost.create_from_dhier(d, capacity=h.nodes.shape[0], device=CPU)
    act = gm.activate(state)
    leaf = torch.as_tensor(h.nodes[:, NODE_CHILD_COUNT] == 0)
    images = {}
    for i in range(4):
        t = np.array([0.15 * i - 0.2, 0.05 * i, 0.3 * i])
        name = f"view_{i}.png"
        images[i + 1] = cm.ColmapImage(
            i + 1, cm.rotmat2qvec(np.eye(3)), t, 1, name, np.zeros((0, 2)),
            np.zeros((0,), np.int64))
        cam = make_camera(np.eye(3), t, 0.9, 0.7, EW, EH, device=CPU)
        with torch.no_grad():
            img = render.render_arrays(
                act.means3d, act.scales, act.quats, act.opacities, act.shs,
                leaf, cam.world_view, cam.full_proj, cam.campos,
                cam.tan_fovx, cam.tan_fovy, torch.zeros(3), sh_degree=1,
                width=EW, height=EH,
                cfg=RasterizerConfig(tile_w=16, tile_h=16, max_dup=8192),
                k_max=256).image.numpy()
        img = np.clip(img + rng.normal(size=img.shape) * 0.02, 0, 1)
        Image.fromarray(np.round(img.transpose(1, 2, 0) * 255).astype(
            np.uint8)).save(str(root / "images" / name))
    cm.write_images_bin(str(sparse / "images.bin"), images)
    cm.write_points3d_bin(str(sparse / "points3D.bin"), cm.ColmapPoints(
        pts, np.full((n, 3), 128, np.uint8), np.zeros(n, np.float32)))
    (root / "test.txt").write_text("view_1\nview_3\n")
    weights, _ = _synthetic_weights(root)
    return root, weights


@pytest.mark.parametrize("argv", [
    ["eval", "--hierarchy", "h.dhier", "-s", "scene"],
    ["eval", "--hierarchy", "h.hier", "--source_path", "s", "--images",
     "im", "--levels", "0,3", "--tau", "--max_views", "3", "--backend",
     "xla", "--lpips_weights", "w.npz", "--antialiasing", "--debug"],
    ["create-hierarchy", "in.ply", "out.dhier"],
    ["create-hierarchy", "in.ply", "out.dhier", "--native"]],
    ids=["eval", "eval_all", "create", "create_native"])
def test_periphery_parsers_match_jax(argv, monkeypatch):
    seen = {}
    for name in ("cmd_eval", "cmd_create_hierarchy"):
        monkeypatch.setattr(jcli, name,
                            lambda a: seen.setdefault("jax", vars(a)))
        monkeypatch.setattr(tcli, name,
                            lambda a: seen.setdefault("torch", vars(a)))
    jcli.main(argv)
    tcli.main(argv)
    j, t = seen["jax"], seen["torch"]
    assert j.pop("fn") is not None and t.pop("fn") is not None
    assert t == j


def _json_lines(out):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("route", ["dhier_tau", "hier"])
def test_cli_eval_matches_jax(eval_scene, route, capsys):
    """Both routes at three tau levels (the default budget, so no level is
    capped): the JSON lines and the --debug curve against the JAX CLI's."""
    root, weights = eval_scene
    hier = str(root / ("tree.dhier" if route == "dhier_tau" else "tree.hier"))
    argv = ["eval", "--hierarchy", hier, "-s", str(root), "--tau",
            "--levels", "0,3,15", "--backend", "xla", "--lpips_weights",
            weights, "--debug"]
    _port_cli(argv)
    got = capsys.readouterr().out
    jcli.main(argv)
    ref = capsys.readouterr().out
    debug_lines = [[x for x in o.splitlines() if x.startswith("[debug]")]
                   for o in (got, ref)]
    assert debug_lines[0] == debug_lines[1] and len(debug_lines[0]) == 1
    got, ref = _json_lines(got), _json_lines(ref)
    assert [r["level"] for r in got] == [0.0, 3.0, 15.0]
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert a["level"] == b["level"]
        assert a["mean_rendered"] == b["mean_rendered"]
        for k in ("psnr", "ssim", "gmsd"):
            assert abs(a[k] - b[k]) <= 1e-4 + 1e-12, (k, a, b)
        assert a["lpips"] == pytest.approx(b["lpips"], rel=1e-4)
    rendered = [r["mean_rendered"] for r in got]
    assert rendered[0] > rendered[-1]
