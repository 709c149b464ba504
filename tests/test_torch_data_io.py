"""Port parity for the loaders: COLMAP and PLY files written by each package
and read by the other (bytes equal), `load_colmap_scene`'s splits and
extent, `load_view` with the train_test_exp half mask and the depth
reliability gate (on tests/test_scene_loading.py's scenes), the
co-visibility graph from a COLMAP database the test writes, and configs
saved by each package and loaded by the other.

Tolerances: files, splits, masks, graphs and configs exact; camera
matrices and images exact (both packages build them in numpy and cast to
float32 the same way)."""

import dataclasses
import json
import os
import sqlite3

import numpy as np
import pytest
import torch

from hlod_gaussians_tpu import config as jconfig
from hlod_gaussians_tpu.data import colmap as jcm
from hlod_gaussians_tpu.data import ply as jply
from hlod_gaussians_tpu.data import scene as jscene
from hlod_gaussians_tpu.utils import scheduler as jsched
from hlod_gaussians_torch import config
from hlod_gaussians_torch.data import colmap as cm
from hlod_gaussians_torch.data import ply
from hlod_gaussians_torch.data import scene
from hlod_gaussians_torch.utils import scheduler
from tests.test_scene_loading import write_scene

CPU = torch.device("cpu")


def _model(n_images=4, seed=0):
    """A COLMAP model with a camera of each supported kind, 2D points and
    3D points with tracks (as the port's namedtuples; the JAX package's
    have the same fields)."""
    rng = np.random.default_rng(seed)
    cams = {1: cm.ColmapCamera(1, "PINHOLE", 64, 48,
                               np.array([50.0, 51.0, 32.0, 24.5])),
            2: cm.ColmapCamera(2, "SIMPLE_PINHOLE", 80, 60,
                               np.array([70.0, 40.0, 30.0]))}
    images = {}
    for i in range(n_images):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        n2d = 3 * i
        images[i + 1] = cm.ColmapImage(
            i + 1, q, rng.normal(size=3), 1 + i % 2, f"im_{i}.jpg",
            rng.uniform(0, 60, (n2d, 2)),
            rng.integers(-1, 50, n2d).astype(np.int64))
    pts = cm.ColmapPoints(rng.normal(size=(30, 3)).astype(np.float32),
                          rng.integers(0, 255, (30, 3)).astype(np.uint8),
                          rng.random(30).astype(np.float32))
    full = cm.ColmapPointsFull(
        rng.integers(1, 1000, 30).astype(np.int64), pts.xyz, pts.rgb,
        pts.errors, rng.integers(0, 5, 30).astype(np.int64))
    return cams, images, pts, full


def _jax_of(cams, images, pts, full):
    return ({k: jcm.ColmapCamera(*c) for k, c in cams.items()},
            {k: jcm.ColmapImage(*im) for k, im in images.items()},
            jcm.ColmapPoints(*pts), jcm.ColmapPointsFull(*full))


WRITERS = [("cameras.bin", "write_cameras_bin", 0),
           ("images.bin", "write_images_bin", 1),
           ("points3D.bin", "write_points3d_bin", 2),
           ("full.bin", "write_points3d_bin_full", 3)]


@pytest.mark.parametrize("fname,writer,part", WRITERS,
                         ids=[w[0] for w in WRITERS])
def test_colmap_bin_bytes_equal(tmp_path, fname, writer, part):
    ours = _model()
    theirs = _jax_of(*ours)
    a, b = tmp_path / ("port_" + fname), tmp_path / ("jax_" + fname)
    getattr(cm, writer)(str(a), ours[part])
    getattr(jcm, writer)(str(b), theirs[part])
    assert a.read_bytes() == b.read_bytes()


def _assert_model_equal(got, ref):
    gc, gi, gp = got
    rc, ri, rp = ref
    assert list(gc) == list(rc)
    for k in gc:
        assert gc[k][:4] == rc[k][:4]
        np.testing.assert_array_equal(gc[k].params, rc[k].params)
    assert list(gi) == list(ri)
    for k in gi:
        assert (gi[k].id, gi[k].camera_id, gi[k].name) == \
            (ri[k].id, ri[k].camera_id, ri[k].name)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            np.testing.assert_array_equal(getattr(gi[k], f),
                                          getattr(ri[k], f))
    for f in ("xyz", "rgb", "errors"):
        np.testing.assert_array_equal(getattr(gp, f), getattr(rp, f))


def _write_txt(sparse, cams, images, pts):
    os.makedirs(sparse)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# camera list\n")
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        for im in images.values():
            f.write(f"{im.id} " + " ".join(repr(float(x)) for x in im.qvec)
                    + " " + " ".join(repr(float(x)) for x in im.tvec)
                    + f" {im.camera_id} {im.name}\n\n")   # empty POINTS2D
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for i in range(pts.xyz.shape[0]):
            f.write(f"{i} " + " ".join(repr(float(x)) for x in pts.xyz[i])
                    + " " + " ".join(str(int(c)) for c in pts.rgb[i])
                    + f" {float(pts.errors[i])!r}\n")


@pytest.mark.parametrize("form", ["bin", "txt"])
def test_colmap_models_read_by_both(tmp_path, form):
    """A model written by either package's writers (binary) or as text is
    read the same by both packages' readers."""
    cams, images, pts, full = _model()
    sparse = str(tmp_path / "sparse")
    if form == "bin":
        os.makedirs(sparse)
        cm.write_cameras_bin(os.path.join(sparse, "cameras.bin"), cams)
        jcm.write_images_bin(os.path.join(sparse, "images.bin"),
                             _jax_of(cams, images, pts, full)[1])
        cm.write_points3d_bin(os.path.join(sparse, "points3D.bin"), pts)
        got = cm.read_model(sparse)
        images_got = cm.read_images_bin(os.path.join(sparse, "images.bin"),
                                        load_points=True)
        images_ref = jcm.read_images_bin(os.path.join(sparse, "images.bin"),
                                         load_points=True)
        _assert_model_equal((got[0], images_got, got[2]),
                            (got[0], images_ref, got[2]))
        full_path = str(tmp_path / "full.bin")
        jcm.write_points3d_bin_full(full_path,
                                    _jax_of(cams, images, pts, full)[3])
        got_full = cm.read_points3d_bin_full(full_path)
        ref_full = jcm.read_points3d_bin_full(full_path)
        for f in got_full._fields:
            np.testing.assert_array_equal(getattr(got_full, f),
                                          getattr(ref_full, f))
        np.testing.assert_array_equal(got_full.track_lens, full.track_lens)
    else:
        _write_txt(sparse, cams, images, pts)
        got = cm.read_model(sparse)
        assert all(len(im.xys) == 0 for im in got[1].values())
    _assert_model_equal(got, jcm.read_model(sparse))


def test_rotations_and_intrinsics_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(8):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = cm.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcm.qvec2rotmat(q))
        np.testing.assert_array_equal(cm.rotmat2qvec(R), jcm.rotmat2qvec(R))
        np.testing.assert_allclose(cm.qvec2rotmat(cm.rotmat2qvec(R)), R,
                                   atol=1e-12)
    cams, *_ = _model()
    for c in cams.values():
        assert cm.camera_intrinsics(c) == jcm.camera_intrinsics(
            jcm.ColmapCamera(*c))
    with pytest.raises(ValueError, match="undistort"):
        cm.camera_intrinsics(cm.ColmapCamera(3, "OPENCV", 10, 10,
                                             np.zeros(8)))


@pytest.mark.parametrize("sh_degree", [0, 1, 3])
def test_gaussian_ply_bytes_equal(tmp_path, sh_degree):
    rng = np.random.default_rng(sh_degree)
    n, k = 17, (sh_degree + 1) ** 2 - 1
    fields = dict(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        f_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        f_rest=rng.normal(size=(n, k, 3)).astype(np.float32),
        opacity=rng.normal(size=(n,)).astype(np.float32),
        log_scale=rng.normal(size=(n, 3)).astype(np.float32),
        quat=rng.normal(size=(n, 4)).astype(np.float32))
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    ply.save_gaussian_ply(a, ply.GaussianPly(**fields))
    jply.save_gaussian_ply(b, jply.GaussianPly(**fields))
    assert open(a, "rb").read() == open(b, "rb").read()
    got, ref = ply.load_gaussian_ply(b), jply.load_gaussian_ply(a)
    for f in ply.GaussianPly._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
        np.testing.assert_array_equal(getattr(got, f), fields[f])


def test_points_ply_bytes_equal(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(25, 3)).astype(np.float32)
    cols = rng.random((25, 3)).astype(np.float32)
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    ply.save_points_ply(a, pts, cols)
    jply.save_points_ply(b, pts, cols)
    assert open(a, "rb").read() == open(b, "rb").read()
    for got, ref in zip(ply.load_points_ply(b), jply.load_points_ply(a)):
        np.testing.assert_array_equal(got, ref)
    # no colours: grey, as the JAX package writes it
    ply.save_points_ply(a, pts)
    jply.save_points_ply(b, pts)
    assert open(a, "rb").read() == open(b, "rb").read()


def _assert_scene_equal(got, ref):
    for f in ("points", "colors", "center"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert got.extent == ref.extent
    for split in ("train_cameras", "test_cameras"):
        gl, rl = getattr(got, split), getattr(ref, split)
        assert [c.image_name for c in gl] == [c.image_name for c in rl]
        for g, r in zip(gl, rl):
            for f in g._fields:
                gv, rv = getattr(g, f), getattr(r, f)
                if isinstance(gv, np.ndarray):
                    np.testing.assert_array_equal(gv, rv)
                else:
                    assert gv == rv, f


def _assert_view_equal(got, ref):
    assert (got.width, got.height, got.exposure_idx) == \
        (ref.width, ref.height, ref.exposure_idx)
    for f in ("world_view", "full_proj", "campos", "tan_fovx", "tan_fovy",
              "image", "alpha_mask", "invdepth", "depth_mask"):
        g, r = getattr(got, f), getattr(ref, f)
        if r is None:
            assert g is None, f
        else:
            assert g.device == CPU and g.dtype == torch.float32, f
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), f)


SPLITS = {"all": dict(), "every_3rd": dict(eval_split=True, test_hold=3),
          "test_txt": dict(), "train_test_exp": dict(
              eval_split=True, test_hold=3, train_test_exp=True)}


@pytest.mark.parametrize("split", list(SPLITS))
def test_load_colmap_scene_matches_jax(tmp_path, split):
    root = str(tmp_path / "scene")
    os.makedirs(root)
    write_scene(root)
    if split == "test_txt":
        with open(os.path.join(root, "test.txt"), "w") as f:
            f.write("img_001\nimg_004\n")
    got = scene.load_colmap_scene(root, **SPLITS[split])
    ref = jscene.load_colmap_scene(root, **SPLITS[split])
    _assert_scene_equal(got, ref)
    n_test = {"all": 0, "every_3rd": 2, "test_txt": 2,
              "train_test_exp": 2}[split]
    assert len(got.test_cameras) == n_test
    assert all(c.is_test for c in got.test_cameras)
    # the extent from the train cameras only
    radius, center = scene.nerfpp_norm(got.train_cameras)
    assert radius == got.extent
    np.testing.assert_array_equal(center, got.center)
    if split == "train_test_exp":
        half = [c for c in got.train_cameras if c.is_test]
        assert len(half) == 2
        for is_test_dataset in (False, True):
            kw = dict(train_test_exp=True, is_test_dataset=is_test_dataset)
            v = scene.load_view(half[0], device=CPU, **kw)
            _assert_view_equal(v, jscene.load_view(half[0], **kw))
            a = v.alpha_mask.numpy()
            masked = a[..., :20] if is_test_dataset else a[..., 20:]
            assert (masked == 0).all() and a.sum() == a.size / 2
    else:
        for info in got.train_cameras[:2]:
            _assert_view_equal(scene.load_view(info, device=CPU),
                               jscene.load_view(info))


def test_load_view_depth_gate_matches_jax(tmp_path):
    """depth_params.json's med_scale anchor: an inlier keeps its depth mask,
    an outlier scale zeroes it, scale 0 drops depth."""
    from PIL import Image

    root = str(tmp_path / "scene")
    os.makedirs(root)
    write_scene(root)
    dd = os.path.join(root, "depths")
    os.makedirs(dd)
    rng = np.random.default_rng(1)
    for i in range(6):
        d16 = rng.integers(1000, 60000, (30, 40)).astype(np.uint16)
        Image.fromarray(d16).save(os.path.join(dd, f"img_{i:03d}.png"))
    params = {f"img_{i:03d}": {"scale": 1.0 + 0.01 * i, "offset": 0.1}
              for i in range(6)}
    params["img_001"]["scale"] = 100.0
    params["img_002"]["scale"] = 0.0
    with open(os.path.join(root, "sparse", "0", "depth_params.json"),
              "w") as f:
        json.dump(params, f)
    got = scene.load_colmap_scene(root, depths_dir="depths")
    ref = jscene.load_colmap_scene(root, depths_dir="depths")
    _assert_scene_equal(got, ref)
    assert got.train_cameras[0].depth_params["med_scale"] > 0
    views = {c.image_name: scene.load_view(c, device=CPU)
             for c in got.train_cameras}
    for c in ref.train_cameras:
        _assert_view_equal(views[c.image_name], jscene.load_view(c))
    assert float(views["img_000"].depth_mask.max()) == 1.0
    assert float(views["img_001"].depth_mask.max()) == 0.0
    assert views["img_002"].invdepth is None


def test_downscale_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.random((30, 40, 3)).astype(np.float32)
    for scale, max_w in ((1.0, 1600), (2.0, 1600), (1.0, 20)):
        got = scene._downscale(img, scale, max_w)
        np.testing.assert_array_equal(got, jscene._downscale(img, scale,
                                                             max_w))
        assert got.dtype == np.float32


def test_covisibility_graph_matches_jax(tmp_path):
    db = str(tmp_path / "database.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE two_view_geometries (pair_id INTEGER, "
                 "rows INTEGER)")
    edges = [(1, 2, 50), (1, 3, 5), (2, 3, 0), (4, 2, 12), (3, 4, None),
             (5, 1, 7)]
    conn.executemany("INSERT INTO two_view_geometries VALUES (?, ?)",
                     [(min(a, b) * 2147483647 + max(a, b), m)
                      for a, b, m in edges])
    conn.commit()
    conn.close()
    assert scheduler.pair_id_to_image_ids(3 * 2147483647 + 9) == (3, 9)
    for min_matches in (1, 10):
        got = scheduler.load_covisibility_graph(db, min_matches)
        ref = jsched.load_covisibility_graph(db, min_matches)
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])
    ids, nbrs, w = scheduler.load_covisibility_graph(db, 1)
    assert ids == [1, 2, 3, 4, 5]
    assert nbrs[0].tolist() == [1, 2, 4] and w[0].tolist() == [50, 5, 7]
    walk = scheduler.metropolis_hastings_walk(nbrs, 20,
                                              np.random.default_rng(0))
    assert walk.min() >= 0 and walk.max() < 5


def test_configs_load_across_packages(tmp_path):
    """A JSON file written by either package loads in the other; classes
    and fields a package lacks are skipped, overrides apply."""
    a, b = str(tmp_path / "port" / "cfg.json"), str(tmp_path / "jax.json")
    config.save_config(a, model=config.ModelConfig(sh_degree=1, eval=True),
                       pipe=config.PipelineConfig(antialiasing=True),
                       post=config.PostConfig(max_cap=123),
                       raster=config.RasterizerConfig(tile_w=32))
    jconfig.save_config(b, model=jconfig.ModelConfig(images="img2"),
                        opt=jconfig.OptimizationConfig(feature_lr=0.01),
                        mesh=jconfig.MeshConfig(data=2))
    ref = jconfig.load_config(a)
    assert ref["ModelConfig"] == jconfig.ModelConfig(sh_degree=1, eval=True)
    assert ref["PipelineConfig"] == jconfig.PipelineConfig(antialiasing=True)
    assert ref["PostConfig"] == jconfig.PostConfig(max_cap=123)
    assert ref["RasterizerConfig"] == jconfig.RasterizerConfig(tile_w=32)
    got = config.load_config(b, overrides={"OptimizationConfig":
                                           {"opacity_lr": 0.1}})
    assert set(got) == {"ModelConfig", "OptimizationConfig", "MeshConfig"}
    assert got["ModelConfig"] == config.ModelConfig(images="img2")
    assert got["MeshConfig"] == config.MeshConfig(data=2)
    assert got["MeshConfig"].shape == jconfig.MeshConfig(data=2).shape
    assert got["OptimizationConfig"] == config.OptimizationConfig(
        feature_lr=0.01, opacity_lr=0.1)
    # each package reads its own file back
    mine = config.load_config(a)
    assert mine["PostConfig"] == config.PostConfig(max_cap=123)
    assert mine["RasterizerConfig"] == config.RasterizerConfig(tile_w=32)
    for ours, theirs in ((config.ModelConfig, jconfig.ModelConfig),
                         (config.PipelineConfig, jconfig.PipelineConfig),
                         (config.MeshConfig, jconfig.MeshConfig)):
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
