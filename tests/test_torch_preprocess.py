"""Port parity for hlod_gaussians_torch/preprocess/ against the JAX
package's copy on the scenarios of tests/test_preprocess.py and
tests/test_preprocess_extras.py: arrays equal or within 1e-6, written COLMAP
files and masks byte-equal, database tables equal row for row, the captured
COLMAP and depth-generator command lists equal."""

import os
import sqlite3

import numpy as np
import pytest
import torch

from hlod_gaussians_tpu.data import colmap as jcm
from hlod_gaussians_tpu.preprocess import calibrate as jcal
from hlod_gaussians_tpu.preprocess import database as jdb
from hlod_gaussians_tpu.preprocess import depth_scale as jdepth
from hlod_gaussians_tpu.preprocess import masks as jmasks
from hlod_gaussians_tpu.preprocess import reorient as jreorient
from hlod_gaussians_tpu.preprocess import simplify as jsimplify
from hlod_gaussians_tpu.preprocess import transform as jtransform
from hlod_gaussians_torch import preprocess
from hlod_gaussians_torch.data import colmap as cm
from hlod_gaussians_torch.preprocess import calibrate as tcal
from hlod_gaussians_torch.preprocess import database as tdb
from hlod_gaussians_torch.preprocess import depth_scale as tdepth
from hlod_gaussians_torch.preprocess import masks as tmasks
from hlod_gaussians_torch.preprocess import reorient as treorient
from hlod_gaussians_torch.preprocess import simplify as tsimplify
from hlod_gaussians_torch.preprocess import transform as ttransform
from tests.test_preprocess import make_images
from tests.test_preprocess_extras import _toy_model, _write_model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same(a, b, atol=1e-6):
    """Nested results (tuples, dicts, named tuples, arrays) equal, floats
    within atol."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k], atol)
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, atol)
    elif isinstance(a, (np.ndarray, float, np.floating)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    else:
        assert a == b, (a, b)


def test_package_imports_like_jax():
    assert {"depth_scale", "reorient"} <= set(vars(preprocess))


# ---- reorient and depth scale -------------------------------------------------

def _tilted_scene():
    """test_auto_reorient_levels_cameras' 40 cameras on a tilted plane."""
    rng = np.random.default_rng(1)
    xy = rng.uniform(-10, 10, (40, 2))
    centers = np.c_[xy, 0.5 * xy[:, 0] + 2.0]
    pts = (centers + rng.normal(0, 0.5, centers.shape)).astype(np.float32)
    return centers, pts


def test_reorient_matches_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-5, 5, (200, 2))
    plane = np.c_[xy, 0.3 * xy[:, 0] - 0.2 * xy[:, 1] + 1
                  + rng.normal(0, 0.01, 200)]
    _same(treorient.fit_plane_least_squares(plane),
          jreorient.fit_plane_least_squares(plane), atol=0)
    centers, pts = _tilted_scene()
    rot = treorient.reorient_basis(centers)
    np.testing.assert_array_equal(rot, jreorient.reorient_basis(centers))
    up = treorient.metric_upscale(centers @ rot, pts @ rot, 20.0)
    assert up == jreorient.metric_upscale(centers @ rot, pts @ rot, 20.0)
    assert treorient.metric_upscale(centers, pts[:0]) == 1.0
    np.testing.assert_array_equal(treorient.transform_points(pts, rot, up),
                                  jreorient.transform_points(pts, rot, up))

    t_imgs, j_imgs = make_images(centers), make_images(centers)
    t_pts = cm.ColmapPoints(pts, np.zeros((40, 3), np.uint8),
                            np.zeros(40, np.float32))
    j_pts = jcm.ColmapPoints(*t_pts)
    got = treorient.auto_reorient({}, t_imgs, t_pts, target_med_dist=20.0)
    ref = jreorient.auto_reorient({}, j_imgs, j_pts, target_med_dist=20.0)
    _same(tuple(got[1]), tuple(ref[1]), atol=0)
    _same(got[2:], ref[2:], atol=0)
    assert got[0].keys() == ref[0].keys()
    for k in got[0]:
        _same(tuple(got[0][k]), tuple(ref[0][k]), atol=0)


def _depth_case(n_pts=200, empty=False):
    """test_depth_scale_fit_recovers_affine's image: a smooth depth field,
    its affine inverse-depth map and 200 SfM points on integer pixels."""
    rng = np.random.default_rng(2)
    w, h = 64, 48
    cam = cm.ColmapCamera(0, "PINHOLE", w, h,
                          np.array([50.0, 50.0, w / 2, h / 2]))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    depth_grid = 4.0 + 0.05 * xx + 0.02 * yy
    inv_mono = ((1.0 / depth_grid - 0.05) / 3.0).astype(np.float32)
    xi, yi = rng.integers(0, w, n_pts), rng.integers(0, h, n_pts)
    depth = depth_grid[yi, xi]
    xy = np.c_[xi, yi].astype(np.float64)
    pts = np.c_[(xy[:, 0] - w / 2) / 50.0 * depth,
                (xy[:, 1] - h / 2) / 50.0 * depth, depth]
    ids = np.full(n_pts, -1) if empty else np.arange(n_pts)
    img = cm.ColmapImage(0, np.array([1.0, 0, 0, 0]), np.zeros(3), 0,
                         "im.jpg", xy, ids)
    return img, cam, pts, inv_mono


@pytest.mark.parametrize("case", ["fit", "no_points", "too_few"])
def test_fit_depth_scale_matches_jax(case):
    img, cam, pts, inv_mono = _depth_case(
        n_pts=8 if case == "too_few" else 200, empty=case == "no_points")
    got = tdepth.fit_depth_scale(img, cam, pts, inv_mono)
    ref = jdepth.fit_depth_scale(jcm.ColmapImage(*img), jcm.ColmapCamera(*cam),
                                 pts, inv_mono)
    assert got == ref
    assert (got["scale"] > 0) == (case == "fit")
    xy = np.random.default_rng(3).uniform(-2, 70, (50, 2))
    np.testing.assert_array_equal(tdepth._bilinear_sample(inv_mono, xy),
                                  jdepth._bilinear_sample(inv_mono, xy))


# ---- calibration drivers -------------------------------------------------------

def _capture():
    cmds = []
    return cmds, cmds.append


def test_spatial_matcher_pairs_match_jax(tmp_path):
    names = [f"im{i}.jpg" for i in range(12)]
    pos = np.random.default_rng(0).normal(size=(12, 3))
    for positions, nb in ((None, 3), (pos, 4), (pos[:5], 60)):
        assert (tcal.make_spatial_matcher_pairs(names, positions, nb)
                == jcal.make_spatial_matcher_pairs(names, positions, nb))
    pairs = tcal.make_spatial_matcher_pairs(names, pos, 4)
    tcal.write_match_list(str(tmp_path / "t" / "m.txt"), pairs)
    jcal.write_match_list(str(tmp_path / "j" / "m.txt"), pairs)
    assert _bytes(tmp_path / "t" / "m.txt") == _bytes(tmp_path / "j" / "m.txt")
    assert tcal.colmap_available("colmap") == jcal.colmap_available("colmap")
    assert tcal.colmap_available("python3")


def test_run_calibration_commands_match_jax(tmp_path):
    img = tmp_path / "inputs" / "images"
    (img / "sub").mkdir(parents=True)
    for i in range(4):
        (img / f"im{i}.jpg").write_bytes(b"x")
    (img / "sub" / "a.PNG").write_bytes(b"x")
    assert tcal._list_images(str(img)) == jcal._list_images(str(img))
    ml = tmp_path / "distorted" / "matching.txt"
    got, cap = _capture()
    tcal.run_calibration(str(tmp_path), use_gpu=True, n_neighbors=2,
                         runner=cap)
    t_list = _bytes(ml)
    ref, cap = _capture()
    jcal.run_calibration(str(tmp_path), use_gpu=True, n_neighbors=2,
                         runner=cap)
    assert got == ref and t_list == _bytes(ml)
    assert [c[1] for c in got] == ["feature_extractor", "matches_importer",
                                   "hierarchical_mapper", "image_undistorter"]


@pytest.mark.parametrize("skip_ba", [False, True])
def test_refine_chunk_commands_match_jax(tmp_path, skip_ba):
    raw = tmp_path / "raw"
    (raw / "sparse" / "0").mkdir(parents=True)
    names = [f"i{k}.jpg" for k in range(5)]
    pos = np.random.default_rng(1).normal(size=(5, 3))
    runs = []
    for mod in (tcal, jcal):
        cmds, cap = _capture()
        out = mod.refine_chunk(str(raw), str(tmp_path / "out"),
                               str(tmp_path / "imgs"),
                               skip_bundle_adjustment=skip_ba,
                               positions=pos, image_names=names, runner=cap)
        nb = 50 if skip_ba else 200
        runs.append((cmds, out, _bytes(raw / "bundle_adjustment"
                                       / f"matching_{nb}.txt")))
    assert runs[0] == runs[1]
    assert sum(c[1] == "bundle_adjuster" for c in runs[0][0]) == (
        0 if skip_ba else 2)


@pytest.mark.parametrize("generator", ["Depth-Anything-V2", "DPT"])
def test_depth_generator_commands_match_jax(tmp_path, generator):
    imgs = tmp_path / "rect"
    for cam in ("cam0", "cam1"):
        (imgs / cam).mkdir(parents=True)
    runs = []
    for mod in (tcal, jcal):
        cmds, cap = _capture()
        mod.run_depth_generator(str(imgs), str(tmp_path / "depth"),
                                generator=generator, generator_dir="/x",
                                runner=cap)
        runs.append(cmds)
    assert runs[0] == runs[1] and len(runs[0]) == 2
    with pytest.raises(ValueError):
        tcal.run_depth_generator(str(imgs), str(tmp_path / "d"),
                                 generator="other", runner=cap)
    with pytest.raises(RuntimeError, match="not found"):
        tcal.run_depth_generator(str(imgs), str(tmp_path / "d"),
                                 generator=generator, generator_dir="")


def test_blur_filter_matches_jax():
    rng = np.random.default_rng(0)
    sharp = [rng.random((32, 32)).astype(np.float32) for _ in range(3)]
    rgb = rng.random((32, 32, 3)).astype(np.float32)
    flat = [np.full((32, 32), 0.5, np.float32)]
    for im in sharp + flat:
        assert (tcal.laplacian_variance(im)
                == jcal.laplacian_variance(im))
    for thresh in (0.5, 0.0, 0.9):
        np.testing.assert_array_equal(
            tcal.blur_filter_mask(sharp + flat + [rgb], thresh),
            jcal.blur_filter_mask(sharp + flat + [rgb], thresh))
    assert tcal.blur_filter_mask([], 0.5).shape == (0,)


# ---- database -------------------------------------------------------------------

def _rows(path):
    con = sqlite3.connect(path)
    try:
        tables = [r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        return {t: con.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in tables}
    finally:
        con.close()


@pytest.mark.parametrize("priors", [False, True])
def test_seed_database_matches_jax(tmp_path, priors):
    cams, images, pts = _toy_model()
    root = str(tmp_path / "m")
    _write_model(root, cams, images, pts)
    sparse = os.path.join(root, "sparse", "0")
    t_db, j_db = str(tmp_path / "t.db"), str(tmp_path / "j.db")
    assert (tdb.seed_database(sparse, t_db, with_pose_priors=priors)
            == jdb.seed_database(sparse, j_db, with_pose_priors=priors)
            == len(images))
    t_rows, j_rows = _rows(t_db), _rows(j_db)
    assert t_rows.keys() == j_rows.keys() and "images" in t_rows
    for table in t_rows:
        # NaN priors: compare the rows' bytes, not their values
        assert repr(t_rows[table]) == repr(j_rows[table]), table
    db = tdb.ColmapDatabase(t_db)
    _same(db.cameras(), jdb.ColmapDatabase(j_db).cameras())
    assert db.images() == jdb.ColmapDatabase(j_db).images()
    db.close()
    # reseeding over an existing file replaces it
    assert tdb.seed_database(sparse, t_db) == len(images)


def test_image_pair_id_matches_jax():
    for a, b in ((1, 2), (2, 1), (7, 7), (1, 2 ** 31 - 2), (40, 3)):
        assert tdb.image_pair_id(a, b) == jdb.image_pair_id(a, b)


# ---- masks -----------------------------------------------------------------------

def _rgba():
    rng = np.random.default_rng(0)
    rgba = np.zeros((24, 32, 4), np.uint8)
    rgba[..., :3] = rng.integers(1, 255, (24, 32, 3))
    rgba[4:20, 8:28, 3] = 255
    rgba[10, 12, 3] = 200                 # a soft pixel inside
    return rgba


def test_mask_ops_match_jax():
    rgba = _rgba()
    m = tmasks.alpha_to_mask(rgba)
    np.testing.assert_array_equal(m, jmasks.alpha_to_mask(rgba))
    np.testing.assert_array_equal(tmasks.alpha_to_mask(rgba[..., 3]), m)
    for k in (3, 5):
        np.testing.assert_array_equal(tmasks.erode(m, k), jmasks.erode(m, k))
        np.testing.assert_array_equal(tmasks.dilate(m, k),
                                      jmasks.dilate(m, k))
    np.testing.assert_array_equal(tmasks.apply_mask(rgba[..., :3], m),
                                  jmasks.apply_mask(rgba[..., :3], m))


def test_mask_drivers_write_the_same_files(tmp_path):
    from PIL import Image
    out = {}
    for tag, mod in (("t", tmasks), ("j", jmasks)):
        src, msk = tmp_path / tag / "in", tmp_path / tag / "masks"
        (src / "sub").mkdir(parents=True)
        msk.mkdir()
        Image.fromarray(_rgba()).save(str(src / "a.png"))
        Image.fromarray(_rgba()[::-1]).save(str(src / "sub" / "b.png"))
        Image.fromarray(_rgba()[..., :3]).save(str(src / "rgb.png"))
        assert mod.make_masks(str(src), str(msk)) == 2
        assert mod.apply_masks(str(src), str(msk)) == 2
        out[tag] = {p.relative_to(tmp_path / tag): _bytes(p)
                    for p in sorted((tmp_path / tag).rglob("*.png"))}
    assert out["t"] == out["j"] and len(out["t"]) == 5
    assert (tmasks._list_images(str(tmp_path / "t" / "in"))
            == jmasks._list_images(str(tmp_path / "j" / "in")))


# ---- simplify and transform ------------------------------------------------------

def _simplify_case():
    """test_simplify_images' ten images: one without observations, one
    isolated, one with only invalid observations."""
    cams, images, pts = _toy_model(n_img=10)
    im3, im5, im7 = images[3], images[5], images[7]
    images[3] = cm.ColmapImage(im3.id, im3.qvec, np.asarray(im3.tvec),
                               im3.camera_id, im3.name, np.zeros((0, 2)),
                               np.zeros((0,), np.int64))
    images[5] = cm.ColmapImage(im5.id, im5.qvec,
                               np.array([500.0, 500.0, 500.0]),
                               im5.camera_id, im5.name, im5.xys,
                               im5.point3d_ids)
    images[7] = cm.ColmapImage(im7.id, im7.qvec, np.asarray(im7.tvec),
                               im7.camera_id, im7.name, im7.xys,
                               np.full(im7.point3d_ids.shape, -1, np.int64))
    return cams, images, pts


def test_simplify_matches_jax(tmp_path):
    cams, images, pts = _simplify_case()
    np.testing.assert_array_equal(tsimplify.camera_centers(images),
                                  jsimplify.camera_centers(images))
    got = tsimplify.simplify_images(images)
    ref = jsimplify.simplify_images(images)
    assert got.keys() == ref.keys() and not {3, 5, 7} & set(got)
    for k in got:
        _same(tuple(got[k]), tuple(ref[k]), atol=0)
    assert tsimplify.simplify_images({}) == {}
    one = {1: images[1]}
    assert tsimplify.simplify_images(one).keys() == jsimplify.simplify_images(
        one).keys()
    files = {}
    for tag, mod in (("t", tsimplify), ("j", jsimplify)):
        root = str(tmp_path / tag)
        _write_model(root, cams, images, pts)
        base = os.path.join(root, "sparse", "0")
        assert mod.simplify_images_file(base) == len(got)
        files[tag] = (_bytes(os.path.join(base, "images.bin")),
                      _bytes(os.path.join(base, "images_heavy.bin")))
    assert files["t"] == files["j"]


def test_procrustes_matches_jax():
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(50, 3)).astype(np.float32)
    ang = 0.7
    r = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    x1 = (x0 * 2.5) @ r.T + np.array([1.0, -2.0, 0.5], np.float32)
    for a, b in ((x0, x1), (x0, -x1)):        # -x1: a reflection to undo
        sim3 = ttransform.procrustes(a, b)
        _same(tuple(sim3), tuple(jtransform.procrustes(a, b)), atol=0)
        np.testing.assert_array_equal(
            ttransform.apply_sim3(sim3, b),
            jtransform.apply_sim3(jtransform.Sim3(*sim3), b))


def _transform_case(tmp_path):
    """test_transform_colmap's old model and the new one rotated, scaled
    and moved, with an outlier camera and filtered points."""
    rng = np.random.default_rng(4)
    cams, old_images, _ = _toy_model(n_img=12, seed=5)
    ang = 0.4
    r = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    s, t = 3.0, np.array([5.0, 1.0, -2.0])
    new_images = {}
    for k, im in old_images.items():
        center = (-cm.qvec2rotmat(im.qvec).T @ im.tvec) @ r.T * s + t
        r_new = cm.qvec2rotmat(im.qvec) @ r.T
        if k == 4:
            center = center + 500.0
        new_images[k] = cm.ColmapImage(
            im.id, cm.rotmat2qvec(r_new), -r_new @ center, im.camera_id,
            im.name, im.xys, im.point3d_ids)
    n_pts = 30
    errors = np.full(n_pts, 0.5, np.float32)
    errors[:5] = 9.0
    tracks = np.full(n_pts, 6, np.int64)
    tracks[5:8] = 1
    new_pts = cm.ColmapPointsFull(
        ids=np.arange(n_pts, dtype=np.int64),
        xyz=((rng.normal(size=(n_pts, 3)) @ r.T) * s + t).astype(np.float32),
        rgb=np.full((n_pts, 3), 128, np.uint8), errors=errors,
        track_lens=tracks)
    in_dir, new_dir = str(tmp_path / "old"), str(tmp_path / "new")
    empty = cm.ColmapPointsFull(np.zeros(0, np.int64),
                                np.zeros((0, 3), np.float32),
                                np.zeros((0, 3), np.uint8),
                                np.zeros(0, np.float32),
                                np.zeros(0, np.int64))
    _write_model(in_dir, cams, old_images, empty)
    _write_model(new_dir, cams, new_images, new_pts)
    for aux, val in (("center.txt", "0 0 0"), ("extent.txt", "10 10 10")):
        with open(os.path.join(in_dir, aux), "w") as f:
            f.write(val + "\n")
    return in_dir, new_dir, old_images, new_images


def test_transform_colmap_matches_jax(tmp_path):
    in_dir, new_dir, old_images, new_images = _transform_case(tmp_path)
    got = ttransform.align_models(old_images, new_images)
    ref = jtransform.align_models(old_images, new_images)
    _same(tuple(got[0]), tuple(ref[0]), atol=0)
    _same(got[1:], ref[1:], atol=0)
    assert not got[1][list(new_images).index(4)]
    outs = {}
    for tag, mod in (("t", ttransform), ("j", jtransform)):
        out = tmp_path / f"out_{tag}"
        sim3 = mod.transform_colmap(in_dir, new_dir, str(out))
        outs[tag] = (tuple(sim3), {p.relative_to(out): _bytes(p)
                                   for p in sorted(out.rglob("*"))
                                   if p.is_file()})
    _same(outs["t"][0], outs["j"][0], atol=0)
    assert outs["t"][1] == outs["j"][1] and len(outs["t"][1]) == 5
