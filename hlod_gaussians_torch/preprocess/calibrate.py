"""COLMAP calibration + per-chunk refinement drivers (a copy of
hlod_gaussians_tpu/preprocess/calibrate.py).

Equivalent of preprocess/generate_colmap.py:76-210 and
preprocess/prepare_chunk.py: drives the external COLMAP binary through
feature extraction, CUSTOM spatial matching via matches_importer (never the
O(N^2) exhaustive matcher), hierarchical mapping, undistortion, and the
per-chunk 2x triangulation + bundle-adjustment refinement. Gated on the
binary being present — every command is assembled the same way the
reference does, but the module degrades to a clear error instead of
assuming COLMAP exists. ``runner`` injection keeps the command assembly
testable without COLMAP.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Callable, List, Optional

import numpy as np


def colmap_available(binary: str = "colmap") -> bool:
    return shutil.which(binary) is not None


def _run(cmd: List[str]) -> None:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"{' '.join(cmd[:3])}... failed:\n{res.stderr[-2000:]}")


def make_spatial_matcher_pairs(image_names: List[str],
                               positions: Optional[np.ndarray],
                               n_neighbors: int = 60) -> List[str]:
    """Custom matcher pair list: each image matched against its spatial
    neighbors (preprocess/make_colmap_custom_matcher_distance.py). Without
    positions, falls back to a sequential +- window."""
    pairs = []
    if positions is not None and len(positions) == len(image_names):
        d = np.linalg.norm(positions[:, None] - positions[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        nn = np.argsort(d, axis=1)[:, :n_neighbors]
        for i, name in enumerate(image_names):
            for j in nn[i]:
                if i < j:
                    pairs.append(f"{name} {image_names[j]}")
    else:
        for i in range(len(image_names)):
            for j in range(i + 1, min(i + 1 + n_neighbors, len(image_names))):
                pairs.append(f"{image_names[i]} {image_names[j]}")
    return pairs


def write_match_list(path: str, pairs: List[str]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(pairs) + "\n")


def _list_images(img_path: str) -> List[str]:
    exts = (".jpg", ".jpeg", ".png", ".JPG", ".PNG")
    names = []
    for root, _, files in os.walk(img_path):
        rel = os.path.relpath(root, img_path)
        for f in sorted(files):
            if f.endswith(exts):
                names.append(f if rel == "." else os.path.join(rel, f))
    return sorted(names)


def run_calibration(project_dir: str, images_dir: str = "inputs/images",
                    binary: str = "colmap", use_gpu: bool = False,
                    n_neighbors: int = 60,
                    positions: Optional[np.ndarray] = None,
                    runner: Callable[[List[str]], None] = None) -> str:
    """feature_extractor -> custom matches_importer -> hierarchical_mapper
    -> undistorter (generate_colmap.py:76-210). Returns the aligned dir.

    The spatial pair list replaces exhaustive matching: O(N * n_neighbors)
    match work instead of O(N^2) — the reference's scalability requirement
    for thousands of photos."""
    run = runner or _run
    if runner is None and not colmap_available(binary):
        raise RuntimeError(
            "COLMAP binary not found; install COLMAP or provide a "
            "pre-calibrated sparse/ reconstruction")

    db = os.path.join(project_dir, "distorted", "database.db")
    sparse = os.path.join(project_dir, "distorted", "sparse")
    os.makedirs(os.path.dirname(db), exist_ok=True)
    os.makedirs(sparse, exist_ok=True)
    img_path = os.path.join(project_dir, images_dir)

    run([binary, "feature_extractor",
         "--database_path", db, "--image_path", img_path,
         "--ImageReader.single_camera_per_folder", "1",
         "--ImageReader.default_focal_length_factor", "0.5",
         "--ImageReader.camera_model", "OPENCV",
         "--SiftExtraction.use_gpu", "1" if use_gpu else "0"])

    # custom spatial matching (generate_colmap.py:92-115): pair list ->
    # matches_importer, never exhaustive_matcher
    names = _list_images(img_path) if os.path.isdir(img_path) else []
    pairs = make_spatial_matcher_pairs(names, positions, n_neighbors)
    match_list = os.path.join(project_dir, "distorted", "matching.txt")
    write_match_list(match_list, pairs)
    run([binary, "matches_importer", "--database_path", db,
         "--match_list_path", match_list,
         "--SiftMatching.use_gpu", "1" if use_gpu else "0"])

    run([binary, "hierarchical_mapper", "--database_path", db,
         "--image_path", img_path, "--output_path", sparse,
         "--Mapper.ba_global_function_tolerance", "0.000001"])
    und = os.path.join(project_dir, "camera_calibration", "aligned")
    os.makedirs(und, exist_ok=True)
    run([binary, "image_undistorter", "--image_path", img_path,
         "--input_path", os.path.join(sparse, "0"),
         "--output_path", und, "--output_type", "COLMAP"])
    return und


def refine_chunk(raw_chunk: str, out_chunk: str, images_dir: str,
                 binary: str = "colmap", skip_bundle_adjustment: bool = False,
                 positions: Optional[np.ndarray] = None,
                 image_names: Optional[List[str]] = None,
                 runner: Callable[[List[str]], None] = None) -> str:
    """Per-chunk reconstruction refinement (preprocess/prepare_chunk.py):
    re-extract features on the chunk's undistorted images, import distance
    matches, then run TWO rounds of point_triangulator +
    bundle_adjuster (poses refined, intrinsics frozen). Returns the refined
    sparse dir."""
    run = runner or _run
    if runner is None and not colmap_available(binary):
        raise RuntimeError("COLMAP binary not found")

    ba = os.path.join(raw_chunk, "bundle_adjustment")
    for sub in ("sparse/o", "sparse/t", "sparse/b", "sparse/t2", "sparse/0"):
        os.makedirs(os.path.join(ba, sub), exist_ok=True)
    db = os.path.join(ba, "database.db")

    matching_nb = 50 if skip_bundle_adjustment else 200
    names = image_names or []
    pairs = make_spatial_matcher_pairs(names, positions, matching_nb)
    match_list = os.path.join(ba, f"matching_{matching_nb}.txt")
    write_match_list(match_list, pairs)

    run([binary, "image_undistorter", "--image_path", images_dir,
         "--input_path", os.path.join(raw_chunk, "sparse", "0"),
         "--output_path", ba, "--output_type", "COLMAP"])
    run([binary, "feature_extractor", "--database_path", db,
         "--image_path", os.path.join(ba, "images"),
         "--ImageReader.existing_camera_id", "1"])
    run([binary, "matches_importer", "--database_path", db,
         "--match_list_path", match_list])

    tri = [binary, "point_triangulator",
           "--Mapper.ba_global_function_tolerance", "0.000001",
           "--Mapper.ba_global_max_num_iterations", "30",
           "--Mapper.ba_global_max_refinements", "3"]
    adj = [binary, "bundle_adjuster",
           "--BundleAdjustment.refine_extra_params", "0",
           "--BundleAdjustment.function_tolerance", "0.000001",
           "--BundleAdjustment.max_linear_solver_iterations", "100",
           "--BundleAdjustment.max_num_iterations", "50",
           "--BundleAdjustment.refine_focal_length", "0"]

    if skip_bundle_adjustment:
        run([binary, "point_triangulator",
             "--Mapper.ba_global_max_num_iterations", "5",
             "--Mapper.ba_global_max_refinements", "1",
             "--database_path", db,
             "--image_path", os.path.join(ba, "images"),
             "--input_path", os.path.join(ba, "sparse", "o"),
             "--output_path", os.path.join(ba, "sparse", "0")])
        return os.path.join(ba, "sparse", "0")

    # 2 rounds of triangulation + bundle adjustment (prepare_chunk.py)
    run(tri + ["--database_path", db,
               "--image_path", os.path.join(ba, "images"),
               "--input_path", os.path.join(ba, "sparse", "o"),
               "--output_path", os.path.join(ba, "sparse", "t")])
    run(adj + ["--input_path", os.path.join(ba, "sparse", "t"),
               "--output_path", os.path.join(ba, "sparse", "b")])
    run(tri + ["--database_path", db,
               "--image_path", os.path.join(ba, "images"),
               "--input_path", os.path.join(ba, "sparse", "b"),
               "--output_path", os.path.join(ba, "sparse", "t2")])
    run(adj + ["--input_path", os.path.join(ba, "sparse", "t2"),
               "--output_path", os.path.join(ba, "sparse", "0")])
    return os.path.join(ba, "sparse", "0")


def laplacian_variance(gray: np.ndarray) -> float:
    """Variance of the 4-neighbor Laplacian — the reference's blur score
    (cv2.Laplacian(...).var(), make_chunk.py:110-122), pure numpy."""
    g = np.asarray(gray, np.float32)
    lap = (-4.0 * g[1:-1, 1:-1] + g[:-2, 1:-1] + g[2:, 1:-1]
           + g[1:-1, :-2] + g[1:-1, 2:])
    return float(lap.var())


def blur_filter_mask(images: List[np.ndarray], lapla_thresh: float,
                     ) -> np.ndarray:
    """Per-chunk blur filter (make_chunk.py:120-122 + its usage): an image
    is kept when its Laplacian variance >= lapla_thresh * mean(variances of
    the chunk's images). lapla_thresh <= 0 keeps everything."""
    n = len(images)
    if lapla_thresh <= 0 or n == 0:
        return np.ones(n, bool)
    vs = np.asarray([laplacian_variance(
        im if im.ndim == 2 else im[..., :3].mean(-1)) for im in images])
    return vs >= lapla_thresh * vs.mean()


def run_depth_generator(images_dir: str, out_dir: str,
                        generator: str = "Depth-Anything-V2",
                        generator_dir: str = "",
                        runner: Callable[[List[str]], None] = None) -> None:
    """Monocular-depth driver hook (preprocess/generate_depth.py): invokes
    an external depth network (DPT or Depth-Anything-V2) per camera folder.
    The networks are externals in the reference too (submodule stubs); this
    assembles the same commands and is gated on the generator existing."""
    run = runner or _run
    if generator == "DPT":
        base = ["python", os.path.join(generator_dir, "run_monodepth.py"),
                "-t", "dpt_large"]
    elif generator == "Depth-Anything-V2":
        base = ["python", os.path.join(generator_dir, "run.py"),
                "--encoder", "vitl", "--pred-only", "--grayscale"]
    else:
        raise ValueError(generator)
    if runner is None and (not generator_dir
                           or not os.path.isdir(generator_dir)):
        raise RuntimeError(
            f"{generator} not found at {generator_dir!r}; clone it or pass "
            "pre-computed depth maps")

    cam_dirs = [d for d in sorted(os.listdir(images_dir))
                if os.path.isdir(os.path.join(images_dir, d))] or [""]
    os.makedirs(out_dir, exist_ok=True)
    for cam in cam_dirs:
        src = os.path.join(images_dir, cam) if cam else images_dir
        dst = os.path.join(out_dir, cam) if cam else out_dir
        if generator == "DPT":
            run(base + ["-i", src, "-o", dst])
        else:
            run(base + ["--img-path", src, "--outdir", dst])
