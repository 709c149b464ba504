"""COLMAP SQLite database seeding for the known-pose pipeline.

A copy of hlod_gaussians_tpu/preprocess/database.py, the equivalent of
the reference's
``preprocess/fill_database.py`` (+ the slice of COLMAP's ``database.py``
it uses): create a fresh COLMAP-schema database and pre-register the
cameras and images of an existing sparse model, so COLMAP's
feature_extractor / matcher / point_triangulator run against KNOWN poses
instead of re-estimating them. Pure sqlite3 + numpy — the schema below is
the COLMAP 3.x public database layout (only the tables the known-pose
flow touches are exercised; the rest exist so COLMAP accepts the file).
"""

from __future__ import annotations

import os
import sqlite3
from typing import Dict, Optional

import numpy as np

from hlod_gaussians_torch.data import colmap as cm

# COLMAP packs (image_id1, image_id2) pairs into one 64-bit key
_MAX_IMAGE_ID = 2 ** 31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def image_pair_id(image_id1: int, image_id2: int) -> int:
    """COLMAP's symmetric pair key (database.py image_ids_to_pair_id)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * _MAX_IMAGE_ID + image_id2


class ColmapDatabase:
    """Minimal COLMAP database writer (the subset fill_database needs)."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)

    def create_tables(self) -> None:
        self.conn.executescript(_SCHEMA)

    def add_camera(self, model_id: int, width: int, height: int,
                   params: np.ndarray, camera_id: Optional[int] = None,
                   prior_focal_length: bool = False) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model_id, int(width), int(height),
             np.asarray(params, np.float64).tobytes(),
             int(prior_focal_length)))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int,
                  image_id: Optional[int] = None,
                  prior_q: Optional[np.ndarray] = None,
                  prior_t: Optional[np.ndarray] = None) -> int:
        q = (np.full(4, np.nan) if prior_q is None
             else np.asarray(prior_q, np.float64))
        t = (np.full(3, np.nan) if prior_t is None
             else np.asarray(prior_t, np.float64))
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, int(camera_id),
             q[0], q[1], q[2], q[3], t[0], t[1], t[2]))
        return cur.lastrowid

    def commit(self) -> None:
        self.conn.commit()

    def close(self) -> None:
        self.conn.close()

    # -- read-back helpers (tests / validation) --------------------------
    def cameras(self) -> Dict[int, tuple]:
        rows = self.conn.execute(
            "SELECT camera_id, model, width, height, params FROM cameras")
        return {r[0]: (r[1], r[2], r[3],
                       np.frombuffer(r[4], np.float64)) for r in rows}

    def images(self) -> Dict[int, tuple]:
        rows = self.conn.execute(
            "SELECT image_id, name, camera_id FROM images")
        return {r[0]: (r[1], r[2]) for r in rows}


def seed_database(sparse_dir: str, database_path: str,
                  with_pose_priors: bool = False) -> int:
    """Seed a fresh COLMAP database from an existing sparse model
    (reference preprocess/fill_database.py): every camera and image is
    registered under its ORIGINAL id so a later point_triangulator keeps
    the known poses. Returns the number of images registered."""
    if os.path.exists(database_path):
        os.remove(database_path)
    cams, images, _ = cm.read_model(sparse_dir)
    db = ColmapDatabase(database_path)
    db.create_tables()
    for cid, cam in cams.items():
        mid, _ = cm.MODEL_IDS[cam.model]
        db.add_camera(mid, cam.width, cam.height, cam.params, camera_id=cid)
    for iid, im in images.items():
        db.add_image(im.name, im.camera_id, image_id=iid,
                     prior_q=im.qvec if with_pose_priors else None,
                     prior_t=im.tvec if with_pose_priors else None)
    db.commit()
    db.close()
    return len(images)
