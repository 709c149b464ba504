"""Camera schedulers: shuffled epochs and cache-coherent random walks (port
of hlod_gaussians_tpu/utils/scheduler.py, numpy and stdlib sqlite3 only).

The fork trains the out-of-core model with a Metropolis–Hastings random walk
over a camera graph so consecutive views share most of their SPT working
set (reference consistency_graph.py:18-48,
construct_distance_graph.py:24-92): over a kNN distance graph of the camera
centres, or over the co-visibility graph `load_covisibility_graph` reads
from a COLMAP database.
"""

from __future__ import annotations

import sqlite3

from typing import Optional

import numpy as np


def knn_camera_graph(centers: np.ndarray, k: int = 8) -> np.ndarray:
    """[N,k] neighbor indices by euclidean camera-center distance
    (construct_distance_graph.py:24-92)."""
    n = centers.shape[0]
    d = np.linalg.norm(centers[:, None, :] - centers[None, :, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    k = min(k, max(n - 1, 1))
    return np.argsort(d, axis=1)[:, :k]


def metropolis_hastings_walk(
    neighbors: np.ndarray,
    n_steps: int,
    rng: np.random.Generator,
    visit_temper: float = 0.5,
) -> np.ndarray:
    """Random walk preferring less-visited neighbors (reference
    metropolis_hastings_walk, consistency_graph.py:18-48): from the current
    camera propose a uniform neighbor and accept with probability
    min(1, (1+v_cur)/(1+v_prop))^temper; occasionally jump uniformly."""
    n = neighbors.shape[0]
    visits = np.zeros(n, np.int64)
    cur = int(rng.integers(n))
    out = np.empty(n_steps, np.int64)
    for t in range(n_steps):
        out[t] = cur
        visits[cur] += 1
        if rng.random() < 0.02:   # teleport to escape islands
            cur = int(rng.integers(n))
            continue
        prop = int(neighbors[cur, rng.integers(neighbors.shape[1])])
        accept = ((1.0 + visits[cur]) / (1.0 + visits[prop])) ** visit_temper
        if rng.random() < min(1.0, accept):
            cur = prop
    return out


def shuffled_epochs(n: int, n_steps: int, rng: np.random.Generator
                    ) -> np.ndarray:
    """Plain reshuffled epochs (the reference's default DataLoader order)."""
    reps = -(-n_steps // n)
    out = np.concatenate([rng.permutation(n) for _ in range(reps)])
    return out[:n_steps]


def view_schedule(centers: Optional[np.ndarray], n_views: int, n_steps: int,
                  seed: int = 0, walk: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if walk and centers is not None and n_views > 1:
        return metropolis_hastings_walk(knn_camera_graph(centers), n_steps, rng)
    return shuffled_epochs(n_views, n_steps, rng)


def pair_id_to_image_ids(pair_id: int):
    """COLMAP pair_id decode (reference consistency_graph.py:8-11)."""
    image_id2 = pair_id % 2147483647
    image_id1 = (pair_id - image_id2) // 2147483647
    return int(image_id1), int(image_id2)


def load_covisibility_graph(database_path: str, min_matches: int = 1):
    """Camera co-visibility graph from a COLMAP database's
    two_view_geometries table (reference load_consistency_graph,
    consistency_graph.py:66-86) -> (sorted image ids, neighbors [N, k]
    index array padded with each row's first neighbor, weights [N, k] the
    verified match counts), ready for metropolis_hastings_walk."""
    conn = sqlite3.connect(database_path)
    try:
        pairs = conn.execute(
            "SELECT pair_id, rows FROM two_view_geometries;").fetchall()
    finally:
        conn.close()

    adj = {}
    for pair_id, matches in pairs:
        if matches is None or matches < min_matches:
            continue
        a, b = pair_id_to_image_ids(pair_id)
        adj.setdefault(a, {})[b] = matches
        adj.setdefault(b, {})[a] = matches

    ids = sorted(adj)
    index = {im: i for i, im in enumerate(ids)}
    k = max(max((len(v) for v in adj.values()), default=1), 1)
    neighbors = np.zeros((len(ids), k), np.int64)
    weights = np.zeros((len(ids), k), np.float64)
    for im, nbrs in adj.items():
        i = index[im]
        for j, (nb, w) in enumerate(sorted(nbrs.items())):
            neighbors[i, j] = index[nb]
            weights[i, j] = w
        neighbors[i, len(nbrs):] = neighbors[i, 0]
    return ids, neighbors, weights
