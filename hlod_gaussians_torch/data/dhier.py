"""Hierarchy binary formats: the fork's `.dhier` and the upstream `.hier`
(port of hlod_gaussians_tpu/data/dhier.py; byte-compatible with the
reference writer, hierarchy_writer.cpp, and loader, hierarchy_loader.cpp).

`.dhier` (hierarchy_writer.cpp:122-168):
    int32 G | int32 sh_degree
    pos f32[G,3] | rot f32[G,4] | logscale f32[G,3] | opacity f32[G]
    shs f32[G, 3*(sh_degree+1)^2]
    int32 N | HierarchyNode int32[N,6]
        (depth, parent, child_count, first_child, next_sibling,
         max_side_length)

`.hier` (hierarchy_writer.cpp:27-119, hierarchy_loader.cpp:25-130):
    int32 P (negative => f16-compressed variant)
    pos f32[P,3] | rot f32[P,4] | logscale f32[P,3] | opacity f32[P]
    shs f32[P,48]
    int32 N | Node int32[N,7]
        (depth, parent, start, count_leafs, count_merged, start_children,
         count_children)
    Box f32[N,8]  (min xyz + w, max xyz + w; w = longest AABB side)

numpy only; the readers also take gzip-compressed files (magic 1f 8b).
"""

from __future__ import annotations

import gzip
import struct
import sys
from typing import NamedTuple

import numpy as np


class DHier(NamedTuple):
    sh_degree: int
    pos: np.ndarray        # [G,3] f32
    quat: np.ndarray       # [G,4]
    log_scale: np.ndarray  # [G,3]
    opacity: np.ndarray    # [G] (raw, as stored)
    shs: np.ndarray        # [G,K,3]
    nodes: np.ndarray      # [N,6] int32 (model node-table order)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if raw[:2] == b"\x1f\x8b" else raw


def _taker(raw: bytes, off: int):
    """take(dtype, shape) reads the next array of `raw` from `off` on
    (shape () reads one scalar)."""
    pos = [off]

    def take(dtype, shape):
        a = np.frombuffer(raw, dtype=dtype, count=int(np.prod(shape)),
                          offset=pos[0]).reshape(shape)
        pos[0] += a.nbytes
        return np.ascontiguousarray(a) if shape else a[()]

    return take


def save_dhier(path: str, h: DHier) -> None:
    g = h.pos.shape[0]
    k = (h.sh_degree + 1) ** 2
    if h.shs.shape[1] != k:
        raise ValueError(f"shs {h.shs.shape} does not hold {k} coefficients")
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", g, h.sh_degree))
        f.write(h.pos.astype("<f4").tobytes())
        f.write(h.quat.astype("<f4").tobytes())
        f.write(h.log_scale.astype("<f4").tobytes())
        f.write(h.opacity.astype("<f4").tobytes())
        f.write(h.shs.astype("<f4").reshape(g, -1).tobytes())
        f.write(struct.pack("<i", h.nodes.shape[0]))
        f.write(h.nodes.astype("<i4").tobytes())


def load_dhier(path: str) -> DHier:
    raw = _read(path)
    g, sh_degree = struct.unpack_from("<ii", raw, 0)
    take = _taker(raw, 8)
    pos = take("<f4", (g, 3))
    quat = take("<f4", (g, 4))
    log_scale = take("<f4", (g, 3))
    opacity = take("<f4", (g,))
    shs = take("<f4", (g, (sh_degree + 1) ** 2, 3))
    nodes = take("<i4", (int(take("<i4", ())), 6))
    return DHier(sh_degree=sh_degree, pos=pos, quat=quat,
                 log_scale=log_scale, opacity=opacity, shs=shs, nodes=nodes)


def save_gdf(path: str, nodes: np.ndarray, max_depth: int = 15) -> None:
    """Hierarchy graph dump in the reference's `.gdf` format
    (writer.cpp::writeHierarchyGDF + writeRec:294-340, max_depth 15 as the
    creator calls it, mainHierarchyCreator.cpp:184).

    Follows the reference algorithm exactly, including its labelling: each
    node's printed label is the shared edge counter's value at entry, so a
    node whose elder sibling subtree advanced the counter gets a label
    unrelated to its table index, and leaf labels repeat.
    ``nodes`` is the model node table [N,6].
    """
    n = nodes.shape[0]
    parent = nodes[:, 1]
    children: list = [[] for _ in range(n)]
    # preorder table: grouping by parent in increasing index order keeps
    # the sibling order
    for i in range(1, n):
        p = int(parent[i])
        if p >= 0:
            children[p].append(i)

    lines = ["nodedef>name VARCHAR \n"]
    edges: list = []
    counter = [0]

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, n + 100))
    try:
        def rec(i: int, parent_label: int, depth: int) -> None:
            lines.append(f"{counter[0]}\n")
            if not children[i] or depth >= max_depth:
                return
            for c in children[i]:
                edges.append((counter[0], parent_label))
                cur = counter[0]
                counter[0] += 1
                rec(c, cur, depth + 1)

        rec(0, -1, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    lines.append("edgedef>node1 VARCHAR,node2 VARCHAR\n")
    lines.extend(f"{a},{b}\n" for a, b in edges)
    with open(path, "w", newline="") as f:
        f.write("".join(lines))


class UpstreamHier(NamedTuple):
    pos: np.ndarray        # [P,3]
    quat: np.ndarray       # [P,4]
    log_scale: np.ndarray  # [P,3]
    opacity: np.ndarray    # [P]
    shs: np.ndarray        # [P,16,3]
    nodes: np.ndarray      # [N,7] int32 upstream Node layout
    boxes: np.ndarray      # [N,2,4] f32 (min4, max4)


# the compressed variant's HalfNode: int parent, start, start_children and
# short (depth, count_children, count_leafs, count_merged)
_HALF_NODE = np.dtype([("parent", "<i4"), ("start", "<i4"),
                       ("start_children", "<i4"), ("dccc", "<i2", (4,))])


def save_hier(path: str, h: UpstreamHier, compressed: bool = False) -> None:
    p = h.pos.shape[0]
    n = h.nodes.shape[0]
    with open(path, "wb") as f:
        if not compressed:
            f.write(struct.pack("<i", p))
            f.write(h.pos.astype("<f4").tobytes())
            f.write(h.quat.astype("<f4").tobytes())
            f.write(h.log_scale.astype("<f4").tobytes())
            f.write(h.opacity.astype("<f4").tobytes())
            f.write(h.shs.astype("<f4").reshape(p, -1).tobytes())
            f.write(struct.pack("<i", n))
            f.write(h.nodes.astype("<i4").tobytes())
            f.write(h.boxes.astype("<f4").tobytes())
            return
        # the short fields would overflow silently in numpy; the reference
        # writer refuses past 32000 (hierarchy_writer.cpp:27-119), which the
        # root's count_leafs reaches in any scene of more than 32k leaves
        for col in (0, 6, 3, 4):
            if np.abs(h.nodes[:, col]).max(initial=0) > 32000:
                raise ValueError(
                    "compressed .hier cannot hold node counts > 32000 "
                    f"(column {col}); write uncompressed instead")
        f.write(struct.pack("<i", -p))
        f.write(h.pos.astype("<f4").tobytes())
        f.write(h.quat.astype("<f2").tobytes())
        f.write(h.log_scale.astype("<f2").tobytes())
        f.write(h.opacity.astype("<f2").tobytes())
        f.write(h.shs.astype("<f2").reshape(p, -1).tobytes())
        f.write(struct.pack("<i", n))
        hn = np.zeros(n, dtype=_HALF_NODE)
        hn["parent"] = h.nodes[:, 1]
        hn["start"] = h.nodes[:, 2]
        hn["start_children"] = h.nodes[:, 5]
        hn["dccc"][:, 0] = h.nodes[:, 0]
        hn["dccc"][:, 1] = h.nodes[:, 6]
        hn["dccc"][:, 2] = h.nodes[:, 3]
        hn["dccc"][:, 3] = h.nodes[:, 4]
        f.write(hn.tobytes())
        f.write(h.boxes.astype("<f2").tobytes())


def load_hier(path: str) -> UpstreamHier:
    raw = _read(path)
    (p,) = struct.unpack_from("<i", raw, 0)
    take = _taker(raw, 4)
    compressed = p < 0
    p = abs(p)
    f = "<f2" if compressed else "<f4"

    def take_f(shape):
        return take(f, shape).astype(np.float32)

    xyz = take("<f4", (p, 3))
    quat = take_f((p, 4))
    log_scale = take_f((p, 3))
    opacity = take_f((p,))
    shs = take_f((p, 16, 3))
    n = int(take("<i4", ()))
    if not compressed:
        nodes = take("<i4", (n, 7))
    else:
        hn = take(_HALF_NODE, (n,))
        nodes = np.zeros((n, 7), np.int32)
        nodes[:, 0] = hn["dccc"][:, 0]
        nodes[:, 1] = hn["parent"]
        nodes[:, 2] = hn["start"]
        nodes[:, 3] = hn["dccc"][:, 2]
        nodes[:, 4] = hn["dccc"][:, 3]
        nodes[:, 5] = hn["start_children"]
        nodes[:, 6] = hn["dccc"][:, 1]
    boxes = take_f((n, 2, 4))
    return UpstreamHier(pos=xyz, quat=quat, log_scale=log_scale,
                        opacity=opacity, shs=shs, nodes=nodes, boxes=boxes)
