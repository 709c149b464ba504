"""The fork's `.dhier` hierarchy file (port of the reader in
hlod_gaussians_tpu/data/dhier.py:32-81; format of hierarchy_writer.cpp
:122-168):

    int32 G | int32 sh_degree
    pos f32[G,3] | rot f32[G,4] | logscale f32[G,3] | opacity f32[G]
    shs f32[G, 3*(sh_degree+1)^2]
    int32 N | HierarchyNode int32[N,6]
        (depth, parent, child_count, first_child, next_sibling,
         max_side_length)

numpy only; gzip-compressed files (magic 1f 8b) are read as well.
"""

from __future__ import annotations

import gzip
import struct
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


def load_dhier(path: str) -> DHier:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    off = 0

    def take(dtype, shape):
        nonlocal off
        a = np.frombuffer(raw, dtype=dtype, count=int(np.prod(shape)),
                          offset=off).reshape(shape)
        off += a.nbytes
        return np.ascontiguousarray(a)

    g, sh_degree = struct.unpack_from("<ii", raw, 0)
    off = 8
    pos = take("<f4", (g, 3))
    quat = take("<f4", (g, 4))
    log_scale = take("<f4", (g, 3))
    opacity = take("<f4", (g,))
    shs = take("<f4", (g, (sh_degree + 1) ** 2, 3))
    (n,) = struct.unpack_from("<i", raw, off)
    off += 4
    nodes = take("<i4", (n, 6))
    return DHier(sh_degree=sh_degree, pos=pos, quat=quat,
                 log_scale=log_scale, opacity=opacity, shs=shs, nodes=nodes)
