"""Tile binning: duplicate Gaussians per overlapped tile, depth-ordered
within each tile (port of hlod_gaussians_tpu/ops/binning.py:52-250; the
reference's duplicateWithKeys + radix sort + identifyTileRanges,
rasterizer_impl.cu:70-142,319-373).

The entry list has a static capacity `max_dup`; what does not fit is
reported through `overflow`. As in the JAX package:

* Gaussians are pre-sorted by depth, entries are generated contiguously per
  depth-sorted Gaussian, and ONE stable sort on the tile id then leaves
  depth order inside every tile;
* with the tight extents of project_gaussians, each candidate rect is the
  intersection of the reference circle rect and the tight AABB, and each
  (gaussian, tile) candidate is refined by the circumscribed-circle test.

The JAX package's float tricks (ids riding f32 rows, reciprocal splits) are
TPU layout work; this port computes the same entries with integer math.
The CHUNK-aligned and compact layouts (binning.py:251-454) exist only for
the TPU's DMA and are not ported: the CUDA kernel reads the packed list.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class TileBins(NamedTuple):
    sorted_gid: torch.Tensor   # [max_dup] int32 ORIGINAL gaussian index per entry
    sorted_tile: torch.Tensor  # [max_dup] int32 tile id (== num_tiles for padding)
    sorted_gen: torch.Tensor   # [max_dup] int32 generation slot of each sorted entry
    tile_starts: torch.Tensor  # [num_tiles] int32 first entry of tile
    tile_counts: torch.Tensor  # [num_tiles] int32 entries in tile
    order: torch.Tensor        # [N] int32 depth-sort permutation (sorted -> orig)
    gen_offsets: torch.Tensor  # [N] int32 exclusive entry offsets per SORTED gaussian
    gen_counts: torch.Tensor   # [N] int32 entries per SORTED gaussian
    gen_valid: torch.Tensor    # [max_dup] bool — generation entry survived
    num_dup: torch.Tensor      # 0-d int32 — total kept entries
    num_candidates: torch.Tensor  # 0-d int32 — rect entries before refinement
    overflow: torch.Tensor     # 0-d bool — max_dup was exceeded


def tile_grid(width: int, height: int, tile_w: int, tile_h: int):
    gw = -(-width // tile_w)
    gh = -(-height // tile_h)
    return gw, gh


def compute_rects(xy, radius, width: int, height: int, tile_w: int,
                  tile_h: int):
    """Per-Gaussian tile rectangle (auxiliary.h getRect): (min_x, min_y, w, h)
    in tile units, clipped to the grid."""
    gw, gh = tile_grid(width, height, tile_w, tile_h)
    r = radius.to(torch.float32)
    min_x = torch.clamp(torch.floor((xy[..., 0] - r) / tile_w), 0, gw).to(torch.int32)
    min_y = torch.clamp(torch.floor((xy[..., 1] - r) / tile_h), 0, gh).to(torch.int32)
    max_x = torch.clamp(torch.floor((xy[..., 0] + r + tile_w - 1) / tile_w),
                        0, gw).to(torch.int32)
    max_y = torch.clamp(torch.floor((xy[..., 1] + r + tile_h - 1) / tile_h),
                        0, gh).to(torch.int32)
    return (min_x, min_y, torch.clamp_min(max_x - min_x, 0),
            torch.clamp_min(max_y - min_y, 0))


def compute_rects_tight(xy, ext, width: int, height: int, tile_w: int,
                        tile_h: int):
    """Tile rectangle of the integer pixel centers inside the tight AABB
    (|ix - gx| <= ext_x and |iy - gy| <= ext_y), clipped to the image."""
    lo_x = torch.clamp_min(torch.ceil(xy[..., 0] - ext[..., 0]), 0.0)
    hi_x = torch.clamp_max(torch.floor(xy[..., 0] + ext[..., 0]), width - 1)
    lo_y = torch.clamp_min(torch.ceil(xy[..., 1] - ext[..., 1]), 0.0)
    hi_y = torch.clamp_max(torch.floor(xy[..., 1] + ext[..., 1]), height - 1)
    empty = (lo_x > hi_x) | (lo_y > hi_y)
    min_x = torch.floor(lo_x / tile_w)
    min_y = torch.floor(lo_y / tile_h)
    rw = torch.floor(hi_x / tile_w) - min_x + 1.0
    rh = torch.floor(hi_y / tile_h) - min_y + 1.0
    zero = torch.zeros_like(rw)
    return (torch.where(empty, zero, min_x).to(torch.int32),
            torch.where(empty, zero, min_y).to(torch.int32),
            torch.where(empty, zero, rw).to(torch.int32),
            torch.where(empty, zero, rh).to(torch.int32))


def _make_candidates(xy, depth, radius, valid, width: int, height: int,
                     tile_w: int, tile_h: int, max_dup: int,
                     ext: Optional[torch.Tensor] = None,
                     reff2: Optional[torch.Tensor] = None):
    """Per-entry (tile_id, gid, keep) over `max_dup` generation slots.

    Entries are generated contiguously per DEPTH-SORTED Gaussian, so one
    stable sort on tile id yields depth order within every tile."""
    n = xy.shape[0]
    if n == 0:
        raise ValueError("binning needs at least one Gaussian row")
    dev = xy.device
    gw, gh = tile_grid(width, height, tile_w, tile_h)
    num_tiles = gw * gh

    if ext is not None:
        # coverage = {reference circle rect} ∩ {tight AABB}
        tx0, ty0, trw, trh = compute_rects_tight(
            xy, ext, width, height, tile_w, tile_h)
        rx0, ry0, rrw, rrh = compute_rects(
            xy, radius, width, height, tile_w, tile_h)
        min_x = torch.maximum(tx0, rx0)
        min_y = torch.maximum(ty0, ry0)
        rw = torch.clamp_min(torch.minimum(tx0 + trw, rx0 + rrw) - min_x, 0)
        rh = torch.clamp_min(torch.minimum(ty0 + trh, ry0 + rrh) - min_y, 0)
    else:
        min_x, min_y, rw, rh = compute_rects(
            xy, radius, width, height, tile_w, tile_h)
    touched = torch.where(valid, rw * rh, torch.zeros_like(rw)).to(torch.int32)

    # depth pre-sort (empty rows to the back)
    dkey = torch.where(touched > 0, depth, torch.full_like(depth, float("inf")))
    order = torch.sort(dkey, stable=True).indices

    touched_s = touched[order]
    # int64 offsets cannot wrap: the JAX package needs an extra f32 total to
    # keep `overflow` true past 2^31 candidates; here the exact total does it
    offsets = torch.cumsum(touched_s.to(torch.int64), 0)
    total_cand = offsets[-1]
    offsets_exc = offsets - touched_s

    slot = torch.arange(max_dup, dtype=torch.int64, device=dev)
    # entry -> sorted-gaussian index: the segment whose inclusive end lies
    # past the slot (zero-count segments are skipped by construction)
    gid_s = torch.clamp_max(torch.searchsorted(offsets, slot, right=True),
                            n - 1)
    in_range = slot < total_cand
    src = order[gid_s]                      # original gaussian index
    rw_g = torch.clamp_min(rw, 1).to(torch.int64)[src]
    gx, gy = xy[src, 0], xy[src, 1]

    rank = slot - offsets_exc[gid_s]
    ty_rel = torch.div(rank, rw_g, rounding_mode="floor")
    tx = min_x.to(torch.int64)[src] + rank - ty_rel * rw_g
    ty = min_y.to(torch.int64)[src] + ty_rel

    keep = in_range
    if reff2 is not None:
        # circumscribed-circle refinement: the distance from the tile's pixel
        # box to the center must not exceed the iso-ellipse circumradius
        x0 = (tx * tile_w).to(torch.float32)
        y0 = (ty * tile_h).to(torch.float32)
        cx = torch.minimum(torch.maximum(gx, x0),
                           torch.clamp_max(x0 + (tile_w - 1), width - 1))
        cy = torch.minimum(torch.maximum(gy, y0),
                           torch.clamp_max(y0 + (tile_h - 1), height - 1))
        dx = gx - cx
        dy = gy - cy
        keep = keep & (dx * dx + dy * dy <= reff2[src])

    tile_id = torch.where(keep, ty * gw + tx,
                          torch.full_like(tx, num_tiles)).to(torch.int32)
    overflow = total_cand > max_dup
    return (tile_id, src.to(torch.int32), slot.to(torch.int32), keep,
            order.to(torch.int32), offsets_exc.to(torch.int32), touched_s,
            total_cand, overflow)


def bin_gaussians(xy, depth, radius, valid, width: int, height: int,
                  tile_w: int, tile_h: int, max_dup: int,
                  ext: Optional[torch.Tensor] = None,
                  reff2: Optional[torch.Tensor] = None) -> TileBins:
    """Build the tile-sorted (depth-ordered within tile) entry list.

    With ext/reff2 (from project_gaussians) the tight alpha-aware coverage is
    used; otherwise the reference's circle rects."""
    gw, gh = tile_grid(width, height, tile_w, tile_h)
    num_tiles = gw * gh
    (tile_id, gid_orig, slot, keep, order, offsets_exc, touched_s,
     total_cand, overflow) = _make_candidates(
        xy, depth, radius, valid, width, height, tile_w, tile_h, max_dup,
        ext=ext, reff2=reff2)

    sorted_tile, perm = torch.sort(tile_id, stable=True)
    sorted_gid = gid_orig[perm]
    sorted_gen = slot[perm]

    bounds = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, dtype=torch.int32,
                                  device=xy.device)).to(torch.int32)
    tile_starts = bounds[:num_tiles]
    tile_counts = bounds[1:] - tile_starts

    return TileBins(sorted_gid=sorted_gid, sorted_tile=sorted_tile,
                    sorted_gen=sorted_gen,
                    tile_starts=tile_starts.contiguous(),
                    tile_counts=tile_counts.contiguous(),
                    order=order, gen_offsets=offsets_exc,
                    gen_counts=touched_s, gen_valid=keep,
                    num_dup=bounds[num_tiles],
                    num_candidates=torch.clamp_max(total_cand, max_dup).to(
                        torch.int32),
                    overflow=overflow)
