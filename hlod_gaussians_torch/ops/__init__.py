"""Compute ops: spherical harmonics, quaternions, projection, binning,
rasterization, image losses."""

import torch


def gather_rows(tables, idx):
    """Gather several same-length 1-D tensors by one shared index vector
    (port of hlod_gaussians_tpu/ops/__init__.py::gather_rows). The JAX
    version bit-casts the rows into one stacked table because separate 1-D
    gathers scalarize on the TPU; on the GPU each gather is one coalesced
    kernel, so the rows are gathered as they are, dtypes kept."""
    return [t[idx] for t in tables]


def drop_index(idx, size: int):
    """JAX's scatter index under mode="drop" as a row of a table with one
    spare row appended: a negative index wraps once, and one still outside
    [0, size) becomes `size`, the spare row that takes the dropped writes."""
    idx = idx.long()
    idx = idx.where(idx >= 0, idx + size)
    return idx.where((idx >= 0) & (idx < size), size)


def mark_rows(size: int, idx):
    """[size] bool, True at the rows of `idx` kept under mode="drop"."""
    out = torch.zeros((size + 1,), dtype=torch.bool, device=idx.device)
    out[drop_index(idx, size)] = True
    return out[:size]
