"""Compute ops: spherical harmonics, quaternions, projection, binning,
rasterization, image losses."""


def gather_rows(tables, idx):
    """Gather several same-length 1-D tensors by one shared index vector
    (port of hlod_gaussians_tpu/ops/__init__.py::gather_rows). The JAX
    version bit-casts the rows into one stacked table because separate 1-D
    gathers scalarize on the TPU; on the GPU each gather is one coalesced
    kernel, so the rows are gathered as they are, dtypes kept."""
    return [t[idx] for t in tables]
