"""The JAX package's kNN scale init with its Morton wrap taken out, for
the tests that hold the port's kNN-initialized states to the JAX
package's.

Both packages quantize each axis to 21 bits by truncating
(p - lo) / (hi - lo) * 2^21, so the largest point of each axis maps to
2^21, whose set bit falls outside the interleaved code. On every curve of
the JAX `knn_mean_sq_dist` that point sits at coordinate 0 of its axis,
far from its neighbours, and its mean squared distance is one of whole
scene units: its Gaussian then covers the frame. The port's kNN keeps the
point in the last cell (`hlod_gaussians_torch/ops/morton.py`,
``wrap_max=False``); tests/test_torch_knn.py shows both packages.
`knn_keeps_axis_max()` gives the JAX kNN that quantization for the length
of a block and leaves the rest of the JAX code as it is.
"""

import contextlib
import types

import jax
import jax.numpy as jnp

from hlod_gaussians_tpu.ops import knn as jknn
from hlod_gaussians_tpu.ops import morton as jmorton


def morton_argsort_keep_max(points, lo=None, hi=None):
    """The JAX `morton_argsort` with a coordinate at the axis maximum in
    the last cell (all 21 bits of its axis set) rather than at 0."""
    hi_w, lo_w = jmorton.morton_codes(points, lo, hi)
    lo = points.min(axis=0) if lo is None else lo
    hi = points.max(axis=0) if hi is None else hi
    scale = jnp.where(hi > lo, (hi - lo), 1.0)
    # the JAX quantization's own expression: a point wraps where it reaches
    # 2^21 there
    top = (points - lo) / scale * (1 << 21) >= (1 << 21)
    for a in range(3):
        pos = [3 * i + a for i in range(21)]
        m_lo = sum(1 << p for p in pos if p < 31)
        m_hi = sum(1 << (p - 31) for p in pos if p >= 31)
        lo_w = jnp.where(top[:, a], lo_w | jnp.uint32(m_lo), lo_w)
        hi_w = jnp.where(top[:, a], hi_w | jnp.uint32(m_hi), hi_w)
    idx = jnp.arange(points.shape[0], dtype=jnp.int32)
    return jax.lax.sort((hi_w, lo_w, idx), num_keys=2)[2]


@contextlib.contextmanager
def knn_keeps_axis_max():
    """Within the block, the JAX package's `knn_mean_sq_dist` (and so its
    create_from_points / create_with_scaffold / init_coarse) sorts on
    `morton_argsort_keep_max`: a copy of the function whose globals name
    that sort, under a jit of its own (jit reuses a trace of the same
    function object)."""
    knn = jknn.knn_mean_sq_dist
    fn = knn.__wrapped__
    copy = types.FunctionType(
        fn.__code__, dict(fn.__globals__,
                          morton_argsort=morton_argsort_keep_max),
        fn.__name__, fn.__defaults__, fn.__closure__)
    copy.__kwdefaults__ = fn.__kwdefaults__
    jknn.knn_mean_sq_dist = jax.jit(
        copy, static_argnames=("k", "window", "shifts"))
    try:
        yield
    finally:
        jknn.knn_mean_sq_dist = knn
