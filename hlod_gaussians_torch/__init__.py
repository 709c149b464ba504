"""hlod_gaussians_torch — the PyTorch/CUDA port of hlod_gaussians_tpu.

The JAX package beside this one is the reference: every module here mirrors
a module path and function name there, and `tests/test_torch_*.py` hold each
port to its counterpart on the same inputs. This package imports `torch`,
never `jax`, and nothing from `hlod_gaussians_tpu`.

The TPU's two Pallas blend kernels are replaced by hand-written CUDA
kernels for Hopper (`csrc/blend_forward.cu` and its backward
`csrc/blend_backward.cu`, wrappers in `ops/rasterize_cuda.py`), built with
`nvcc` at first use. On CPU tensors the wrappers run the kernels' plain
PyTorch versions (`ops/rasterize_xla.py`), which the tests use.

Public entry points that create tensors take an explicit ``device=`` and
default to ``torch.device("cuda")``; the tests pass ``device="cpu"``.
"""

__version__ = "0.1.0"
