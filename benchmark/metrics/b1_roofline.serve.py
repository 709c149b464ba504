"""Kernel B1 (csrc/blend_forward.cu) in a served frame: the least time the
card could take for the blend forward the frame needs, with the LOD
alpha, over the kernel's device time a frame."""

KERNELS = ("blend_forward_kernel",)


def read(r):
    return r.roofline_pct(KERNELS, "b1")
