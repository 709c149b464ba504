"""Kernel B1 (csrc/blend_forward.cu) in the training step: the least time
the card could take for the blend forward the step needs, over the
kernel's device time a step."""

KERNELS = ("blend_forward_kernel",)


def read(r):
    return r.roofline_pct(KERNELS, "b1")
