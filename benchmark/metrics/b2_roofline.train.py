"""Kernel B2 (csrc/blend_backward.cu) in the training step: the least time
the card could take for the blend backward the step needs, over the
kernel's device time a step."""

KERNELS = ("blend_backward_kernel",)


def read(r):
    return r.roofline_pct(KERNELS, "b2")
