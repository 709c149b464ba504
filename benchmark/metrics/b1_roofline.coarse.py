"""Kernel B1 (csrc/blend_forward.cu) in a served frame: the least time the
card could take for the blend forward the frame needs, with the LOD
alpha, over the kernel's device time a frame.

The same reading in the cells whose frames are bound by host dispatch (a
coarse cut), whose end-to-end metrics carry the suffix `.coarse`."""

KERNELS = ("blend_forward_kernel",)


def read(r):
    return r.roofline_pct(KERNELS, "b1")
