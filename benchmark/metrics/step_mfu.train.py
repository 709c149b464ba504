"""The training step's counted f32 operations (blend both ways for the
needed pairs, projection and SH both ways and Adam for the visible
Gaussians) over its untraced time, as a share of the f32 peak."""


def read(r):
    return r.mfu_pct()
