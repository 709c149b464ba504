"""The served frame's counted f32 operations (the cut over the tree, the
interpolation, projection and SH of the drawn nodes, the blend with the
LOD alpha for the needed pairs) over its untraced time, as a share of the
f32 peak."""


def read(r):
    return r.mfu_pct()
