"""The served frame's counted f32 operations (the cut over the tree, the
interpolation, projection and SH of the drawn nodes, the blend with the
LOD alpha for the needed pairs) over its untraced time, as a share of the
f32 peak.

The same reading in the cells whose frames are bound by host dispatch (a
coarse cut), whose end-to-end metrics carry the suffix `.coarse`."""


def read(r):
    return r.mfu_pct()
