"""Host milliseconds a served frame spends in the LOD cut and the
interpolation: the self time of the program's spans `hlod.cut` (the cut
over the tree), `hlod.compact` (the budgeted path's compaction and
gathers) and `hlod.interp` (the lerp, the skybox prepend, the quaternion
normalisation), each less the spans nested in it.

The same reading in the cells whose frames are bound by host dispatch (a
coarse cut), whose end-to-end metrics carry the suffix `.coarse`."""

from benchmark.harness import spans

SPANS = ("hlod.cut", "hlod.compact", "hlod.interp")


def read(r):
    return spans.self_ms(r, SPANS)
