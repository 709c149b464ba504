"""Host milliseconds a served frame spends in the blend's call: the self time
of the program's span `hlod.blend` around rasterize_tiles inside render_arrays
(the features' packing and the launch of kernel B1).

The same reading in the cells whose frames are bound by host dispatch (a
coarse cut), whose end-to-end metrics carry the suffix `.coarse`."""

from benchmark.harness import spans

SPANS = ("hlod.blend",)


def read(r):
    return spans.self_ms(r, SPANS)
