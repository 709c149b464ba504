"""Host milliseconds a served frame spends in the blend's call: the self time
of the program's span `hlod.blend` around rasterize_tiles inside render_arrays
(the features' packing and the launch of kernel B1)."""

from benchmark.harness import spans

SPANS = ("hlod.blend",)


def read(r):
    return spans.self_ms(r, SPANS)
