"""Host milliseconds a served frame spends in projection, SH and binning: the
self time of the program's spans `hlod.project` (covariances, the
projection, SH colour, inverse depth) and `hlod.bin` (the tile binning)
inside render_arrays.

The same reading in the cells whose frames are bound by host dispatch (a
coarse cut), whose end-to-end metrics carry the suffix `.coarse`."""

from benchmark.harness import spans

SPANS = ("hlod.project", "hlod.bin")


def read(r):
    return spans.self_ms(r, SPANS)
