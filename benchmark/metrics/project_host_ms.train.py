"""Host milliseconds a training step spends in projection, SH and binning: the
self time of the program's spans `hlod.project` (covariances, the
projection, SH colour, inverse depth) and `hlod.bin` (the tile binning)
inside render_arrays."""

from benchmark.harness import spans

SPANS = ("hlod.project", "hlod.bin")


def read(r):
    return spans.self_ms(r, SPANS)
