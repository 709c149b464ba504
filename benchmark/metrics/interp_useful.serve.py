"""Share of the interpolated rows that a served frame draws: 100 x the
program's counter `lod.nodes_drawn` over `lod.rows_interpolated`, which
render_lod_stream adds up from each frame's feedback (the tree's rows on
the masked path, the budget on the budgeted one)."""

from benchmark.harness import spans


def read(r):
    return spans.counter_pct("lod.nodes_drawn", "lod.rows_interpolated")
