"""Share of the rows a post step's per-row work covers that are in its
working set: 100 x the program's counter `post.ws_rows` over
`post.rows_projected`, which read_post_step adds up from each step's
feedback (the SPT cut's rows; the state's capacity)."""

from benchmark.harness import spans


def read(r):
    return spans.counter_pct("post.ws_rows", "post.rows_projected")
