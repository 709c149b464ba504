"""Share of the traced training window with no device operation."""


def read(r):
    return r.idle_pct()
