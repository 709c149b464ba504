"""Share of the traced serving window with no device operation."""


def read(r):
    return r.idle_pct()
