"""Share of the traced serving window with no device operation.

The same reading in the cells whose frames are bound by host dispatch (a
coarse cut), whose end-to-end metrics carry the suffix `.coarse`."""


def read(r):
    return r.idle_pct()
