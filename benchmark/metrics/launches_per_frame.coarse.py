"""Device operations (kernels, copies, fills) one served frame launches.

The same reading in the cells whose frames are bound by host dispatch (a
coarse cut), whose end-to-end metrics carry the suffix `.coarse`."""


def read(r):
    return r.launches_per_unit()
