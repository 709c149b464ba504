"""Device operations (kernels, copies, fills) one served frame launches."""


def read(r):
    return r.launches_per_unit()
