"""Device operations (kernels, copies, fills) one training step launches."""


def read(r):
    return r.launches_per_unit()
