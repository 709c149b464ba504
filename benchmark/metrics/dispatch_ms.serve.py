"""Median host milliseconds from the call into render_lod_stream to its
return, before the image is copied out, over the untraced part of the
window."""


def read(r):
    return r.dispatch_ms()
