"""Median host milliseconds from the call into render_lod_stream to its
return, before the image is copied out, over the untraced part of the
window.

The same reading in the cells whose frames are bound by host dispatch (a
coarse cut), whose end-to-end metrics carry the suffix `.coarse`."""


def read(r):
    return r.dispatch_ms()
