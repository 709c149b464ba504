"""Median host milliseconds from the call into train_step to its return,
before the loss is read, over the untraced part of the window."""


def read(r):
    return r.dispatch_ms()
