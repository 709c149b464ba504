"""The traced part of a `--trace 1` run: `torch.profiler` over whole units
(steps or frames), each inside a `bench.unit` span, and the arithmetic the
per-layer readers and the result's `device` and `breakdown` take from it.

Device busy time is the union of the device operations' intervals (kernels,
copies and fills; the spans' own device-side annotations are left out)
inside the window, which runs from the first span's start to the last
one's end. An idle gap is an interval of the window with no device
operation; it is put down to the innermost host operation running at its
middle.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np

SPAN = "bench.unit"
GAPS_ATTRIBUTED = 500
NAME_CHARS = 160         # kernel names are cut to this many characters


class Trace(NamedTuple):
    device_ops: list      # [(name, start_us, end_us)]
    host_ops: list        # [(name, start_us, end_us)]
    window_us: tuple      # (start, end)
    units: int
    records: list         # what each unit returned
    host_s: float         # the host clock over the traced units


def profile_units(unit, n: int, sync) -> Trace:
    """Runs `unit()` n times under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    records = []
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            with record_function(SPAN):
                records.append(unit())
        sync()
        host_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if e.name != SPAN:
                dev.append(item)
        else:
            host.append(item)
    spans = [h for h in host if h[0] == SPAN]
    window = ((min(s[1] for s in spans), max(s[2] for s in spans))
              if spans else (0.0, 0.0))
    dev = [d for d in dev if d[2] > window[0] and d[1] < window[1]]
    return Trace(dev, host, window, n, records, host_s)


def busy_intervals(tr: Trace):
    """The merged device intervals, clipped to the window."""
    w0, w1 = tr.window_us
    merged = []
    for _, a, b in sorted(tr.device_ops, key=lambda d: d[1]):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) / 1e6


def window_s(tr: Trace) -> float:
    return (tr.window_us[1] - tr.window_us[0]) / 1e6


def device_ops_top(tr: Trace, n=10):
    """The device operations that took most time: [[name, seconds]]."""
    by = defaultdict(float)
    for name, a, b in tr.device_ops:
        by[name[:NAME_CHARS]] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps_top(tr: Trace, n=10):
    """The longest idle gaps, summed by the host operation at their
    middle: [[name, seconds]]."""
    w0, w1 = tr.window_us
    edges = [w0]
    for a, b in busy_intervals(tr):
        edges += [a, b]
    edges.append(w1)
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:GAPS_ATTRIBUTED]
    if not gaps or not tr.host_ops:
        return []
    names = [h[0] for h in tr.host_ops]
    start = np.array([h[1] for h in tr.host_ops])
    end = np.array([h[2] for h in tr.host_ops])
    length = end - start
    by = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = (start <= mid) & (end >= mid)
        if inside.any():
            i = int(np.flatnonzero(inside)[np.argmin(length[inside])])
            name = names[i][:NAME_CHARS]
        else:
            name = "host (no operation)"
        by[name] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
