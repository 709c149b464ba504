"""What the per-layer readers of the program's own tracing share: the
`hlod.*` spans that hlod_gaussians_torch opens inside its entry points
(host events on torch.profiler's clock, in the trace's host operations)
and its process-wide counters.

A span's self time is its duration less the part that the `hlod.*` spans
nested in it cover; the spans of one thread nest, so a span's parent is
the innermost span that holds it. A program without these spans or
counters gives the readers nothing, and they return None.
"""

from __future__ import annotations

from collections import defaultdict

PREFIX = "hlod."


def self_us(host_ops, window_us) -> dict:
    """Self microseconds of each `hlod.*` span name, summed over the spans
    that lie inside the window."""
    w0, w1 = window_us
    spans = sorted((h for h in host_ops
                    if h[0].startswith(PREFIX) and w0 <= h[1] and h[2] <= w1),
                   key=lambda h: (h[1], -h[2]))
    out = defaultdict(float)
    stack = []                  # [name, end, self] of the open spans
    for name, a, b in spans:
        while stack and stack[-1][1] <= a:
            done = stack.pop()
            out[done[0]] += done[2]
        if stack:
            stack[-1][2] -= min(b, stack[-1][1]) - a
        stack.append([name, b, b - a])
    for name, _, own in stack:
        out[name] += own
    return dict(out)


def self_ms(r, names):
    """Host milliseconds a unit spends in the spans `names`, each less its
    nested spans; None when the trace holds none of them."""
    own = self_us(r.trace.host_ops, r.trace.window_us)
    found = [own[n] for n in names if n in own]
    if not found or r.trace.units <= 0:
        return None
    return sum(found) / 1e3 / r.trace.units


def counter_pct(num: str, den: str):
    """100 x counter `num` over counter `den` of the program's process-wide
    counters; None without the counters, or with `den` at 0."""
    try:
        from hlod_gaussians_torch.utils.metrics import counters
    except ImportError:
        return None
    d = counters.get(den, 0)
    return 100.0 * counters.get(num, 0) / d if d else None
