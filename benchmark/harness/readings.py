"""What a per-layer metric reader is given: `Readings`, built once a traced
run's window has closed. A reader (benchmark/metrics/<metric>.py) is a
module with `read(r: Readings) -> float | None`; None, when it finds
nothing to read, leaves the metric out of the result line.

* the trace (trace.Trace) of the profiled units;
* the untraced units of the same window: each record's `dispatch` (host
  seconds from the call into the entry point to its return, before the
  sync) and the window's host seconds;
* the work one unit needs, averaged over each camera of the cycle once
  (work.train_step / work.lod_frame).
"""

from __future__ import annotations

import statistics

from benchmark.harness import trace as tr_mod
from benchmark.harness import work as work_mod


class Readings:
    def __init__(self, trace, untraced, untraced_s, work):
        self.trace = trace
        self.untraced = untraced
        self.untraced_s = untraced_s
        self.work = work

    def idle_pct(self):
        """Share of the traced window with no device operation."""
        w = tr_mod.window_s(self.trace)
        if w <= 0 or not self.trace.device_ops:
            return None
        return 100.0 * (1.0 - tr_mod.busy_s(self.trace) / w)

    def launches_per_unit(self):
        """Device operations (kernels, copies, fills) a unit launches."""
        if not self.trace.device_ops:
            return None
        return len(self.trace.device_ops) / self.trace.units

    def dispatch_ms(self):
        """Median host milliseconds inside the entry point, untraced."""
        d = [r["dispatch"] for r in self.untraced if "dispatch" in r]
        return 1e3 * statistics.median(d) if d else None

    def kernel_s(self, names):
        """Device seconds a unit spends in kernels whose name holds one of
        `names`."""
        t = sum(b - a for n, a, b in self.trace.device_ops
                if any(k in n for k in names))
        return t / 1e6 / self.trace.units

    def roofline_pct(self, names, key):
        """The kernels' share of the least time the card could take for
        the work `key` ("b1", "b2") a unit needs."""
        if not self.work or key not in self.work:
            return None
        t = self.kernel_s(names)
        if t <= 0:
            return None
        ops, n_bytes = self.work[key]
        return 100.0 * work_mod.bound_s(ops, n_bytes) / t

    def mfu_pct(self):
        """The unit's counted operations over its untraced host time, as a
        share of the f32 peak."""
        if not self.work or not self.untraced or self.untraced_s <= 0:
            return None
        per_unit = self.untraced_s / len(self.untraced)
        return 100.0 * self.work["total_ops"] / per_unit / work_mod.PEAK_F32_S
