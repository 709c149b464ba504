"""Metrics logging + lightweight section timers (port of
hlod_gaussians_tpu/utils/metrics.py).

Replaces the reference's TensorBoard SummaryWriter + manual clock() pairs
(train_post.py:46-56,650-673): a JSONL metrics stream, wall-clock section
timers and device-memory snapshots.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


class MetricsLogger:
    """Append-only JSONL metrics (one dict per event)."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def log(self, **kv):
        kv.setdefault("ts", round(time.time(), 3))
        line = json.dumps(kv, default=float)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class SectionTimers:
    """Named wall-clock accumulators (the reference's global clock() pairs,
    train_post.py:46-56). Host clock: time device work only around code
    that ends in a synchronize."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: round(v, 4) for k, v in self.totals.items()}


def device_memory_stats() -> Dict[str, int]:
    """Bytes allocated on each CUDA device (the reference's peak-VRAM
    tracking, train_post.py:495-496); empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_stats(i).get(
        "allocated_bytes.all.current", 0))
        for i in range(torch.cuda.device_count())}
