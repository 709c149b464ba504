"""The readers of the program's own tracing (benchmark/harness/spans.py):
the self-time arithmetic on a hand-made trace of nested spans, silence on
a program without spans or counters, and a tiny traced run of each cell
that reports every span and counter metric the cell lists."""

import sys
import types

import pytest

from conftest import TINY

from benchmark.harness import core, spans
from benchmark.harness.readings import Readings
from benchmark.harness.trace import Trace


def _trace(host_ops, units=2, window=(0.0, 1000.0)):
    return Trace(device_ops=[], host_ops=host_ops, window_us=window,
                 units=units, records=[], host_s=0.0)


# two units; in each an entry span holds a layer span, which holds another
# layer span; aten ops and the benchmark's own span are not program spans,
# and the span after the window is left out
HOST = [
    ("bench.unit", 0.0, 400.0),
    ("hlod.lod_stream", 10.0, 390.0),
    ("hlod.cut", 20.0, 120.0),
    ("aten::sort", 30.0, 110.0),
    ("hlod.interp", 130.0, 330.0),
    ("hlod.project", 200.0, 260.0),
    ("bench.unit", 500.0, 900.0),
    ("hlod.lod_stream", 500.0, 800.0),
    ("hlod.interp", 500.0, 700.0),
    ("hlod.project", 500.0, 540.0),
    ("hlod.bin", 540.0, 600.0),
    ("hlod.cut", 1100.0, 1200.0),
]


def test_self_time_subtracts_the_nested_spans():
    own = spans.self_us(HOST, (0.0, 1000.0))
    assert own == {
        "hlod.lod_stream": (380 - 100 - 200) + (300 - 200),
        "hlod.cut": 100.0,
        "hlod.interp": (200 - 60) + (200 - 40 - 60),
        "hlod.project": 60.0 + 40.0,
        "hlod.bin": 60.0,
    }


def test_self_ms_is_per_unit_over_the_names():
    r = Readings(_trace(HOST), [], 0.0, None)
    assert spans.self_ms(r, ("hlod.cut", "hlod.compact", "hlod.interp")) \
        == pytest.approx((100 + 140 + 100) / 1e3 / 2)
    assert spans.self_ms(r, ("hlod.blend",)) is None


def test_readers_are_silent_without_program_spans(monkeypatch):
    """A program without the spans and counters (an older one) gives no
    reading, and no reader raises."""
    r = Readings(_trace([("bench.unit", 0.0, 400.0),
                         ("aten::add", 10.0, 20.0)]), [], 0.0, None)
    bench = core.load_bench()
    mod = types.ModuleType("hlod_gaussians_torch.utils.metrics")
    monkeypatch.setitem(sys.modules, "hlod_gaussians_torch.utils.metrics",
                        mod)
    names = [m["name"] for m in bench["per_layer"]
             if m["source"] in ("program_span", "program_counter")]
    assert len(names) == 13
    for name in names:
        assert core.reader(name).read(r) is None, name


def test_counter_share(monkeypatch):
    import collections
    mod = types.ModuleType("hlod_gaussians_torch.utils.metrics")
    mod.counters = collections.Counter()
    monkeypatch.setitem(sys.modules, "hlod_gaussians_torch.utils.metrics",
                        mod)
    assert spans.counter_pct("lod.nodes_drawn",
                             "lod.rows_interpolated") is None
    mod.counters.update({"lod.nodes_drawn": 4179253,
                         "lod.rows_interpolated": 8388607})
    assert spans.counter_pct("lod.nodes_drawn", "lod.rows_interpolated") \
        == pytest.approx(49.8206, abs=1e-4)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_traced_run_reports_the_program_metrics(cell):
    out = core.run_cell(cell, 2 ** 31 + 99, 0.4, True, device="cpu",
                        overrides=TINY[cell])
    want = {m["name"] for m in core.metrics_of(core.load_bench(), cell, True)
            if m["source"] in ("program_span", "program_counter")}
    assert want and want <= set(out["metrics"])
    for name in want:
        value = out["metrics"][name]["value"]
        assert value > 0, name
        if out["metrics"][name]["unit"] == "%":
            assert value <= 100, name
