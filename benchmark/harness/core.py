"""Runs one cell once: set-up, the measured window, the check of what the
window produced, and the result line's fields. Everything that belongs to
one cell is found by name:

    BENCHMARK.json                      the cells, metrics and bounds
    benchmark/configs/<config>.json     a configuration (its sizes)
    benchmark/traffic/<traffic>.json    a traffic mix; its "driver" names
    benchmark/drivers/<driver>.py       the entry point it drives
    benchmark/metrics/<metric>.py       a per-layer metric's reader

A driver module defines `Session(cfg, traffic, seed, device, log)`, whose
construction is the set-up (inputs from the seed, the program's objects,
the first checked units, a warm-up over every camera of the cycle), with
`cycle` (units a cycle), optionally `reference_s` (seconds of set-up
spent in the reference, which `setup_s` leaves out), `profile_cycles`
(cycles a traced run profiles), `unit()` (one step or frame, returning
{"dispatch", "lat", "failed"} once its result is on the host),
`end_to_end(records, seconds)` (the cell's quantities by name),
`before_trace()`, `release()` (frees the program's state), `check(mode)`
([(name, value, limit)]) and `work()` (what a unit needs, for the
readers).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

from benchmark.harness import trace as tr_mod
from benchmark.harness.readings import Readings

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "hlod_gaussians_tpu")
GIB = float(1 << 30)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_bench(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_parts(bench: dict, name: str, root: Path = ROOT):
    """(workload entry, configuration dict, traffic dict) of a cell."""
    wl = {w["name"]: w for w in bench["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    traffic = root / "benchmark" / "traffic" / f"{wl['traffic']}.json"
    return wl, load_json(root / conf["file"]), load_json(traffic)


def metrics_of(bench: dict, cell: str, trace: bool):
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported
                             else [])]


def reader(name: str, root: Path = ROOT):
    """The module benchmark/metrics/<name>.py."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def window(unit, seconds: float):
    """Units until `seconds` have passed: (records, host seconds from the
    first unit's start to the last one's end), each record with its `end`
    in seconds into the window."""
    records = []
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        records.append(unit())
        t = time.perf_counter()
        records[-1]["end"] = t - t0
        if t >= end:
            return records, t - t0


def per_second(records):
    """Units completed in each whole second of a window."""
    counts = [0] * (int(records[-1]["end"]) + 1)
    for r in records:
        counts[int(r["end"])] += 1
    return counts


def host_sample():
    """(this process's CPU seconds, the host clock)."""
    t = os.times()
    return t.user + t.system, time.perf_counter()


def cpu_share(a, b):
    """This process's CPU seconds over wall seconds between two samples: a
    run whose host thread was descheduled reads well under 1."""
    return (b[0] - a[0]) / max(b[1] - a[1], 1e-9)


def last_cpu():
    """The processor this process last ran on (Linux), else None."""
    try:
        with open("/proc/self/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, IndexError, ValueError):
        return None


def _finite_le(value, limit):
    return value is not None and math.isfinite(value) and value <= limit


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start=None, mode="program", overrides=None,
             root: Path = ROOT) -> dict:
    """One run of `cell`; returns the result line as a dict. `mode`
    "control" judges the reference in the next precision down in the
    program's place; `overrides` ({"config": {...}, "traffic": {...}})
    shrink a cell for a CPU test."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    bench = load_bench(root)
    wl, cfg, traffic = cell_parts(bench, cell, root)
    for part, new in (overrides or {}).items():
        {"config": cfg, "traffic": traffic}[part].update(new)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    sess = driver.Session(cfg, traffic, seed, device, log)
    sync()
    setup_s = time.perf_counter() - t_start - getattr(sess, "reference_s",
                                                      0.0)
    log(f"set-up {setup_s:.3f} s")
    peak = 0
    if cuda:
        peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    traced = None
    host0 = host_sample()
    if trace:
        records, seconds_run = window(sess.unit, seconds / 2)
        sess.before_trace()
        traced = tr_mod.profile_units(sess.unit,
                                      sess.cycle * sess.profile_cycles, sync)
        all_records = records + traced.records
    else:
        records, seconds_run = window(sess.unit, seconds)
        all_records = records
    busy = cpu_share(host0, host_sample())
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    peak = max(peak, window_peak)
    failed = sum(bool(r["failed"]) for r in all_records)
    log(f"{sess.unit_name}s by second of the window: "
        f"{per_second(records)}; load average {os.getloadavg()}; on cpu "
        f"{last_cpu()} of {sorted(os.sched_getaffinity(0))}; process CPU "
        f"over wall {busy:.4f}")
    log(f"window: {len(records)} untraced {sess.unit_name}s in "
        f"{seconds_run:.3f} s" + (f", {traced.units} traced in "
                                  f"{traced.host_s:.3f} s" if traced else "")
        + f"; {failed} failed")

    e2e_values = sess.end_to_end(records, seconds_run)
    e2e_values.update(setup_s=setup_s, device_peak_gib=window_peak / GIB)
    sess.release()
    t_check = time.perf_counter()
    checks = sess.check(mode)
    log(f"check: {time.perf_counter() - t_check:.3f} s")
    correct = all(_finite_le(v, lim) for _, v, lim in checks)

    metrics = {}
    breakdown = None
    wanted = metrics_of(bench, cell, trace)
    if trace:
        readings = Readings(traced, records, seconds_run, sess.work())
        for m in wanted:
            value = reader(m["name"], root).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": tr_mod.device_ops_top(traced),
                     "idle_gaps": tr_mod.idle_gaps_top(traced)}
    else:
        # `<quantity>.<suffix>` reports the driver's <quantity>: the suffix
        # splits one quantity between cells whose runs spread differently,
        # each part with its own bound
        for m in wanted:
            quantity = m["name"].split(".")[0]
            metrics[m["name"]] = {"value": e2e_values[quantity],
                                  "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=tr_mod.busy_s(traced),
                   window_s=tr_mod.window_s(traced))
    out = {"correct": bool(correct), "attempted": len(all_records),
           "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        log(f"check {n} {v!r} limit {lim!r}")
    return out
