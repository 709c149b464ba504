"""A tiny run of each cell on the CPU, through everything but the look
for a card, prints a result line of the contract's shape; the command
itself prints nothing and fails without a card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, TINY

from benchmark.harness import core

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_run_prints_the_contract_line(cell, trace):
    out = core.run_cell(cell, 2 ** 31 + 12345, 0.4, bool(trace),
                        device="cpu", overrides=TINY[cell])
    line = json.loads(json.dumps(out))
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    bench = core.load_bench()
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
        # no device operations on the CPU: the device readers stay silent
        assert "device_idle.train" not in line["metrics"]
    else:
        want = {m["name"] for m in core.metrics_of(bench, cell, False)}
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_same_seed_same_inputs():
    import torch
    from benchmark.harness import data
    cfg = dict(core.cell_parts(core.load_bench(), "train-flat3M-1080p")[1],
               n_gaussians=64)
    a = data.flat_scene(cfg, 2 ** 31 + 7, torch.device("cpu"))
    b = data.flat_scene(cfg, 2 ** 31 + 7, torch.device("cpu"))
    c = data.flat_scene(cfg, 2 ** 31 + 8, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["xyz"], c["xyz"])


def test_command_without_a_card_prints_nothing():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "train-flat3M-1080p", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                          "HOME": str(ROOT / "benchmark" / ".cache")})
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_tiny_run_on_the_card(card):
    out = core.run_cell("train-flat3M-1080p", 5, 0.4, False, device=card,
                        overrides=TINY["train-flat3M-1080p"])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
