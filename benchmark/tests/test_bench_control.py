"""The comparison that decides `correct` fails what it must, at a size a
test run holds: the control (the reference computed in bfloat16, the next
precision below the configurations' float32, in the program's place), and
each fault the cell can have, planted under the timed path of an
otherwise whole run (the look for a card skipped)."""

import pytest

from conftest import TINY

from benchmark.harness import core, faults

SEED = 2 ** 31 + 99


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    out = core.run_cell(cell, SEED, 0.3, False, device="cpu", mode="control",
                        overrides=TINY[cell])
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("train-flat3M-1080p", "state_unchanged"),
    ("train-flat3M-1080p", "half_batch"),
    ("serve-lod8M-1080p-tau0", "stale_frame"),
    ("serve-lod8M-1080p-tau0", "half_cut"),
    ("serve-lod8M-1080p-tau15", "stale_frame"),
    ("serve-lod8M-1080p-tau15", "half_cut"),
])
def test_fault_is_not_correct(cell, fault):
    with faults.planted(fault):
        out = core.run_cell(cell, SEED, 0.3, False, device="cpu",
                            overrides=TINY[cell])
    assert out["correct"] is False, out["checks"]
