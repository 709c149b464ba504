"""The post-optimization cell at a tiny size on the CPU: the program
against the plain reference (benchmark/harness/reference_post.py) on a
seeded 1,024-leaf tree at 64x48 with 16x16 tiles, the cell's run and its
result line, the control and the faults, and a program without the entry
point failing at once.

Its tiny sizes are here: the SPT roots of a 2,047-node tree own at most a
few hundred nodes, so `min_spt_size` drops from 256 to 16; and its leaves
lie far apart, so their parents are large, and the target granularity
rises from 0.00228 to 0.05 for the windows to select interior nodes."""

import json

import pytest
import torch

from benchmark.harness import core, faults, faults_post, reference_post

CELL = "post-orbit4M-1080p"
SEED = 2 ** 31 + 4321
CPU = torch.device("cpu")


def _tiny():
    _, _, traffic = core.cell_parts(core.load_bench(), CELL)
    return {"config": dict(n_leaves=1024, capacity=2048, width=64,
                           height=48, tile=[16, 16], max_dup=1 << 15),
            "traffic": dict(views=4, post=dict(
                traffic["post"], min_spt_size=16,
                spt_target_granularity=0.05))}


TINY = _tiny()


@pytest.fixture(scope="module")
def session():
    from benchmark.drivers import train_post
    _, cfg, traffic = core.cell_parts(core.load_bench(), CELL)
    cfg.update(TINY["config"])
    traffic.update(TINY["traffic"])
    return train_post.Session(cfg, traffic, SEED, CPU, lambda msg: None)


def test_working_sets_equal_row_for_row(session):
    """The program's SPT cut of every view equals the reference's working
    set, row for row: both compute the same float32 quantities on the
    CPU, and the tiny tree has SPTs, plain leaves and culled roots."""
    from hlod_gaussians_torch.hierarchy import spt
    post = session.traffic["post"]
    assert session.forest.n_spts > 0
    clean = session._working_sets(session._start())
    for cam, ref_ws in zip(session.cams, clean):
        cut = spt.spt_cut_budgeted(
            session.forest, session.cfg["capacity"], cam.campos,
            cam.full_proj, post["max_gaussian_budget"],
            grow=post["distance_multiplier_until_budget"],
            use_frustum=post["use_frustum_culling"])
        assert 0 < int(ref_ws.sum()) < session.cfg["n_leaves"]
        assert torch.equal(cut.gaussian_mask, ref_ws)


def test_working_set_reads_no_depth_column(session):
    """The reference orders the nodes through the parent column: a depth
    column that puts the first node of some levels one level up (as a
    device's floor(log2) one ulp low would) leaves its working set as it
    was."""
    post = session.traffic["post"]
    start = session._start()
    want = list(session._working_sets(start))
    depth = start["nodes"][:, 0]
    for k in range(1, 11, 2):
        depth[(1 << k) - 1] = k - 1
    for a, b in zip(want, session._working_sets(start)):
        assert torch.equal(a, b)
    assert session.forest.n_spts > 0 and post["min_spt_size"] == 16


def test_steps_match_the_reference(session):
    """The three checked steps against the reference's from the same
    start. Losses within 1e-5 relative: float32 sums in another order
    (the reference's tile chunks against the blend's plain version, SSIM's
    convolutions). First gradients within 1e-4: the same sums, through the
    backward. Parameter change within 1e-3: Adam's first steps move a row
    by about its learning rate whatever its gradient's size, so a
    gradient near zero whose rounding flips its sign moves the row the
    other way."""
    checks = {n: v for n, v, _ in session.check()}
    assert checks["ws_gap"] == 0.0
    assert checks["loss_gap"] <= 1e-5
    assert checks["grad_gap"] <= 1e-4
    assert checks["change_gap"] <= 1e-3


def test_reference_imports_nothing_of_the_program():
    import ast
    tree = ast.parse(open(reference_post.__file__).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.startswith("hlod_gaussians")]


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_the_contract_line(trace):
    out = core.run_cell(CELL, SEED, 0.4, bool(trace), device="cpu",
                        overrides=TINY)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    bench = core.load_bench()
    if trace:
        # the span, counter and host-clock readers read on the CPU too; the
        # device readers find no device operation and stay silent
        want = {"dispatch_ms.train", "step_mfu.train",
                "project_host_ms.train", "blend_host_ms.train",
                "loss_host_ms.train", "backward_host_ms.train",
                "adam_host_ms.train", "spt_host_ms.post", "ws_useful.post"}
        assert set(line["metrics"]) == want == {
            m["name"] for m in core.metrics_of(bench, CELL, True)
            if m["source"] != "device_trace"}
        assert 0 < line["metrics"]["ws_useful.post"]["value"] < 100
    else:
        want = {m["name"] for m in core.metrics_of(bench, CELL, False)}
        assert set(line["metrics"]) == {"train_mpix_s", "device_peak_gib",
                                        "setup_s"} == want
    assert set(line["checks"]) == {"ws_gap", "loss_gap", "grad_gap",
                                   "change_gap"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_control_is_not_correct():
    out = core.run_cell(CELL, SEED, 0.3, False, device="cpu",
                        mode="control", overrides=TINY)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", sorted(faults_post.FAULTS))
def test_fault_is_not_correct(fault):
    faults_post.register()
    with faults.planted(fault):
        out = core.run_cell(CELL, SEED, 0.3, False, device="cpu",
                            overrides=TINY)
    assert out["correct"] is False, out["checks"]


def test_a_program_without_the_entry_point_fails_at_once(monkeypatch):
    """An older program, without the entry point: the session fails on
    its first line, before it makes the tree."""
    from benchmark.harness import data
    from hlod_gaussians_torch.pipeline import full_train
    monkeypatch.delattr(full_train, "post_iteration")
    made = []
    monkeypatch.setattr(data, "build_tree", lambda *a: made.append(a))
    with pytest.raises(ImportError):
        core.run_cell(CELL, SEED, 0.3, False, device="cpu", overrides=TINY)
    assert not made
