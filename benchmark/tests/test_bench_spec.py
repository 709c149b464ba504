"""BENCHMARK.json against the benchmark's contract: every file it names is
found by name, names and units use only the allowed characters, each cell
reports setup_s, another end-to-end metric and a per-layer metric, and
every per-layer metric moves an end-to-end metric its cells report."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_paths_and_command():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert (ROOT / word).is_file()


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and _line(conf["source"])
    assert _line(conf["why"])
    assert conf["file"].startswith("benchmark/configs/")
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert len(conf["reduced"]) <= 16
    assert all(NAME.match(k) for k in conf["reduced"])
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key])
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads(
        (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    assert (ROOT / "benchmark" / "drivers"
            / f"{traffic['driver']}.py").is_file()
    assert set(traffic["limits"]) and all(
        v > 0 for v in traffic["limits"].values())


def test_names_unique_and_pairs_once():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert _line(m["layer"])
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    reporting = set(e2e[m["moves"]].get("workloads", cells))
    assert set(m.get("workloads", reporting)) <= reporting
    reader = ROOT / "benchmark" / "metrics" / f"{m['name']}.py"
    assert "def read(" in reader.read_text()


def test_every_cell_reports_enough():
    from benchmark.harness import core
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in core.metrics_of(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.metrics_of(BENCH, w["name"], True)


def test_files_under_paths_named_from_name_characters():
    for p in (ROOT / "benchmark").rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or "/.cache" in rel:
            continue
        assert PATH.match(rel), rel
