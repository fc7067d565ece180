"""Every cell and metric of BENCHMARK.json resolves to its files, and the
file keeps the benchmark contract's shapes."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(BENCH) == KEYS
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    from portbench import run

    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    c, cfg, traffic, limits = run.cell_files(BENCH, cell["name"])
    assert cfg["name"] == cell["config"] and traffic["name"] == cell["traffic"]
    assert {"gap", "largest_move", "replay"} <= set(limits)
    reported = run.cell_metrics(BENCH, cell["name"], False)
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert run.cell_metrics(BENCH, cell["name"], True)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    path = ROOT / config["file"]
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    from portbench import run

    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(run.reader(metric["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
