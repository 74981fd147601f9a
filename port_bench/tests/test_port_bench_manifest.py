"""BENCHMARK.json keeps to the benchmark's contract: its keys, names, units
and lengths, and every configuration, traffic mix, limits file and
per-layer reader it names exists as a file under port_bench/."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(MANIFEST) == KEYS
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(one_line(w) for w in MANIFEST["command"])
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            yield group, entry


@pytest.mark.parametrize("group, entry", list(names()),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_units_and_keys(group, entry):
    assert NAME.match(entry["name"])
    if group == "configs":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert one_line(entry["source"]) and one_line(entry["why"])
        assert (REPO / entry["file"]).is_file()
        assert entry["file"].startswith("port_bench/")
        assert len(entry["reduced"]) <= 16
        cfg = json.loads((REPO / entry["file"]).read_text())
        assert cfg["precision"] == {"dtype": "float32", "tf32": False}
        for block, folder in (("map", "maps"), ("views", "views")):
            kind = cfg[block]["kind"]
            assert (REPO / "port_bench" / folder / f"{kind}.py").is_file()
    elif group == "workloads":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4) and one_line(entry["why"])
        traffic = json.loads((REPO / "port_bench/traffic" /
                              f"{entry['traffic']}.json").read_text())
        assert (REPO / "port_bench/kinds" / f"{traffic['kind']}.py"
                ).is_file()
        assert (REPO / "port_bench/limits" / f"{entry['name']}.json"
                ).is_file()
    else:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        extra = {"bound"} if group == "end_to_end" else {"layer", "moves"}
        assert set(entry) - {"workloads"} == METRIC_KEYS | extra
        if group == "end_to_end":
            assert entry["source"] in ("host_clock", "device_trace")
            assert 0.01 <= entry["bound"] <= 0.25
        else:
            assert one_line(entry["layer"])
            assert (REPO / "port_bench/metrics" / f"{entry['name']}.py"
                    ).is_file()


def test_unique_names_and_references():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names_ = [e["name"] for e in MANIFEST[group]]
        assert len(names_) == len(set(names_))
    metric_names = [e["name"] for e in MANIFEST["end_to_end"]
                    + MANIFEST["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    configs = {c["name"] for c in MANIFEST["configs"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert configs == {w["config"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", moved)) <= moved


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_reports_enough(cell):
    """setup_s, another end-to-end metric and a per-layer metric."""
    e2e = [m for m in MANIFEST["end_to_end"]
           if cell in m.get("workloads", [cell])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(cell in m.get("workloads", [cell])
               for m in MANIFEST["per_layer"])


def test_limits_name_compared_numbers():
    from port_bench import byname

    for w in MANIFEST["workloads"]:
        traffic = json.loads((REPO / "port_bench/traffic" /
                              f"{w['traffic']}.json").read_text())
        kind = byname.module(REPO, "kinds", traffic["kind"])
        limits = json.loads((REPO / "port_bench/limits" /
                             f"{w['name']}.json").read_text())
        assert limits and set(limits) <= set(kind.NUMBERS)
        assert all(v > 0 for v in limits.values())
