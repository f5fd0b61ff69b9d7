"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts_use_the_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer"):
                if key in entry:
                    assert TEXT.match(entry[key]), entry[key]
            if group == "configs":
                assert TEXT.match(entry["source"]) and len(entry["reduced"]) <= 16
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in MAN[group]]
        assert len(group_names) == len(set(group_names))
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])


def test_metrics_keys_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_an_end_to_end_metric_and_a_layer_metric():
    for w in MAN["workloads"]:
        cell = w["name"]
        e2e = [m["name"] for m in MAN["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in MAN["per_layer"] if cell in m.get("workloads", [cell])]
        assert layers
        for m in layers:
            assert m["moves"] in e2e


def test_files_are_found_by_name():
    for c in MAN["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    for w in MAN["workloads"]:
        cell = json.loads((ROOT / "benchmark" / "cells" / f"{w['traffic']}.json").read_text())
        assert cell["config"] == w["config"]
        assert (ROOT / "benchmark" / "drivers" / f"{cell['driver']}.py").is_file()
    for m in MAN["per_layer"]:
        assert (ROOT / "benchmark" / "layer_metrics" / f"{m['name']}.py").is_file()
    for path in (ROOT / "benchmark").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or rel.startswith("benchmark/_cache"):
            continue
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
