"""BENCHMARK.json against the contract's shape, and every file it names."""

import json
import re
from pathlib import Path

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == TOP
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(_line(w) for w in MAN["command"])


def test_names_units_and_lines():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and _line(w["why"])
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "portbench" / "e2e" / f"{m['name']}.py").is_file()
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    all_names = (names + [w["name"] for w in MAN["workloads"]]
                 + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]])
    assert len(all_names) == len(set(all_names))


def test_every_cell_reports_enough():
    for w in MAN["workloads"]:
        cell = run.load_cell(w["name"], ROOT)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        # a per-layer metric's end-to-end metric is reported where it is
        assert all(m["moves"] in e2e for m in cell.per_layer)


def test_file_names_use_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
