"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by name: a new configuration and mix make a new cell with no
existing file edited."""

from __future__ import annotations

import hashlib
import json
import re

import pytest

from benchmark.run import Cell
from benchmark.tests.conftest import ROOT, tiny_tree

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and len(BENCH["command"]) <= 32
    assert all(LINE(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and LINE(c["source"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and LINE(w["why"])
        assert w["chips"] == 1 and w["name"] == f"{w['config']}.{w['traffic']}"
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and LINE(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_pieces_found_by_name(cell):
    c = Cell(cell, ROOT)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert c.mix["pool"] == len(c.mix["scene_seeds"])
    assert {"frames", "among_first"} <= set(c.config["check"])
    assert all(callable(reader.read) for _, reader in c.end_to_end + c.per_layer)
    assert "setup_s" in [m["name"] for m, _ in c.end_to_end]
    assert {"k1", "k2"} <= set(c.kernels)
    for k in c.kernels.values():
        assert isinstance(k.NAME, str) and len(k.CALL) == 2 and callable(k.work)


def test_new_cell_adds_files_only(tmp_path):
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (ROOT / "benchmark").rglob("*") if p.is_file() and "__pycache__" not in
              p.parts}
    root = tiny_tree(tmp_path)
    mix = json.loads((root / "benchmark/traffic/blind.json").read_text())
    (root / "benchmark/traffic/two.json").write_text(json.dumps(dict(mix, name="two", pool=2)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="tiny.two", config="tiny", traffic="two", chips=1,
                                   why="t"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark/metrics/extra_ms.py").write_text("def read(record):\n    return 1.0\n")
    bench["per_layer"].append(dict(name="extra_ms", unit="ms", better="lower",
                                   source="program_span", layer="pipeline", moves="frame_s",
                                   workloads=["tiny.two"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell("tiny.two", root)
    assert cell.mix["pool"] == 2 and cell.config["name"] == "tiny"
    assert "extra_ms" in [m["name"] for m, _ in cell.per_layer]
    for p, digest in before.items():
        copy = root / p.relative_to(ROOT)
        if copy.exists():
            assert hashlib.sha256(copy.read_bytes()).hexdigest() == digest, p
