"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by name: a new configuration and mix make a new cell with no
existing file edited."""

from __future__ import annotations

import hashlib
import json
import re

from pathlib import Path

import numpy as np
import pytest

from benchmark import scenes
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


@pytest.mark.parametrize("cell", ["cam24-exact.blind", "ref19-exact.blind"])
def test_the_blind_cells_keep_their_kwargs_and_reference(cell):
    c = Cell(cell, ROOT)
    assert c.set_up() == {} and c.kwargs() == c.config["kwargs"]
    assert c.kwargs("cuda") == dict(c.config["kwargs"], verbose=False, device="cuda")
    assert Path(c.reference.__file__) == ROOT / "benchmark/reference/plain.py"
    assert c.limits == c.config["limits"] and not (ROOT / f"benchmark/cells/{cell}.json").exists()


def test_the_stored_psf_mix_writes_the_true_psf():
    from ics_tpu_torch.models.checkpoint import load_checkpoint

    c = Cell("cam24-exact.stored-psf", ROOT)
    with pytest.raises(RuntimeError, match="set-up"):
        c.kwargs()
    added = c.set_up()
    assert c.set_up() is added and set(added) == {"psf_path"}
    assert c.kwargs() == dict(c.config["kwargs"], psf_path=added["psf_path"])
    ckpt = load_checkpoint(added["psf_path"])
    taps = scenes.gauss_taps(9).numpy()
    assert ckpt.psf.dtype == np.float32 and ckpt.psf.shape == (9, 9, 3)
    assert ckpt.blur_width == 9 and ckpt.phase == "blind" and ckpt.iterations_done == 0
    for ch in range(3):
        assert np.array_equal(ckpt.psf[:, :, ch], np.outer(taps, taps).astype(np.float32))
    assert np.array_equal(c.reference.stored_psf(added["psf_path"]), ckpt.psf)


def test_new_cell_adds_files_only(tmp_path):
    """A configuration that names its own reference, a mix with a set-up of
    its own and a cell's own limits come in as new files and entries only."""
    root = tiny_tree(tmp_path)
    here = root / "benchmark"
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in here.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    mix = json.loads((here / "traffic/blind.json").read_text())
    (here / "traffic/two.json").write_text(json.dumps(dict(mix, name="two", pool=2)))
    (here / "traffic/two.py").write_text(
        "def prepare(cell, directory):\n"
        "    (directory / 'made').write_text(cell.name)\n"
        "    return {'made_in': str(directory)}\n")
    cfg = json.loads((here / "configs/tiny.json").read_text())
    (here / "configs/tiny2.json").write_text(json.dumps(dict(cfg, name="tiny2",
                                                             reference="plain2")))
    (here / "reference/plain2.py").write_text(
        (here / "reference/plain.py").read_text() + "\nOWN = True\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny2",
                                 file="benchmark/configs/tiny2.json"))
    bench["workloads"].append(dict(name="tiny2.two", config="tiny2", traffic="two", chips=1,
                                   why="t"))
    (here / "metrics/extra_ms.py").write_text("def read(record):\n    return 1.0\n")
    bench["per_layer"].append(dict(name="extra_ms", unit="ms", better="lower",
                                   source="program_span", layer="pipeline", moves="frame_s",
                                   workloads=["tiny2.two"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (here / "cells/tiny2.two.json").write_text(json.dumps(dict(limits=dict(u_gap=None,
                                                                          codes_gap=5))))
    cell = Cell("tiny2.two", root)
    assert cell.limits == dict({k: v for k, v in cfg["limits"].items() if k != "u_gap"},
                               codes_gap=5)
    assert cell.mix["pool"] == 2 and cell.config["name"] == "tiny2"
    assert "extra_ms" in [m["name"] for m, _ in cell.per_layer]
    assert cell.reference.OWN and Path(cell.reference.__file__) == here / "reference/plain2.py"
    made = Path(cell.set_up()["made_in"])
    assert (made / "made").read_text() == "tiny2.two"
    assert cell.kwargs("cpu") == dict(cfg["kwargs"], made_in=str(made), verbose=False,
                                      device="cpu")
    for p, digest in before.items():
        assert hashlib.sha256(p.read_bytes()).hexdigest() == digest, p
