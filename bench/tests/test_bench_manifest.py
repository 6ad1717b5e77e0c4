"""BENCHMARK.json and the files it names: every name resolves to a file
of its own, and the manifest keeps the benchmark contract's shapes."""

from __future__ import annotations

import json
import math
import pathlib
import re
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import manifest as M  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = M.load_manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"]
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert (M.ROOT / MAN["command"][1]).is_file()


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = M.ROOT / cfg["file"]
    assert path == M.data_file("configs", cfg["name"]) and path.is_file()
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"]
    assert M.module_file("reference", cfg["name"]).is_file()
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])
    assert all(NAME.match(k) for k in cfg["reduced"])
    # every key cut from the source is recorded with its published value
    assert sorted(cfg["reduced"]) == sorted(data.get("published", {}))
    assert sorted(cfg["reduced"]) == sorted(data.get("cuts", {}))
    for key in cfg["reduced"]:
        assert not key.endswith(("_dim", "_rank", "_size"))
        assert key != "num_experts_per_tok"


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert cell["chips"] in (1, 4)
    assert 0 < len(cell["why"]) <= 200 and "\n" not in cell["why"]
    traffic = M.load_json("traffic", cell["traffic"])
    assert M.module_file("entries", traffic["entry"]).is_file()
    e2e = M.end_to_end_for(MAN, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    for m in e2e:
        assert M.module_file("end_to_end", m["name"]).is_file()
    layer = M.per_layer_for(MAN, cell["name"])
    assert layer
    for m in layer:
        assert M.module_file("metrics", m["name"]).is_file()
        assert m["moves"] in names


def test_pairs_once():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for w in m.get("workloads", ()):
            assert M.by_name(MAN["workloads"], w, "workload")
            assert m["moves"] in {x["name"] for x in M.end_to_end_for(MAN, w)}
    # one layer name a layer
    assert len({m["layer"] for m in MAN["per_layer"]}) == len(
        {m["layer"].lower() for m in MAN["per_layer"]})


def test_run_seconds_fit_a_full_check():
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell to compile
    and 1200 s spare fit into 43,200 s with the full 24 cells."""
    s = MAN["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


def test_four_chip_cells():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, math.floor(0.25 * len(MAN["workloads"])))


def test_file_size():
    assert (M.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_a_metric_is_read_by_its_own_file_or_its_base():
    """``<base>.<part>`` without a file of its own is read by
    ``<base>.py``; a file of the whole name wins."""
    assert M.module_file("end_to_end", "solve_s.topk").name == "solve_s.py"
    assert M.module_file("metrics", "k1_roofline.dense").name == \
        "k1_roofline.py"
    assert M.module_file("metrics", "mfu.svd").name == "mfu.svd.py"
    assert not M.module_file("metrics", "mfu.other").is_file()
    a = M.load_module("metrics", "device_idle_share.dense")
    assert M.load_module("metrics", "device_idle_share.topk") is a


def test_every_file_is_read_by_some_entry():
    """No reader, entry, mix or configuration lies unused."""
    readers = {M.module_file(kind, m["name"])
               for kind, key in (("end_to_end", "end_to_end"),
                                 ("metrics", "per_layer"))
               for m in MAN[key]}
    for kind in ("end_to_end", "metrics"):
        assert set((M.BENCH / kind).glob("*.py")) == {
            r for r in readers if r.parent.name == kind}
    mixes = {w["traffic"] for w in MAN["workloads"]}
    assert {p.stem for p in (M.BENCH / "traffic").glob("*.json")} == mixes
    entries = {M.load_json("traffic", t)["entry"] for t in mixes}
    assert {p.stem for p in (M.BENCH / "entries").glob("*.py")} == entries
    configs = {c["name"] for c in MAN["configs"]}
    assert {p.stem for p in (M.BENCH / "configs").glob("*.json")} == configs
    assert {p.stem for p in (M.BENCH / "reference").glob("*.py")} == configs
