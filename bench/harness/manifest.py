"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's
file is ``bench/configs/<config>.json`` and its plain reference
``bench/reference/<config>.py``; the mix is ``bench/traffic/<mix>.json``
and names the entry ``bench/entries/<entry>.py`` that drives the
system; an end-to-end metric is read by ``bench/end_to_end/<name>.py``
and a per-layer metric by ``bench/metrics/<name>.py``.  A metric named
``<base>.<part>`` with no file of its own is read by ``<base>.py``: one
formula serves each cell's copy of a quantity (``solve_s.dense`` and
``solve_s.topk`` by ``solve_s.py``).  Nothing here keeps a table of
names: a new cell, mix or metric is a new entry in ``BENCHMARK.json``,
and a new file where no reader has its formula.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import pathlib
import re
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
_SAFE = re.compile(r"[^A-Za-z0-9_]")


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; known: "
                   f"{sorted(e['name'] for e in entries)}")


def data_file(kind: str, name: str) -> pathlib.Path:
    return BENCH / kind / f"{name}.json"


def load_json(kind: str, name: str) -> dict:
    return json.loads(data_file(kind, name).read_text())


def module_file(kind: str, name: str) -> pathlib.Path:
    """``bench/<kind>/<name>.py``, or for a name ``<base>.<part>`` with
    no such file, ``bench/<kind>/<base>.py``."""
    path = BENCH / kind / f"{name}.py"
    if path.is_file() or "." not in name:
        return path
    return BENCH / kind / f"{name.split('.', 1)[0]}.py"


def load_module(kind: str, name: str):
    """The module that :func:`module_file` names, loaded by its path
    (names may hold dots and dashes), once per process."""
    path = module_file(kind, name)
    key = f"bench_{kind}_{_SAFE.sub('_', path.stem)}"
    mod = sys.modules.get(key)
    if mod is not None:
        return mod
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def end_to_end_for(manifest: dict, cell: str) -> list:
    """The end-to-end metrics a cell reports: those without a
    ``workloads`` list and those whose list names the cell."""
    return [m for m in manifest["end_to_end"]
            if cell in m.get("workloads", (cell,))]


def per_layer_for(manifest: dict, cell: str) -> list:
    """The per-layer metrics a traced run of the cell reports: those
    whose ``workloads`` names it, or without the key those that move one
    of the cell's end-to-end metrics."""
    moves = {m["name"] for m in end_to_end_for(manifest, cell)}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", ()) or
            ("workloads" not in m and m["moves"] in moves)]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit generator seed for one purpose (``tag``) of a run's
    ``--seed``: any whole number maps to a valid ``manual_seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)
