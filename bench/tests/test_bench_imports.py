"""Nothing the benchmark runs loads JAX, the JAX package ``repro``, the
JAX package's benchmarks or the chip scripts; the references load
nothing of the program."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke",
             "chip_ab"}


def _imported_tops(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_the_jax_side():
    for path in BENCH.rglob("*.py"):
        assert not (_imported_tops(path) & FORBIDDEN), path


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in _imported_tops(path), path


_PROBE = r"""
import importlib.util, json, pathlib, sys
bench = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(bench))
sys.path.insert(0, str(bench.parent / "src"))
spec = importlib.util.spec_from_file_location("bench_run", bench / "run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
from harness import device, manifest
refs = {}
for kind in ("reference", "entries", "end_to_end", "metrics"):
    for p in sorted((bench / kind).glob("*.py")):
        manifest.load_module(kind, p.stem)
        if kind == "reference":
            refs[p.stem] = sorted({m.split(".")[0] for m in sys.modules})
for kind in ("configs", "traffic"):
    for p in sorted((bench / kind).glob("*.json")):
        manifest.load_json(kind, p.stem)
import repro_torch, repro_torch.solver, repro_torch.spectral
import repro_torch.kernels.ops
print(json.dumps({"foreign": device.foreign_modules(),
                  "program_loaded": "repro_torch" in sys.modules,
                  "refs": refs}))
"""


def test_nothing_loaded_by_whole_top_level_name():
    """In a fresh interpreter: the harness, every configuration, mix,
    entry, metric and reference, then the program's packages; the guard
    finds nothing, and does not take ``repro_torch`` for ``repro``.  The
    references were loaded before the program: none of them loaded it."""
    out = subprocess.run([sys.executable, "-c", _PROBE, str(BENCH)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["foreign"] == [] and rec["program_loaded"]
    assert rec["refs"]
    for tops in rec["refs"].values():
        assert "repro_torch" not in tops
