"""Each cell for a few seconds on the card, as the benchmark runs it.

Marked ``gpu``; each test looks for a card itself and skips without one.
On the card: ``python -m pytest -q -m gpu bench/tests/test_bench_gpu.py``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import manifest as M  # noqa: E402

CELLS = [w["name"] for w in M.load_manifest()["workloads"]]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    _card()
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", str(2 ** 31 + 17), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=360, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"]


def test_without_the_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and ``bench/``, the run
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
