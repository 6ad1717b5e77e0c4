"""A run of each cell on the CPU at a small size, past the harness's look
for a card: sound, it comes out correct; with the timed path broken
underneath, once for each fault the cell can have, it does not.  And
the control, the reference in the precision below the configuration's,
fails one of the cell's numbers."""

from __future__ import annotations

import importlib.util
import pathlib
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

import control  # noqa: E402

_spec = importlib.util.spec_from_file_location("bench_run_main",
                                               BENCH / "run.py")
RUN = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(RUN)
SEED = 2 ** 31 + 99
CELLS = ("linverse-dense", "linverse-topk128")


def _run(cell: str, seconds: float = 0.5) -> dict:
    _, config, traffic = control.cell_files(cell, small=True)
    return RUN.run_cell(cell, SEED, seconds, False, device="cpu",
                        config=config, traffic=traffic, t0=0.0)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"


# --- faults planted in the program -------------------------------------------


def _dense_polar_returns_its_input(mp):
    from repro_torch.core import zolo

    mp.setattr(zolo, "run_schedule", lambda x, *a, **k: x)


def _answer_altered(plan_cls, method):
    def plant(mp):
        real = getattr(plan_cls(), method)

        def altered(self, a):
            u, s, vh = real(self, a)
            s = s.clone()
            s[0] *= 1.001
            return u, s, vh

        mp.setattr(plan_cls(), method, altered)
    return plant


def _svd_plan():
    from repro_torch.solver.planner import SvdPlan

    return SvdPlan


def _topk_plan():
    from repro_torch.spectral.topk import TopKPlan

    return TopKPlan


def _topk_stale(mp):
    """Every request answered with the first one's triplets."""
    cls = _topk_plan()
    real, first = cls.topk, []

    def stale(self, a):
        if not first:
            first.append(real(self, a))
        return first[0]

    mp.setattr(cls, "topk", stale)


def _topk_half_left_out(mp):
    cls = _topk_plan()
    real = cls.topk

    def half(self, a):
        u, s, vh = real(self, a)
        k = s.shape[0] // 2
        u, s, vh = u.clone(), s.clone(), vh.clone()
        u[:, k:], s[k:], vh[k:] = 0, 0, 0
        return u, s, vh

    mp.setattr(cls, "topk", half)


def _topk_cached_by_pointer(mp):
    """A result cache keyed on the input's storage: a repeated ring member
    gets the answer of its earlier request."""
    cls = _topk_plan()
    real, cache = cls.topk, {}

    def cached(self, a):
        key = a.data_ptr()
        if key not in cache:
            cache[key] = real(self, a)
        return cache[key]

    mp.setattr(cls, "topk", cached)


def _topk_vectors_swapped(mp):
    """Right values, with the first and last right vectors swapped."""
    cls = _topk_plan()
    real = cls.topk

    def swapped(self, a):
        u, s, vh = real(self, a)
        vh = vh.clone()
        vh[[0, -1]] = vh[[-1, 0]]
        return u, s, vh

    mp.setattr(cls, "topk", swapped)


FAULTS = [
    ("linverse-dense", "state_unchanged", _dense_polar_returns_its_input),
    ("linverse-dense", "answer_altered", _answer_altered(_svd_plan, "svd")),
    ("linverse-topk128", "state_unchanged", _topk_stale),
    ("linverse-topk128", "cached_by_pointer", _topk_cached_by_pointer),
    ("linverse-topk128", "half_left_out", _topk_half_left_out),
    ("linverse-topk128", "answer_altered",
     _answer_altered(_topk_plan, "topk")),
    ("linverse-topk128", "vectors_swapped", _topk_vectors_swapped),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_is_not_correct(cell, fault, plant, monkeypatch):
    plant(monkeypatch)
    res = _run(cell)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_number(cell):
    _, config, traffic = control.cell_files(cell, small=True)
    held = config["limits"][traffic["request"]]
    rec = control.readings(cell, SEED, "cpu", small=True)
    assert any(rec["control"][k] > lim for k, lim in held.items()), \
        rec["control"]
    assert torch.get_default_dtype() == torch.float32
