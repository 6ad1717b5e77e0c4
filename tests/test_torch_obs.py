"""repro_torch.obs: the port's spans.

Off, a solve under the profiler shows none of them and records nothing;
on, a dense solve and a top-k request open the tree of stages the
benchmark's readers expect, with the call's shapes as their work, and
give the same answers bit for bit.  Every span name the sources open is
in ``obs.SPANS``, and every name there is opened somewhere."""

import ast
import collections
import pathlib

import pytest
import torch

import repro_torch.solver as S
import repro_torch.spectral as SP
from repro_torch import obs

torch.set_num_threads(2)

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
# the dense benchmark cell's configuration: two Zolo iterations at r = 4
CFG = S.SvdConfig(method="zolo_cuda", kappa=9.06e3,
                  l0_policy="estimate_at_plan", r=4)
N = 64


@pytest.fixture(autouse=True)
def _spans_off():
    obs.disable()
    obs.take()
    yield
    obs.disable()
    obs.take()


def _matrix(m, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(m, n, generator=g, dtype=torch.float64).float()


def _dense():
    return S.plan(CFG, (N, N), torch.float32, device="cpu"), _matrix(N, N)


def _topk():
    cfg = SP.TopKConfig(k=8, strategy="sketch", tol=1e-5, kappa=9.06e3,
                        svd=CFG)
    return (SP.plan_topk(cfg, (256, 192), torch.float32, device="cpu"),
            _matrix(256, 192, 1))


def _tree(records):
    """{(name, parent name): count}."""
    return collections.Counter(
        (name, None if parent is None else records[parent][0])
        for name, parent, _ in records)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


@pytest.mark.parametrize("case", ["dense", "topk"])
def test_off_emits_and_records_nothing(case):
    plan, a = _dense() if case == "dense" else _topk()
    call = plan.svd if case == "dense" else plan.topk
    call(a)
    _, names = _profiled(lambda: call(a))
    assert not names & set(obs.SPANS)
    assert obs.take() == []


def test_dense_solve_tree_and_work():
    plan, a = _dense()
    assert len(plan.schedule) == 2
    obs.enable()
    _, names = _profiled(lambda: plan.svd(a))
    obs.disable()
    rec = obs.take()
    assert names >= set(obs.SPANS[:8])
    assert _tree(rec) == {
        ("svd.solve", None): 1,
        ("svd.prescale", "svd.solve"): 1,
        ("svd.polar", "svd.solve"): 1,
        # the CholeskyQR2 iteration: two factorizations, four solves
        # (Q1 and Q2 by each factor); the Cholesky one: one, two
        ("linalg.cholesky", "svd.polar"): 3,
        ("linalg.trsm", "svd.polar"): 6,
        ("svd.form_h", "svd.polar"): 1,
        ("svd.eigh", "svd.solve"): 1,
        ("svd.lift", "svd.solve"): 1,
    }
    work = {name: [w for n, _, w in rec if n == name]
            for name in ("linalg.cholesky", "linalg.trsm", "svd.eigh")}
    # n = 64 is below K5's CHOLESKY_MIN_N: cholesky_ex's route
    assert work["linalg.cholesky"] == [{"batch": 4, "n": N,
                                        "route": "cusolver"}] * 3
    assert work["linalg.trsm"] == [{"batch": 4, "n": N, "k": N}] * 6
    assert work["svd.eigh"] == [{"n": N}]
    assert all(w == {} for n, _, w in rec if n.startswith("svd.")
               and n != "svd.eigh")


def test_verified_solve_is_one_solve_span():
    plan, a = _dense()
    obs.enable()
    plan.svd_verified(a)
    rec = obs.take()
    assert [n for n, p, _ in rec if p is None] == ["svd.solve"]


def test_topk_request_tree():
    plan, a = _topk()
    obs.enable()
    plan.topk(a)
    rec = obs.take()
    tree = _tree(rec)
    assert tree[("topk.request", None)] == 1
    assert tree[("topk.sketch", "topk.request")] == 1
    assert tree[("topk.panel", "topk.request")] == 1
    for stage in ("svd.prescale", "svd.polar", "svd.eigh", "svd.lift"):
        assert tree[(stage, "topk.panel")] == 1
    assert not any(n == "svd.solve" for n, _, _ in rec)
    # a shifted CholeskyQR2 (two factorizations, two solves) after the
    # first product and after each of the 2q power-iteration products
    q = plan.q_iters
    assert tree[("linalg.cholesky", "topk.sketch")] == 2 * (2 * q + 1)
    assert tree[("linalg.trsm", "topk.sketch")] == 2 * (2 * q + 1)
    (sketch,) = [w for n, _, w in rec if n == "topk.sketch"]
    assert sketch == {"m": 256, "n": 192, "l": plan.l,
                      "products": 2 * q + 2}
    (eigh,) = [w for n, _, w in rec if n == "svd.eigh"]
    assert eigh == {"n": plan.l}  # the wide panel, solved as its transpose


def test_solve_triangular_work():
    from repro_torch.core import linalg

    l = 2 * torch.eye(5).expand(2, 1, 5, 5)
    b = torch.ones(3, 5, 7)
    obs.enable()
    x = linalg.solve_triangular(l, b, upper=False)  # broadcast batch
    y = linalg.solve_triangular(l[0, 0], b, upper=True)
    rec = obs.take()
    assert torch.equal(x, torch.full((2, 3, 5, 7), 0.5))
    assert torch.equal(y, torch.full((3, 5, 7), 0.5))
    assert rec == [("linalg.trsm", None, {"batch": 6, "n": 5, "k": 7}),
                   ("linalg.trsm", None, {"batch": 3, "n": 5, "k": 7})]


@pytest.mark.parametrize("case", ["dense", "topk"])
def test_answers_identical_on_and_off(case):
    plan, a = _dense() if case == "dense" else _topk()
    call = plan.svd if case == "dense" else plan.topk
    off = call(a)
    obs.enable()
    on = call(a)
    obs.disable()
    assert obs.take()
    assert all(torch.equal(x, y) for x, y in zip(off, on))


def _opened_names():
    names = set()
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "span"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "obs"):
                assert isinstance(node.args[0], ast.Constant), path
                names.add(node.args[0].value)
    return names


def test_span_names_match_the_sources():
    assert _opened_names() == set(obs.SPANS)
    assert len(obs.SPANS) == len(set(obs.SPANS)) == 11
