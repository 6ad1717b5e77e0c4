"""repro_torch.analysis.lint: the port's invariant linter against the
reference's (``repro.analysis.lint``).

The engine (suppression, the baseline lifecycle, stale entries,
fingerprints, the CLI's exit codes and JSON keys) runs the reference
tests' own fixture sources; the three idiom-free rules must report what
the reference reports on the same files; each torch-form rule flags its
historical bug and passes its clean twin; the shipped port tree is
clean.  Also the source repairs the port's first lint run asked for."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis.lint import engine as ref_engine
from repro_torch.analysis import all_rules, run_lint, write_baseline
from repro_torch.analysis.lint import engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TREE = os.path.join(ROOT, "src", "repro_torch")
IDIOM_FREE = ("bare-assert", "keyerror-dispatch", "plan-key-hygiene")
# each torch-form rule and the reference rule it stands for
TORCH_FORM = {"collective-axis": "collective-axis",
              "accum-dtype": "accum-dtype",
              "host-sync": "retrace-hazard",
              "kernel-accum-envelope": "kernel-accum-envelope"}


def lint(tmp_path, source, rule, baseline=None, name="fixture.py"):
    """Lint one dedented fixture snippet with a single rule."""
    f = tmp_path / name
    f.write_text(textwrap.dedent(source))
    return run_lint([str(f)], rules=[rule], baseline=baseline)


def _run_cli(args, *, flags=()):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    return subprocess.run(
        [sys.executable, *flags, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)


# --- the catalog -----------------------------------------------------------


def test_rule_registry_complete():
    assert set(all_rules()) == set(IDIOM_FREE) | set(TORCH_FORM)
    ref = set(ref_engine.all_rules())
    # every reference rule has exactly one counterpart
    assert set(IDIOM_FREE) | set(TORCH_FORM.values()) == ref
    for rule in all_rules().values():
        assert rule.doc  # every rule documents its bug class


def test_catalog_maps_every_rule_to_its_reference():
    readme = open(os.path.join(PORT_TREE, "analysis", "README.md")).read()
    for name in IDIOM_FREE:
        assert f"| `{name}` | `{name}` |" in readme
    for name, ref in TORCH_FORM.items():
        assert f"| `{name}` | `{ref}` |" in readme


def test_resolve_rules_names_the_known_rules():
    with pytest.raises(ValueError, match="known:.*bare-assert"):
        engine.resolve_rules(["bare-assert", "no-such-rule"])


# --- the idiom-free rules agree with the reference ---------------------------

AGREEMENT_SOURCE = '''
import dataclasses
from typing import Dict, List

TABLE = {"zolo": 1, "qdwh": 2}
OTHER = {"a": 0}


@dataclasses.dataclass
class SolveConfig:
    sizes: List[int]
    extra: Dict[str, int] = None


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    names: tuple = ()


def pick(name, other):
    assert name
    return TABLE[name] + OTHER[other]


def pick_guarded(name):
    if name not in TABLE:
        raise ValueError(name)
    return TABLE[name]


def pick_try(name):
    try:
        return TABLE[name]
    except KeyError:
        assert False, name
'''


def _tuples(findings):
    return sorted((f.rule, os.path.basename(f.path), f.line, f.col,
                   f.message) for f in findings)


@pytest.fixture(scope="module")
def idiom_free_runs(tmp_path_factory):
    """Both engines over the fixture and both trees, once for all three
    idiom-free rules; each case below reads its own rule's findings."""
    fix = tmp_path_factory.mktemp("agreement") / "fixture.py"
    fix.write_text(AGREEMENT_SOURCE)
    paths = [str(fix), os.path.join(ROOT, "src", "repro"), PORT_TREE]
    return (run_lint(paths, rules=list(IDIOM_FREE)),
            ref_engine.run_lint(paths, rules=list(IDIOM_FREE)))


@pytest.mark.parametrize("rule", IDIOM_FREE)
def test_idiom_free_rules_agree_with_reference(idiom_free_runs, rule):
    ours, theirs = idiom_free_runs
    mine = [f for f in ours.findings if f.rule == rule]
    ref = [f for f in theirs.findings if f.rule == rule]
    assert _tuples(mine) == _tuples(ref)
    assert mine  # the fixture does trip the rule
    assert ours.files == theirs.files


def test_plan_key_hygiene_flags_a_tensor_field(tmp_path):
    res = lint(tmp_path, """
        import dataclasses
        import torch
        @dataclasses.dataclass(frozen=True)
        class ShiftKey:
            shift: torch.Tensor
        """, "plan-key-hygiene")
    assert len(res.findings) == 1
    assert "Tensor-typed" in res.findings[0].message


# --- the reference's per-rule fixtures, on the same sources -----------------


def test_plan_key_hygiene_flags_mutable_config(tmp_path):
    res = lint(tmp_path, """
        import dataclasses
        from typing import List
        @dataclasses.dataclass
        class SolveConfig:
            sizes: List[int]
        """, "plan-key-hygiene")
    msgs = [f.message for f in res.findings]
    assert len(msgs) == 2
    assert any("frozen" in m for m in msgs)
    assert any("sizes" in m for m in msgs)


def test_plan_key_hygiene_accepts_frozen_tuple_config(tmp_path):
    res = lint(tmp_path, """
        import dataclasses
        from typing import Tuple
        @dataclasses.dataclass(frozen=True)
        class SolveConfig:
            sizes: Tuple[int, ...] = ()
        @dataclasses.dataclass
        class _ScratchConfig:  # private: not a cache key
            buf: list = None
        @dataclasses.dataclass
        class Runner:  # not *Config/*Policy/*Key-suffixed
            log: list = None
        """, "plan-key-hygiene")
    assert res.findings == []


def test_bare_assert_flagged(tmp_path):
    res = lint(tmp_path, """
        def f(x):
            assert x > 0
            return x
        """, "bare-assert")
    assert len(res.findings) == 1
    assert "-O" in res.findings[0].message


def test_keyerror_dispatch_flags_unguarded_table(tmp_path):
    bad = lint(tmp_path, """
        TABLE = {"zolo": 1, "qdwh": 2}
        def pick(name):
            return TABLE[name]
        """, "keyerror-dispatch")
    assert len(bad.findings) == 1
    assert "TABLE[name]" in bad.findings[0].message
    good = lint(tmp_path, """
        TABLE = {"zolo": 1, "qdwh": 2}
        def pick(name):
            if name not in TABLE:
                raise ValueError(f"unknown {name!r}; known: {sorted(TABLE)}")
            return TABLE[name]
        """, "keyerror-dispatch")
    assert good.findings == []


# --- collective-axis, torch form ---------------------------------------------


def test_collective_axis_flags_a_collective_without_group(tmp_path):
    """The double-reduction class: a Gram all-reduce that names no group
    reduces over WORLD."""
    res = lint(tmp_path, """
        import torch.distributed as dist
        def gram_local(x, group):
            g = x.mT @ x
            dist.all_reduce(g)  # the sep group forgotten
            return g
        def gather(out, q):
            dist.all_gather_into_tensor(out, q, group=None)
        """, "collective-axis")
    assert [f.line for f in res.findings] == [5, 8]
    assert "all_reduce() without an explicit group=" in \
        res.findings[0].message
    assert "WORLD" in res.findings[1].message


def test_collective_axis_accepts_named_groups(tmp_path):
    res = lint(tmp_path, """
        import torch
        import torch.distributed as dist
        from torch.distributed import all_reduce as ar
        def f(g, s, out, q, group, sep_group):
            dist.all_reduce(g, group=group)
            dist.all_reduce(s, dist.ReduceOp.SUM, sep_group)
            torch.distributed.all_gather_into_tensor(out, q, group)
            ar(g, group=group)
            dist.barrier()  # not a reduction over data
            return g
        """, "collective-axis")
    assert res.findings == []


def test_collective_axis_flags_an_undeclared_mesh_dim(tmp_path):
    res = lint(tmp_path, """
        MESH_AXES = ("data", "model")
        def solve_rows(mesh, x):
            return mesh.get_group("dta")  # typo for "data"
        """, "collective-axis")
    assert len(res.findings) == 1
    assert "'dta'" in res.findings[0].message
    assert "data" in res.findings[0].message  # names the known dims


def test_collective_axis_accepts_declared_mesh_dims(tmp_path):
    res = lint(tmp_path, """
        from torch.distributed.device_mesh import init_device_mesh
        def make():
            return init_device_mesh("cuda", (2, 2),
                                    mesh_dim_names=("data", "model"))
        def f(mesh, data_dim="data"):
            g = mesh.get_group("model")
            rows = mesh["data"].size()
            return g, rows, mesh.get_group(data_dim)
        """, "collective-axis")
    assert res.findings == []


def test_collective_axis_implicit_replication_needs_justification(tmp_path):
    bad = lint(tmp_path, """
        from torch.distributed.tensor.experimental import implicit_replication
        def step(fn, state):
            with implicit_replication():
                return fn(state)
        """, "collective-axis")
    assert len(bad.findings) == 1
    assert "implicit_replication" in bad.findings[0].message
    good = lint(tmp_path, """
        from torch.distributed.tensor.experimental import implicit_replication
        def step(fn, state):
            # implicit_replication: the step's plain constants are the
            # same on every rank
            with implicit_replication():
                return fn(state)
        """, "collective-axis")
    assert good.findings == []


# --- accum-dtype, torch form -------------------------------------------------


def test_accum_dtype_flags_unpinned_gram(tmp_path):
    """The bf16 Gram: a product in the operands' dtype feeding Cholesky."""
    res = lint(tmp_path, """
        import torch
        def gram_chol(x):
            g = x.mT @ x
            return torch.linalg.cholesky(g)
        def gram_qr(x):
            return torch.linalg.qr(torch.einsum("mk,mn->kn", x, x))
        def narrowed(x):
            xa = x.float()
            g = (xa.mT @ xa).to(x.dtype)  # pinned, then rounded back
            return torch.linalg.cholesky(g @ g)
        """, "accum-dtype")
    assert [f.line for f in res.findings] == [4, 7, 11]
    assert "@ result (via 'g') reaches" in res.findings[0].message
    assert "out_dtype" in res.findings[1].message


def test_accum_dtype_accepts_pinned_or_sinkless(tmp_path):
    res = lint(tmp_path, """
        import torch
        from repro_torch.kernels.ref import accum_dtype
        def cast_first(x):
            xa = x.float()
            return torch.linalg.cholesky(xa.mT @ xa)
        def out_dtype(x):
            g = torch.mm(x.mT, x, out_dtype=torch.float32)
            return torch.linalg.eigh(g)
        def port_idiom(x):
            acc = accum_dtype(x.dtype)
            xa = x.to(acc)
            g = (xa.mT @ xa).to(x.dtype)  # accumulated wide, then rounded
            return torch.linalg.cholesky(g)
        def closure(x):
            acc = torch.promote_types(x.dtype, torch.float32)
            def pass_(p):
                pa = p.to(acc)
                return torch.linalg.cholesky(pa.mT @ pa)
            return pass_(x)
        def plain_product(x):  # no factorization sink: not a Gram
            return torch.matmul(x, x.mT)
        """, "accum-dtype")
    assert res.findings == []


# --- host-sync (the torch form of retrace-hazard) ---------------------------


def test_host_sync_flags_the_blocking_upload_in_a_static_solve(tmp_path):
    """The bug behind 9-11 host syncs a static solve: the schedule
    uploaded by ``torch.tensor(..., device=)`` inside the static body."""
    res = lint(tmp_path, """
        import torch
        def run_schedule(x, c_odd):
            return x * c_odd[0]
        def zolo_pd_static(a, sched):
            dev = a.device
            c_odd = torch.tensor([it.c for it in sched], dtype=a.dtype,
                                 device=dev)
            return run_schedule(a, c_odd)
        """, "host-sync")
    assert len(res.findings) == 1
    assert res.findings[0].line == 7
    assert "blocking upload" in res.findings[0].message


def test_host_sync_flags_readbacks_in_decode_and_launchers(tmp_path):
    res = lint(tmp_path, """
        import torch
        from repro_torch.kernels import build as _build
        def _step(logits):
            return int(logits.argmax(-1).max().item())
        def decode_step(params, tokens: torch.Tensor, caches):
            if tokens:
                return _step(params["w"] @ tokens.float())
            return caches
        def combine_kernel_call(x, mhat):
            m = float(x.new_zeros(()) + mhat)
            return _build.library("combine").run(x.data_ptr(), m)
        """, "host-sync")
    msgs = sorted((f.line, f.message.split(" ")[0]) for f in res.findings)
    assert msgs == [(5, ".item()"), (7, "Python"), (11, "float()")]


def test_host_sync_accepts_staged_uploads_and_plan_time_code(tmp_path):
    res = lint(tmp_path, """
        import torch
        def zolo_pd_static(a, sched, l0=None):
            dev = a.device
            c = torch.tensor([it.c for it in sched]).to(dev,
                                                       non_blocking=True)
            if a.shape[0] < a.shape[1] or l0 is None:
                c = c.flip(0)
            info = torch.full((), len(sched), device=dev)
            return a * c[0] * float(l0 or 1.0), info
        def plan_schedule(a, sched):  # plan time: may read the host
            return float(torch.tensor(sched, device=a.device).sum().item())
        """, "host-sync")
    assert res.findings == []


# --- kernel-accum-envelope, torch form ---------------------------------------


def test_kernel_accum_envelope_flags_a_wrapper_without_envelope(tmp_path):
    """The port's four wrappers before the repair: an accumulator dtype
    but no envelope pointer beside it."""
    res = lint(tmp_path, """
        import torch
        from repro_torch.kernels import build as _build
        GRAM_ACCUM_DTYPE = torch.float32
        def gram_kernel_call(a):
            g = a.new_empty((a.shape[1],) * 2, dtype=GRAM_ACCUM_DTYPE)
            _build.library("gram").zolo_gram(a.data_ptr(), g.data_ptr())
            return g
        """, "kernel-accum-envelope")
    assert len(res.findings) == 1
    assert "ENVELOPE" in res.findings[0].message


def test_kernel_accum_envelope_flags_a_literal_f32_output(tmp_path):
    res = lint(tmp_path, """
        import torch
        from repro_torch.kernels import build as _build
        MATMUL_ACCUM_DTYPE = torch.float32
        MATMUL_KAPPA_ENVELOPE = "repro_torch.core.svd:CUDA_KAPPA_ENVELOPE"
        def matmul_kernel_call(a, b):
            c = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                            device=a.device)
            _build.library("matmul").zolo_matmul(c.data_ptr())
            return c
        """, "kernel-accum-envelope")
    assert len(res.findings) == 1
    assert "MATMUL" not in res.findings[0].message
    assert "*_ACCUM_DTYPE constant" in res.findings[0].message


def test_kernel_accum_envelope_accepts_declared_wrappers(tmp_path):
    res = lint(tmp_path, """
        import torch
        from repro_torch.kernels import build as _build
        GRAM_ACCUM_DTYPE = torch.float32
        GRAM_KAPPA_ENVELOPE = "repro_torch.core.svd:CUDA_KAPPA_ENVELOPE"
        def gram_kernel_call(a, c):
            g = a.new_empty((a.shape[1],) * 2, dtype=GRAM_ACCUM_DTYPE)
            shift = torch.as_tensor(c, dtype=torch.float32)  # not an output
            _build.library("gram").zolo_gram(a.data_ptr(), g.data_ptr(),
                                             shift.data_ptr())
            return g
        """, "kernel-accum-envelope")
    assert res.findings == []
    plain = lint(tmp_path, """
        import torch
        def gram_ref(a):  # no kernel launched: not a wrapper module
            return torch.empty((2, 2), dtype=torch.float32)
        """, "kernel-accum-envelope")
    assert plain.findings == []


# --- engine mechanics: suppression, baseline lifecycle, CLI ---------------


def test_inline_suppression(tmp_path):
    res = lint(tmp_path, """
        def f(x):
            # repro-lint: disable=bare-assert -- test-only helper
            assert x > 0
            return x
        """, "bare-assert")
    assert res.findings == [] and res.suppressed == 1


def test_baseline_lifecycle(tmp_path):
    src = "def f(x):\n    assert x > 0\n    return x\n"
    fix = tmp_path / "mod.py"
    fix.write_text(src)
    base = tmp_path / "baseline.json"

    first = run_lint([str(fix)], rules=["bare-assert"])
    assert len(first.findings) == 1
    write_baseline(str(base), first.findings)

    # baselined finding rides; nothing new fails
    second = run_lint([str(fix)], rules=["bare-assert"], baseline=str(base))
    assert second.ok and second.findings == [] and len(second.baselined) == 1

    # a NEW violation still fails against the same baseline
    fix.write_text(src + "\ndef g(y):\n    assert y\n    return y\n")
    third = run_lint([str(fix)], rules=["bare-assert"], baseline=str(base))
    assert not third.ok and len(third.findings) == 1

    # fixing the original flags its baseline entry as stale
    fix.write_text("def f(x):\n    return x\n")
    fourth = run_lint([str(fix)], rules=["bare-assert"], baseline=str(base))
    assert fourth.ok and fourth.stale_baseline == [
        first.findings[0].fingerprint()]


def test_fingerprint_is_line_independent(tmp_path):
    fix = tmp_path / "mod.py"
    fix.write_text("def f(x):\n    assert x\n    return x\n")
    a = run_lint([str(fix)], rules=["bare-assert"]).findings[0]
    fix.write_text("\n\n\ndef f(x):\n    assert x\n    return x\n")
    b = run_lint([str(fix)], rules=["bare-assert"]).findings[0]
    assert a.line != b.line and a.fingerprint() == b.fingerprint()
    # the same identity the reference's engine gives
    ref = ref_engine.run_lint([str(fix)], rules=["bare-assert"]).findings[0]
    assert b.fingerprint() == ref.fingerprint()


def test_source_loader_and_parse_errors(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    res = run_lint([str(bad)], rules=["bare-assert"])
    assert not res.ok and len(res.errors) == 1
    loaded = run_lint([str(bad)], rules=["bare-assert"],
                      source_loader=lambda p: "assert True\n")
    assert loaded.errors == [] and len(loaded.findings) == 1


def test_cli_json_and_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x):\n    assert x\n    return x\n")
    out = _run_cli([str(bad), "--format=json"])
    assert out.returncode == 1, out.stderr
    data = json.loads(out.stdout)
    assert set(data) == {"files", "findings", "baselined", "suppressed",
                         "stale_baseline", "errors", "ok"}
    assert data["ok"] is False and data["files"] == 1
    assert data["findings"][0]["rule"] == "bare-assert"

    good = tmp_path / "good.py"
    good.write_text("def f(x):\n    return x\n")
    out = _run_cli([str(good), "--format=json"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(out.stdout)["ok"] is True

    out = _run_cli([str(good), "--rules", "no-such-rule"])
    assert out.returncode == 2 and "known:" in out.stderr
    out = _run_cli([str(good), "--write-baseline"])
    assert out.returncode == 2


def test_cli_write_baseline_then_ride_it(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x):\n    assert x\n    return x\n")
    base = tmp_path / "base.json"
    out = _run_cli([str(bad), "--baseline", str(base), "--write-baseline"])
    assert out.returncode == 0 and json.loads(base.read_text())
    out = _run_cli([str(bad), "--baseline", str(base)])
    assert out.returncode == 0 and "1 baselined" in out.stdout


def test_cli_lists_seven_rules_on_a_bare_python():
    """``-S``: no site-packages, so no torch — the lint path must not
    need it."""
    out = _run_cli(["--list-rules"], flags=("-S",))
    assert out.returncode == 0, out.stderr
    names = [line.split(":", 1)[0] for line in out.stdout.splitlines()]
    assert names == sorted(all_rules()) and len(names) == 7


def test_port_tree_is_lint_clean():
    """The acceptance criterion: the shipped port carries zero findings
    against its committed baseline, which is empty."""
    base = os.path.join(ROOT, "lint-baseline-torch.json")
    assert json.loads(open(base).read()) == []
    res = run_lint([PORT_TREE], baseline=base)
    assert res.errors == []
    assert res.findings == [], "\n".join(f.render() for f in res.findings)
    assert res.stale_baseline == [] and res.suppressed == 0
    assert res.files > 80  # sanity: the walk actually saw the tree
    out = _run_cli(["--baseline", "lint-baseline-torch.json",
                    "--format=json"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(out.stdout)["files"] == res.files


# --- the repairs the port's first lint run asked for -----------------------


def test_unknown_block_kind_names_the_choices():
    torch = pytest.importorskip("torch")
    from repro_torch.models import transformer as T

    calls = [
        lambda: T.layer_init(torch.Generator(), "mlpmixer", None, None),
        lambda: T.layer_forward({}, "mlpmixer", None, None, None),
        lambda: T.layer_decode({}, "mlpmixer", None, None, None, None),
        lambda: T.init_layer_cache("mlpmixer", None, 1, 8, None),
        lambda: T.prefill_layer_cache("mlpmixer", None, 8, None, None),
    ]
    for call in calls:
        with pytest.raises(ValueError, match=r"'mlpmixer'.*'attn'.*'ssd'"):
            call()


def test_unknown_first_mode_names_the_choices():
    pytest.importorskip("torch")
    from repro_torch.analysis import executed_dynamic_psums

    with pytest.raises(ValueError, match=r"'cholqr3'.*'cholqr2'"):
        executed_dynamic_psums("cholqr3", 2)
    assert executed_dynamic_psums("chol", 2) == {"sep": 5, "zolo": 2}


@pytest.mark.parametrize("module,prefix", [
    ("gram", "GRAM"), ("grouped_combine", "COMBINE"),
    ("matmul", "MATMUL"), ("flash_attention", "FLASH")])
def test_kernel_wrappers_point_at_their_envelope(module, prefix):
    torch = pytest.importorskip("torch")
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    assert getattr(mod, f"{prefix}_ACCUM_DTYPE") == torch.float32
    pointer = getattr(mod, f"{prefix}_KAPPA_ENVELOPE")
    path, name = pointer.split(":")
    envelope = getattr(importlib.import_module(path), name)
    assert envelope[("float32", "float32")] > 0
