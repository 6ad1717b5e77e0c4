"""The six ``examples/torch_*.py`` on the CPU at toy size.

Each example is the port's counterpart of an ``examples/*.py`` of the
reference: it runs on ``--device cpu`` and returns what it printed; the
quickstart's singular values agree with the reference's plan on the same
matrix in f64; the training example writes a checkpoint and resumes from
it; and every example, left at its default ``--device`` (the card),
raises where there is none."""

import importlib.util
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
NAMES = ("quickstart", "distributed_svd", "svd_serve", "svd_topk",
         "train_lm", "serve_lm")
F64_TOL = 1e-12


def _example(name):
    """The module of ``examples/torch_<name>.py``."""
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _restore_reference_caches():
    """Leave the reference's plan caches (solver and top-k) as this
    module found them: ``tests/test_analysis.py::
    test_audit_all_plans_green_after_suite`` audits every plan cached in
    its worker process."""
    from repro.solver import planner as jplanner
    from repro.spectral import topk as jtopk

    before = dict(jplanner._PLANS), dict(jtopk._TOPK_PLANS)
    yield
    for cache, saved in zip((jplanner._PLANS, jtopk._TOPK_PLANS), before):
        cache.clear()
        cache.update(saved)


def test_quickstart_matches_the_reference(capsys):
    import jax.numpy as jnp

    import repro.solver as JS

    n = 64
    out = _example("quickstart").main(["--device", "cpu", "--n", str(n)])
    printed = capsys.readouterr().out
    assert f"matrix: {n}x{n}" in printed and "QDWH-PD" in printed
    a = _example("quickstart").test_matrix(n, 1e8)
    jcfg = JS.SvdConfig(method="auto", kappa=1e8,
                        l0_policy="estimate_at_plan")
    jp = JS.plan(jcfg, a.shape, jnp.float64)
    assert jp.method == out["method"]
    _, s_ref, _ = jp.svd(jnp.asarray(a))
    s_ref = np.asarray(s_ref)
    assert np.abs(out["s"] - s_ref).max() <= F64_TOL * s_ref[0]
    assert out["residual"] < 1e-12 and out["orth_u"] < 1e-13
    assert out["sigma_err"] < 1e-12
    assert out["zolo_orth"] < 1e-13 and out["zolo_rec"] < 1e-12
    assert out["qdwh_iterations"] > out["zolo_iterations"]


def test_quickstart_script_exits_zero():
    out = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "torch_quickstart.py"),
         "--device", "cpu", "--n", "32"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "QDWH-PD: iterations=" in out.stdout


def test_distributed_svd_on_eight_gloo_ranks():
    """Eight rank processes, as the reference's eight host devices; the
    script's exit code and rank 0's lines."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "torch_distributed_svd.py"),
         "--device", "cpu", "--m", "64", "--n", "32"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout
    assert "ranks: 8 (gloo, cpu)" in lines
    for r, sep in ((2, 4), (4, 2)):
        assert f"mesh = {{'zolo': {r}, 'sep': {sep}}}" in lines
    assert "method=zolo_grouped mode=grouped" in lines
    assert "runtime-kappa plan: method=zolo_grouped_dynamic" in lines
    orths = [float(w.split("=")[1]) for w in lines.split()
             if w.startswith("orth=")]
    assert len(orths) == 4 and max(orths) < 1e-13
    recs = [float(w.split("=")[1]) for w in lines.split()
            if w.startswith("rec=")]
    assert len(recs) == 2 and max(recs) < 1e-12
    assert lines.count("retraces=0") == 2


def test_svd_serve_stream():
    out = _example("svd_serve").main(["--device", "cpu"])
    assert out["solves"] == 24 and out["retraces"] == 0
    assert out["hit_rate"] == 1.0
    assert out["worst_rec"]["float64"] < 1e-12
    assert out["worst_rec"]["float32"] < 1e-4


def test_svd_topk_views():
    out = _example("svd_topk").main(["--device", "cpu", "--m", "256",
                                     "--n", "64", "--k", "8"])
    assert out["strategy"] == "sketch"
    assert out["near_full_strategy"] == "dense"
    assert out["rel_err"] <= 1e-10
    assert out["adaptive"]["escalated"] is False
    assert out["solves"] == 4 and out["retraces"] == 0


@pytest.fixture
def _restore_signals():
    """The training loop installs SIGINT/SIGTERM handlers; put back the
    test process's own."""
    saved = {sig: signal.getsignal(sig)
             for sig in (signal.SIGINT, signal.SIGTERM)}
    yield
    for sig, handler in saved.items():
        signal.signal(sig, handler)


def test_train_lm_checkpoints_and_resumes(tmp_path, _restore_signals):
    mod = _example("train_lm")
    args = ["--device", "cpu", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path / "ckpt")]
    first = mod.main(args + ["--steps", "2"])
    assert first["start_step"] == 0 and first["step"] == 2
    assert first["latest_ckpt"] == 2
    again = mod.main(args + ["--steps", "3"])
    assert again["start_step"] == 2 and again["step"] == 3
    assert again["latest_ckpt"] == 3


def test_serve_lm_every_cache_regime():
    out = _example("serve_lm").main(["--device", "cpu", "--batch", "2",
                                     "--prompt", "16", "--gen", "4"])
    assert set(out) == {"qwen3-8b", "recurrentgemma-2b", "mamba2-130m",
                        "moonshot-v1-16b-a3b"}
    for rec in out.values():
        assert rec["shape"] == (2, 4) and rec["in_vocab"]


@pytest.mark.parametrize("name", NAMES)
def test_default_device_is_the_card(name, tmp_path):
    """No ``--device``: the card, which raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = ["--ckpt-dir", str(tmp_path)] if name == "train_lm" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(argv)
