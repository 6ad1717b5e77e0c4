"""The port stands alone: no module of src/repro_torch imports jax or
the reference package, and its paper matrices do not depend on Python's
per-process string-hash salt."""

import ast
import hashlib
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_jax_or_reference_imports():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 70
    names = {p.relative_to(PKG).as_posix() for p in files}
    assert {"kernels/matmul.py", "kernels/flash_attention.py",
            "core/elliptic.py", "core/structured_qr.py", "core/qdwh.py",
            "core/newton.py", "core/eig.py", "core/linalg.py",
            "resilience/errors.py", "resilience/health.py",
            "resilience/escalate.py", "resilience/faultinject.py",
            "spectral/sketch.py", "spectral/dnc.py", "spectral/topk.py",
            "optim/compression.py", "dist/__init__.py", "dist/grouped.py",
            "dist/grouped_ops.py", "analysis/__init__.py",
            "analysis/plan_audit.py", "serve/__init__.py",
            "serve/bucketing.py", "serve/scheduler.py",
            "serve/svd_service.py", "launch/__init__.py",
            "launch/svd_serve.py", "tree.py", "models/__init__.py",
            "models/config.py", "models/layers.py", "models/attention.py",
            "models/transformer.py", "models/model.py",
            "configs/registry.py", "configs/qwen3_8b.py",
            "configs/olmo_1b.py", "configs/yi_34b.py",
            "configs/h2o_danube3_4b.py", "configs/musicgen_large.py",
            "configs/pixtral_12b.py", "configs/mamba2_130m.py",
            "configs/recurrentgemma_2b.py", "configs/dbrx_132b.py",
            "configs/moonshot_v1_16b_a3b.py", "optim/schedule.py",
            "optim/muon.py", "data/__init__.py", "data/pipeline.py",
            "train/__init__.py", "train/step.py", "train/loop.py",
            "checkpoint/__init__.py", "checkpoint/manager.py",
            "launch/train.py", "models/moe.py", "models/ssm.py",
            "models/rglru.py", "serve/engine.py", "launch/serve.py",
            "dist/sharding.py", "launch/mesh.py", "launch/dryrun.py",
            "analysis/__main__.py", "analysis/lint/__init__.py",
            "analysis/lint/engine.py", "analysis/lint/rules.py"} <= names
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}"
           for p in files for line, mod in _imports(p) if _forbidden(mod)]
    assert not bad, bad


def test_examples_import_no_jax_or_reference():
    files = sorted((ROOT / "examples").glob("torch_*.py"))
    assert {p.name for p in files} == {
        "torch_quickstart.py", "torch_distributed_svd.py",
        "torch_svd_serve.py", "torch_svd_topk.py", "torch_train_lm.py",
        "torch_serve_lm.py"}
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}"
           for p in files for line, mod in _imports(p) if _forbidden(mod)]
    assert not bad, bad


def test_the_lint_path_loads_no_torch():
    code = ("import sys\n"
            "import repro_torch.analysis, repro_torch.analysis.lint\n"
            "from repro_torch.analysis.__main__ import main\n"
            "assert main(['--list-rules']) == 0\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro', 'numpy')))")
    assert _run(code, 0) == "[]"


def _run(code, hashseed):
    env = dict(os.environ, PYTHONHASHSEED=str(hashseed),
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.solver, repro_torch.interop\n"
            "import repro_torch.configs.svd_paper, repro_torch.kernels.ops\n"
            "import repro_torch.kernels.matmul\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.core.elliptic, repro_torch.core.zolo_cuda\n"
            "import repro_torch.core.structured_qr, repro_torch.core.newton\n"
            "from repro_torch import polar_svd, polar_decompose\n"
            "import repro_torch.resilience, repro_torch.spectral\n"
            "import repro_torch.optim, repro_torch.dist\n"
            "import repro_torch.analysis, repro_torch.serve\n"
            "import repro_torch.launch.svd_serve\n"
            "import repro_torch.models, repro_torch.configs\n"
            "import repro_torch.train, repro_torch.data.pipeline\n"
            "import repro_torch.checkpoint.manager, repro_torch.tree\n"
            "import repro_torch.launch.train, repro_torch.launch.serve\n"
            "import repro_torch.models.moe, repro_torch.models.ssm\n"
            "import repro_torch.models.rglru, repro_torch.serve.engine\n"
            "import repro_torch.dist.sharding, repro_torch.launch.mesh\n"
            "import repro_torch.launch.dryrun\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    assert _run(code, 0) == "[]"


def test_synthesize_is_stable_across_hash_seeds():
    code = ("import hashlib, torch\n"
            "from repro_torch.configs.svd_paper import synthesize\n"
            "a, s = synthesize('linverse', n=48, device='cpu')\n"
            "print(hashlib.sha256(a.numpy().tobytes()).hexdigest())")
    digests = {_run(code, seed) for seed in (1, 2)}
    assert len(digests) == 1
    from repro_torch.configs.svd_paper import synthesize

    a, s = synthesize("linverse", n=48, device="cpu")
    assert hashlib.sha256(a.numpy().tobytes()).hexdigest() in digests
    b, _ = synthesize("fv1", n=48, device="cpu")
    assert not torch.equal(a, b)
    # exact spectrum returned beside the matrix: kappa_2 matches the paper
    sv = torch.linalg.svdvals(a)
    torch.testing.assert_close(sv, s, rtol=1e-10, atol=0)
    assert float(s[0] / s[-1]) == pytest.approx(9.06e3, rel=1e-12)
