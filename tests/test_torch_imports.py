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
    assert len(files) >= 20
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}"
           for p in files for line, mod in _imports(p) if _forbidden(mod)]
    assert not bad, bad


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
