"""The bf16 compute plan (``SvdConfig(compute_dtype="bfloat16")``) of
repro_torch.solver against repro.solver's.

A compute plan factorizes in the compute dtype and returns its results in
the plan dtype.  Both packages solve the same f32 numpy input (the
reference's own shape, ``tests/test_bf16_envelope.py``: (192, 96),
kappa = 1e3, seed 11) in bf16 iterates on the CPU; the reference's plan
state (schedule, power-iteration start vector drawn in bf16) is carried
into the port.  bf16 rounds in other places in the two frameworks, so the
two solves are compared as two bf16 solves: s and U diag(s) Vh within
eps(bf16) = 2^-7 of s_max of each other (measured ~5e-4), each within the
reference's own bf16 criteria (top half of s within 5e-2 relative of the
exact spectrum; orthogonality within ``default_orth_tol(bf16)`` =
8 eps(bf16), and within 1e-2 as the reference's test also asks).

The dynamic default (``qr_mode`` unset) takes the structured Householder
first iteration on both sides: the f32-or-better run-time bound sits below
10 sqrt(eps(bf16)).  The default method: ``auto`` picks ``qdwh_static``
for a kappa hint, as the reference's pricing does; the reference's QDWH
then raises on bf16 (``jnp.linalg.qr`` refuses it), the port's factorizes
in f32 and is held to the same bf16 criteria against the exact spectrum.

Then the plan gating, as the reference's tests hold it: the kernel
backends are capped by the compute dtype's envelope entry, an f64
computation is refused on them, and ``auto`` never picks them beyond it.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import make_matrix  # noqa: E402
import repro.solver as JS  # noqa: E402
import repro_torch.solver as S  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.core import svd as tsvd  # noqa: E402
from repro_torch.core import zolo as tzolo  # noqa: E402
from repro_torch.solver import planner  # noqa: E402

N, KAPPA, SEED = 96, 1.0e3, 11
BF16_EPS = 2.0 ** -7
PAIR_TOL = BF16_EPS       # port against reference, relative to s_max
S_RTOL = 5e-2             # top half of s against the exact spectrum
ORTH_TOL = 8 * BF16_EPS   # default_orth_tol(bf16)
ORTH_EARLY = 1e-2         # the reference test's early-degradation catch

CONFIGS = {
    "zolo_static": dict(method="zolo_static", kappa=KAPPA,
                        l0_policy="estimate_at_plan"),
    # the f32-or-better run-time bound sits below 10 sqrt(eps(bf16)), where
    # "auto" asks for the Householder first iteration: cholqr2 in both
    "zolo": dict(method="zolo", mode="dynamic", l0_policy="runtime",
                 qr_mode="cholqr2"),
    # the dynamic default: the Householder first iteration in both
    "zolo_auto_first": dict(method="zolo", mode="dynamic",
                            l0_policy="runtime"),
}


@pytest.fixture(scope="module", autouse=True)
def _drop_reference_plans():
    """Leave the reference's plan cache as this module found it.  Its
    bf16-compute dynamic plans carry an f64 equation that its own plan
    audit flags (ROADMAP Queue C), and
    ``tests/test_analysis.py::test_audit_all_plans_green_after_suite``
    audits every plan cached in its worker process."""
    from repro.solver import planner as jplanner

    before = dict(jplanner._PLANS)
    yield
    jplanner._PLANS.clear()
    jplanner._PLANS.update(before)


@pytest.fixture(scope="module")
def matrix():
    a = np.asarray(make_matrix(2 * N, N, KAPPA, dtype=jnp.float32,
                               seed=SEED))
    return a, np.linalg.svd(a.astype(np.float64), compute_uv=False)


def _port_plan(jcfg, jplan, shape):
    p = S.plan(interop.svd_config_from_dict(dataclasses.asdict(jcfg)),
               shape, torch.float32, device="cpu")
    if p.schedule is not None:
        # the reference draws the prescale's start vector in the compute
        # dtype; bf16 values pass through f32 exactly
        v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                          (min(shape),), jnp.bfloat16)
                        .astype(jnp.float32))
        assert len(jplan.schedule) == len(p.schedule)
        p = interop.with_state(p, start_vector=v0)
    return p


def _count_householder_terms(monkeypatch):
    calls = []
    real = tzolo.term_sum_householder

    def counted(*args, **kw):
        calls.append(args[0].dtype)
        return real(*args, **kw)

    monkeypatch.setattr(tzolo, "term_sum_householder", counted)
    return calls


def _bf16_criteria(u, s, vh, s_exact):
    top = slice(0, N // 2)
    assert np.max(np.abs(s[top] - s_exact[top]) / s_exact[top]) <= S_RTOL
    for q in (u, vh.T):
        orth = float(tsvd.orthogonality(torch.from_numpy(q)))
        assert orth <= ORTH_TOL and orth <= ORTH_EARLY


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bf16_compute_plan_matches_reference(name, matrix, monkeypatch):
    a, s_exact = matrix
    jcfg = JS.SvdConfig(compute_dtype="bfloat16", **CONFIGS[name])
    jp = JS.plan(jcfg, a.shape, jnp.float32)
    tp = _port_plan(jcfg, jp, a.shape)
    assert tp.compute_dtype == torch.bfloat16 and tp.dtype == torch.float32
    u_j, s_j, vh_j = (np.asarray(x, np.float64) for x in jp.svd(
        jnp.asarray(a)))
    householder = _count_householder_terms(monkeypatch)
    u_t, s_t, vh_t = tp.svd(torch.from_numpy(a.copy()))
    # only the dynamic default reaches the Householder first iteration; the
    # term takes the bf16 iterate (and factorizes it in f32)
    want = [torch.bfloat16] if name == "zolo_auto_first" else []
    assert householder == want
    # results come back in the plan dtype
    assert u_t.dtype == s_t.dtype == vh_t.dtype == torch.float32
    assert u_t.shape == (2 * N, N) and vh_t.shape == (N, N)
    u_t, s_t, vh_t = (x.double().numpy() for x in (u_t, s_t, vh_t))
    assert np.all(np.isfinite(u_t)) and np.all(np.isfinite(vh_t))
    smax = float(s_j[0])
    assert np.max(np.abs(s_t - s_j)) / smax <= PAIR_TOL
    assert np.max(np.abs((u_t * s_t) @ vh_t - (u_j * s_j) @ vh_j)) / smax \
        <= PAIR_TOL
    for u, s, vh in ((u_t, s_t, vh_t), (u_j, s_j, vh_j)):
        _bf16_criteria(u, s, vh, s_exact)


@pytest.mark.parametrize("policy,method", [
    ("estimate_at_plan", "qdwh_static"),   # the kappa hint: auto
    ("runtime", "zolo"),                   # the run-time bound: auto
    ("runtime", "qdwh")])                  # asked for by name
def test_bf16_compute_plan_default_and_qdwh_methods_run(policy, method,
                                                         matrix):
    """The bf16 compute plan with the default method, for a kappa hint
    and for a run-time bound, resolves as the reference's ``auto`` does
    and solves; so does dynamic ``qdwh``.  Each is held to the
    reference's bf16 criteria against the exact spectrum (the reference's
    QDWH raises on bf16, so there is no reference solve to pair with)."""
    from repro.solver import planner as jplanner

    a, s_exact = matrix
    kw = dict(kappa=KAPPA) if policy == "estimate_at_plan" else \
        dict(mode="dynamic")
    jcfg = JS.SvdConfig(compute_dtype="bfloat16", l0_policy=policy, **kw)
    if method != "qdwh":
        assert jplanner._resolve(jcfg, a.shape, jnp.float32,
                                 None)[0].name == method
    else:
        jcfg = dataclasses.replace(jcfg, method=method)
    p = S.plan(interop.svd_config_from_dict(dataclasses.asdict(jcfg)),
               a.shape, torch.float32, device="cpu")
    assert p.method == method and p.compute_dtype == torch.bfloat16
    u, s, vh = p.svd(torch.from_numpy(a.copy()))
    assert u.dtype == s.dtype == vh.dtype == torch.float32
    u, s, vh = (x.double().numpy() for x in (u, s, vh))
    assert np.all(np.isfinite(u)) and np.all(np.isfinite(vh))
    _bf16_criteria(u, s, vh, s_exact)


def test_bf16_compute_plan_polar_returns_plan_dtype(matrix):
    a, _ = matrix
    p = S.plan(S.SvdConfig(compute_dtype="bfloat16",
                           **CONFIGS["zolo_static"]),
               a.shape, torch.float32, device="cpu")
    q, h, _ = p.polar(torch.from_numpy(a.copy()))
    assert q.dtype == h.dtype == torch.float32
    rec = (q.double() @ h.double()).numpy()
    assert np.max(np.abs(rec - a)) / np.max(np.abs(a)) <= 2 * BF16_EPS


# --- plan gating -------------------------------------------------------------


def test_bf16_compute_plan_raises_beyond_bf16_cap_inside_f32_cap():
    """The per-dtype table, keyed on the compute dtype, gates the kernel
    backend: a kappa between the bf16 and f32 caps plans at f32 compute
    and raises at bf16 compute (reference: test_bf16_envelope.py)."""
    kappa = math.sqrt(tsvd.CUDA_BF16_KAPPA_MAX * tsvd.CUDA_F32_KAPPA_MAX)
    assert tsvd.CUDA_BF16_KAPPA_MAX < kappa < tsvd.CUDA_F32_KAPPA_MAX
    cfg = S.SvdConfig(method="zolo_cuda", kappa=kappa,
                      l0_policy="estimate_at_plan")
    assert S.plan(cfg, (128, 128), torch.float32,
                  device="cpu").method == "zolo_cuda"
    with pytest.raises(ValueError, match="envelope"):
        S.plan(cfg.replace(compute_dtype="bfloat16"), (128, 128),
               torch.float32, device="cpu")
    dyn = S.SvdConfig(method="zolo_cuda_dynamic", mode="dynamic",
                      kappa=kappa, l0_policy="estimate_at_plan",
                      compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="envelope"):
        S.plan(dyn, (128, 128), torch.float32, device="cpu")


def test_f64_compute_refused_on_the_kernel_backends():
    for method in ("zolo_cuda", "zolo_cuda_dynamic"):
        cfg = S.SvdConfig(method=method, kappa=1e3,
                          l0_policy="estimate_at_plan",
                          compute_dtype="float64")
        with pytest.raises(ValueError, match="zolo_static"):
            S.plan(cfg, (32, 16), torch.float32, device="cpu")
    # the plain backends take it
    p = S.plan(S.SvdConfig(method="zolo_static", kappa=1e3,
                           l0_policy="estimate_at_plan",
                           compute_dtype="float64"),
               (32, 16), torch.float32, device="cpu")
    assert p.compute_dtype == torch.float64


def test_auto_never_selects_cuda_beyond_the_compute_dtype_cap(monkeypatch):
    """Priced by the compute dtype: +inf beyond its envelope, so ``auto``
    resolves to a plain backend there, and among the Zolo bindings to
    ``zolo_cuda`` inside it, on a CUDA device (resolution reads the
    device type only)."""
    # inside the bf16 cap, at a kappa where QDWH prices below Zolo
    inside = 9.0e3
    assert inside < tsvd.CUDA_BF16_KAPPA_MAX
    between = math.sqrt(tsvd.CUDA_BF16_KAPPA_MAX * tsvd.CUDA_F32_KAPPA_MAX)
    cuda = torch.device("cuda", 0)
    flops = registry.get_polar("zolo_cuda").flops_fn
    kw = dict(r=2, device=cuda)
    assert math.isinf(flops(256, 128, kappa=between, dtype=torch.bfloat16,
                            **kw))
    assert math.isfinite(flops(256, 128, kappa=between, dtype=torch.float32,
                               **kw))
    assert math.isfinite(flops(256, 128, kappa=inside, dtype=torch.bfloat16,
                               **kw))

    def resolved(kappa, compute):
        cfg = S.SvdConfig(kappa=kappa, l0_policy="estimate_at_plan",
                          compute_dtype=compute)
        return planner._resolve(cfg, (256, 128), torch.float32, cuda)[0].name

    assert "cuda" not in resolved(between, "bfloat16")
    assert resolved(between, None) == "zolo_cuda"
    # inside the bf16 cap QDWH's flops are lower (4 iterations against
    # Zolo's 3 at r = 2) and auto takes it, as the reference's CPU
    # pricing does; among the Zolo bindings the kernel backend wins
    assert resolved(inside, "bfloat16") == "qdwh_static"
    monkeypatch.delitem(registry._POLAR, "qdwh_static")
    assert resolved(inside, "bfloat16") == "zolo_cuda"


def test_plan_flops_and_repr_use_the_compute_dtype():
    cfg = S.SvdConfig(method="zolo_static", kappa=1e3,
                      l0_policy="estimate_at_plan")
    p32 = S.plan(cfg, (64, 32), torch.float32, device="cpu")
    pbf = S.plan(cfg.replace(compute_dtype="bfloat16"), (64, 32),
                 torch.float32, device="cpu")
    assert p32 is not pbf  # the compute dtype keys the plan cache
    assert p32.compute_dtype == torch.float32
    assert "compute_dtype=bfloat16" in repr(pbf)
    assert "compute_dtype" not in repr(p32)
    assert pbf.flops_estimate() == p32.flops_estimate() > 0
    with pytest.raises(ValueError, match="compute_dtype"):
        S.SvdConfig(compute_dtype="int8")
