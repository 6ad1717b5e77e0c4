"""repro_torch.resilience against repro.resilience.

Each case feeds the same numpy input (``conftest.make_matrix``, f64)
through the reference and the port: the health verdicts, the escalation
ladders (derived from the registry flags, rung by rung), fault
injection through the production ladder, and the planner's verified
entry points.  Tolerances:

* singular values: within 1e-12 of s_max between the packages, and
  within 1e-8 of numpy's (the reference test's own bound);
* health scalars: ``finite``/``converged`` equal; ``orth`` is rounding
  noise of the two U's in both packages — each below 1e-13 and within
  64 eps(f64) of the other; ``kappa_est`` within 1e-12 relative (both
  packages derive it from the same l0 or the same run-time bound);
* trails: the same rungs, reasons (reference backend names mapped to the
  port's) and outcomes.

Fault indices count calls in the port and traced call sites in the
reference; the cases here inject at index 0 or on static schedules,
where the two agree (``faulty_ops``'s docstring).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import make_matrix  # noqa: E402
import repro.resilience as JR  # noqa: E402
import repro.solver as JS  # noqa: E402
from repro.core.registry import get_polar as jget_polar  # noqa: E402
from repro.core.zolo import DEFAULT_OPS as J_DEFAULT_OPS  # noqa: E402
import repro_torch.resilience as R  # noqa: E402
import repro_torch.solver as S  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.core import svd as tsvd  # noqa: E402
from repro_torch.core import zolo as tzolo  # noqa: E402
from repro_torch.resilience.health import SolveHealth  # noqa: E402

S_TOL = 1e-12
ORTH_NOISE = 64 * np.finfo(np.float64).eps


@pytest.fixture(scope="module", autouse=True)
def _restore_reference_caches():
    """Leave the reference's plan caches as this module found them:
    ``tests/test_analysis.py::test_audit_all_plans_green_after_suite``
    audits every plan cached in its worker process."""
    from repro.solver import planner as jplanner
    from repro.spectral import topk as jtopk

    before = dict(jplanner._PLANS), dict(jtopk._TOPK_PLANS)
    yield
    for cache, saved in zip((jplanner._PLANS, jtopk._TOPK_PLANS), before):
        cache.clear()
        cache.update(saved)


def _port_name(text):
    for ref, port in interop.METHOD_NAMES.items():
        text = text.replace(ref, port)
    return text


def _port_config(jcfg):
    d = dataclasses.asdict(jcfg)
    return interop.svd_config_from_dict(
        {k: v for k, v in d.items() if k != "extra"})


def _start_vector(shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                        (min(shape),), jnp.float64))


def _port_plan(jcfg, shape):
    """The port's plan for the reference config, with the reference's
    prescale start vector bound (static plans)."""
    p = S.plan(_port_config(jcfg), shape, torch.float64, device="cpu")
    if p.schedule is not None:
        p = interop.with_state(p, start_vector=_start_vector(shape))
    return p


def _assert_health_agrees(ht, hj):
    assert bool(ht.finite) == bool(hj.finite)
    assert bool(ht.converged) == bool(hj.converged)
    ot, oj = float(ht.orth), float(hj.orth)
    assert ot <= 1e-13 and oj <= 1e-13
    assert abs(ot - oj) <= ORTH_NOISE
    kt, kj = float(ht.kappa_est), float(hj.kappa_est)
    assert (np.isnan(kt) and np.isnan(kj)) or kt == pytest.approx(
        kj, rel=1e-12)


def _trail(trail):
    return [(t.rung, _port_name(t.reason), t.outcome) for t in trail]


def _verdict_heads(trail):
    """Each rung's failure reasons, without their numbers."""
    return [tuple(r.split(" ")[0] for r in t.verdict.reasons)
            if t.verdict is not None else None for t in trail]


def _s_close(s_t, s_j):
    s_t, s_j = np.asarray(s_t), np.asarray(s_j)
    assert np.max(np.abs(s_t - s_j)) <= S_TOL * s_j[0]


# --- the converged flag ------------------------------------------------------


def test_dynamic_driver_reports_nonconvergence():
    import repro.core as JC

    a = np.asarray(make_matrix(64, 48, kappa=1e10, seed=3))
    at = torch.from_numpy(a.copy())
    _, _, ij = JC.zolo_pd(jnp.asarray(a), want_h=False, max_iters=1)
    _, _, it = tzolo.zolo_pd(at, want_h=False, max_iters=1)
    assert not bool(it.converged) and not bool(ij.converged)
    # the run-time bound does not depend on the iteration cap
    assert float(it.l_init) == pytest.approx(float(ij.l_init), rel=1e-12)
    _, _, it = tzolo.zolo_pd(at, want_h=False)
    assert bool(it.converged)
    # kappa_est = 1/l_init tracks the true conditioning
    assert 1e8 < 1.0 / float(it.l_init) < 1e13


# --- health verdicts ---------------------------------------------------------


def test_svd_verified_healthy():
    a = np.asarray(make_matrix(64, 48, kappa=1e4, seed=0))
    jcfg = JS.SvdConfig(kappa=1e4, l0_policy="estimate_at_plan")
    jp = JS.plan(jcfg, a.shape, jnp.float64)
    tp = _port_plan(jcfg, a.shape)
    assert tp.method == jp.method
    at = torch.from_numpy(a.copy())
    u, s, vh, ht = tp.svd_verified(at)
    _, s_j, _, hj = jp.svd_verified(jnp.asarray(a))
    vt, vj = R.judge_plan(tp, ht), JR.judge_plan(jp, hj)
    assert vt.ok and vj.ok, (str(vt), str(vj))
    assert vt.orth_tol == vj.orth_tol == R.default_orth_tol(torch.float64)
    assert vt.kappa_max is None
    _assert_health_agrees(ht, hj)
    _s_close(s, s_j)
    # the factors are the ones svd() returns
    _, s0, _ = tp.svd(at)
    assert torch.equal(s, s0)


def test_svd_batched_verified_leaves_carry_batch_axis():
    a = np.stack([np.asarray(make_matrix(48, 32, kappa=1e3, seed=i))
                  for i in range(3)])
    jcfg = JS.SvdConfig(kappa=1e3, l0_policy="estimate_at_plan")
    jp = JS.plan(jcfg, (48, 32), jnp.float64)
    tp = _port_plan(jcfg, (48, 32))
    u, s, vh, ht = tp.svd_batched_verified(torch.from_numpy(a.copy()))
    _, s_j, _, hj = jp.svd_batched_verified(jnp.asarray(a))
    assert u.shape == (3, 48, 32) and vh.shape == (3, 32, 32)
    for leaf in ht:
        assert tuple(leaf.shape) == (3,)
    for i in range(3):
        entry = SolveHealth(*(t[i] for t in ht))
        assert R.judge_plan(tp, entry).ok
        _assert_health_agrees(entry, JR.SolveHealth(*(t[i] for t in hj)))
        _s_close(s[i], s_j[i])


def test_svd_batched_verified_flags_only_the_poisoned_entry():
    a = np.stack([np.asarray(make_matrix(48, 32, kappa=1e3, seed=i))
                  for i in range(3)])
    a[1] = np.nan
    jcfg = JS.SvdConfig(kappa=1e3, l0_policy="estimate_at_plan")
    tp = _port_plan(jcfg, (48, 32))
    _, s, _, ht = tp.svd_batched_verified(torch.from_numpy(a.copy()))
    jp = JS.plan(jcfg, (48, 32), jnp.float64)
    _, _, _, hj = jp.svd_batched_verified(jnp.asarray(a))
    oks = [R.judge_plan(tp, SolveHealth(*(t[i] for t in ht))).ok
           for i in range(3)]
    oks_j = [JR.judge_plan(jp, JR.SolveHealth(*(t[i] for t in hj))).ok
             for i in range(3)]
    assert oks == oks_j == [True, False, True]
    assert not bool(torch.isfinite(s[1]).any())


def test_health_masks_null_space_columns():
    a = np.asarray(make_matrix(48, 24, kappa=1e3, seed=1))
    padded = np.zeros((64, 48))
    padded[:48, :24] = a
    jcfg = JS.SvdConfig(kappa=1e3, l0_policy="estimate_at_plan")
    jp = JS.plan(jcfg, (64, 48), jnp.float64)
    tp = _port_plan(jcfg, (64, 48))
    _, s, _, ht = tp.svd_verified(torch.from_numpy(padded))
    _, s_j, _, hj = jp.svd_verified(jnp.asarray(padded))
    assert R.judge_plan(tp, ht).ok and JR.judge_plan(jp, hj).ok
    _assert_health_agrees(ht, hj)
    _s_close(s[:24], s_j[:24])


@pytest.mark.parametrize("finite,orth,conv,kap,kmax,n_reasons", [
    (False, 1.0, False, 1e5, 2e4, 4),
    # NaN orthogonality (NaN factors) must fail, not sail through
    (True, float("nan"), True, float("nan"), None, 1),
    (True, 1e-12, True, 1e3, 2e4, 0),
])
def test_judge_reasons(finite, orth, conv, kap, kmax, n_reasons):
    vt = R.judge(SolveHealth(torch.tensor(finite), torch.tensor(orth),
                             torch.tensor(conv), torch.tensor(kap)),
                 orth_tol=1e-10, kappa_max=kmax)
    vj = JR.judge(JR.SolveHealth(jnp.asarray(finite), jnp.asarray(orth),
                                 jnp.asarray(conv), jnp.asarray(kap)),
                  orth_tol=1e-10, kappa_max=kmax)
    assert vt.reasons == vj.reasons and len(vt.reasons) == n_reasons
    assert vt.ok == vj.ok == (n_reasons == 0)
    assert str(vt) == str(vj)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_default_orth_tol_matches_reference(dtype):
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.float64: jnp.float64}[dtype]
    assert R.default_orth_tol(dtype) == JR.default_orth_tol(jd)


# --- the runtime kappa envelope ----------------------------------------------


def test_runtime_envelope_folded_into_verdict():
    class _Stub:
        compute_dtype = torch.float32
        method = "zolo_cuda_dynamic"

    spec = registry.get_polar("zolo_cuda_dynamic")
    cap = spec.kappa_max_f32
    assert cap == tsvd.CUDA_F32_KAPPA_MAX

    def health(kappa_est):
        return SolveHealth(finite=torch.tensor(True),
                           orth=torch.tensor(1e-6),
                           converged=torch.tensor(True),
                           kappa_est=torch.tensor(kappa_est))

    v = R.judge_plan(_Stub(), health(cap * 10))
    assert not v.ok and v.kappa_max == cap
    assert [r.split(" beyond")[0] for r in v.reasons] == \
        [f"runtime kappa estimate {cap * 10:.3g}"]
    assert R.judge_plan(_Stub(), health(cap / 10)).ok

    class _StubF64(_Stub):
        compute_dtype = torch.float64

    # under f64 compute the f32 envelope does not apply
    v64 = R.judge_plan(_StubF64(), health(cap * 10))
    assert v64.kappa_max is None
    assert not any("envelope" in r for r in v64.reasons)
    # bf16 compute reads the bf16 entry of the envelope table
    stub16 = type("_Stub16", (_Stub,), {"compute_dtype": torch.bfloat16})
    assert R.judge_plan(stub16(), health(cap * 10)).kappa_max == \
        tsvd.CUDA_KAPPA_ENVELOPE[("bfloat16", "float32")]
    # the reference folds its own kernels' envelope in the same way
    jstub = type("_J", (), {"config": JS.SvdConfig(method="zolo"),
                            "dtype": jnp.float32,
                            "method": "zolo_pallas_dynamic"})
    jcap = jget_polar("zolo_pallas_dynamic").kappa_max_f32
    jv = JR.judge_plan(jstub(), JR.SolveHealth(
        finite=jnp.asarray(True), orth=jnp.asarray(1e-6, jnp.float32),
        converged=jnp.asarray(True),
        kappa_est=jnp.asarray(jcap * 10, jnp.float32)))
    assert [r.split(" ")[:3] for r in jv.reasons] == \
        [r.split(" ")[:3] for r in v.reasons]


# --- the escalation ladder ---------------------------------------------------


def _ladders(jcfg, shape, jdtype, tdtype):
    jl = JR.escalation_ladder(JS.plan(jcfg, shape, jdtype))
    tl = R.escalation_ladder(S.plan(_port_config(jcfg), shape, tdtype,
                                    device="cpu"))
    return jl, tl


@pytest.mark.parametrize("method,jdtype,tdtype", [
    ("zolo_static", jnp.float64, torch.float64),
    ("zolo_static", jnp.float32, torch.float32),
    ("zolo_pallas", jnp.float32, torch.float32),
    ("zolo_pallas_dynamic", jnp.float32, torch.float32),
    ("auto", jnp.float32, torch.float32),
])
def test_ladder_derived_from_capability_flags(method, jdtype, tdtype):
    kw = ({} if method == "zolo_pallas_dynamic" else
          {"kappa": 1e4, "l0_policy": "estimate_at_plan"})
    jcfg = JS.SvdConfig(method=method, **kw)
    jl, tl = _ladders(jcfg, (64, 48), jdtype, tdtype)
    assert [_port_name(r) for _, r in jl] == [r for _, r in tl]
    for (cj, _), (ct, _) in zip(jl, tl):
        assert _port_config(cj) == ct
    reasons = [r for _, r in tl]
    assert reasons[0] == "as planned"
    assert any("householder" in r for r in reasons)
    assert ("float64" in reasons[-1]) == (tdtype != torch.float64)
    for (c1, _), (c2, _) in zip(tl, tl[1:]):
        assert c1 != c2
    spec = registry.get_polar(S.plan(tl[0][0], (64, 48), tdtype,
                                     device="cpu").method)
    assert (spec.fallback is not None) == reasons[1].startswith(
        "kernel fallback")


def test_cuda_specs_declare_fallbacks():
    for name, fb in (("zolo_cuda", "zolo_static"),
                     ("zolo_cuda_dynamic", "zolo")):
        spec = registry.get_polar(name)
        assert spec.fallback == fb
        assert spec.kappa_max_f32 == tsvd.CUDA_F32_KAPPA_MAX
        assert spec.kappa_envelope == tsvd.CUDA_KAPPA_ENVELOPE
    with pytest.raises(ValueError, match="loop"):
        registry.register_polar("self_loop",
                                fallback="self_loop")(lambda a: None)


def test_ladder_checks_the_engine_modes(monkeypatch):
    from repro_torch.resilience import escalate

    p = S.plan(S.SvdConfig(method="zolo"), (16, 8), torch.float64,
               device="cpu")
    monkeypatch.setattr(escalate, "_QR_LADDER", ("chol", "cholqr2"))
    with pytest.raises(RuntimeError, match="_QR_LADDER"):
        escalate.escalation_ladder(p)


def test_unplannable_rung_recorded_as_plan_error():
    # qr_iters is consumed by the Zolo engines only: the run-time rung's
    # "auto" resolves to QDWH, whose plan refuses the knob — in both
    # packages that rung (and the f64 one after it) is a plan-error, and
    # the ladder runs out
    a = np.asarray(make_matrix(48, 32, 1e4, seed=9))

    def jbroken(x, t, aw, mh):
        return J_DEFAULT_OPS.polar_update(x, t, aw, mh) * float("nan")

    def tbroken(x, t, aw, mh):
        return tzolo.DEFAULT_OPS.polar_update(x, t, aw, mh) * float("nan")

    jcfg = JS.SvdConfig(method="zolo_static", kappa=1e4, qr_iters=1,
                        l0_policy="estimate_at_plan", compute_dtype="float32",
                        extra=(("ops", J_DEFAULT_OPS._replace(
                            polar_update=jbroken)),))
    with pytest.raises(JR.SolveFailure) as ej:
        JR.solve_with_escalation(jnp.asarray(a), jcfg)
    tcfg = _port_config(jcfg).replace(extra=(
        ("ops", tzolo.DEFAULT_OPS._replace(polar_update=tbroken)),))
    with pytest.raises(R.SolveFailure) as ei:
        R.solve_with_escalation(torch.from_numpy(a.copy()), tcfg)
    trail = ei.value.trail
    assert _trail(trail) == _trail(ej.value.trail)
    assert [t.outcome for t in trail] == ["failed", "failed", "plan-error",
                                          "plan-error"]
    assert "qr_iters" in trail[2].error
    assert "plan-error" in str(ei.value)


# --- fault injection through the production ladder ---------------------------


def _escalate_both(a, jcfg, tops):
    u_j, s_j, vh_j, trail_j = JR.solve_with_escalation(jnp.asarray(a), jcfg)
    tcfg = _port_config(jcfg).replace(extra=(("ops", tops),))
    u, s, vh, trail = R.solve_with_escalation(torch.from_numpy(a.copy()),
                                              tcfg)
    assert _trail(trail) == _trail(trail_j)
    assert _verdict_heads(trail) == _verdict_heads(trail_j)
    _s_close(s, s_j)
    return s, trail


def test_faulty_ops_nan_recovers_up_the_ladder():
    a = np.asarray(make_matrix(64, 48, kappa=1e4, seed=2))
    jcfg = JS.SvdConfig(method="zolo", qr_mode="cholqr2",
                        extra=(("ops", JR.faulty_ops(nan_at_iter=0)),))
    s, trail = _escalate_both(a, jcfg, R.faulty_ops(nan_at_iter=0))
    assert trail[0].outcome == "failed" and not trail[0].verdict.ok
    assert "non-finite factors" in trail[0].verdict.reasons
    assert trail[-1].outcome == "passed"
    s_ref = np.linalg.svd(a, compute_uv=False)
    np.testing.assert_allclose(s.numpy(), s_ref[:48], atol=1e-8)


def test_faulty_ops_indefinite_gram_recovers():
    a = np.asarray(make_matrix(64, 48, kappa=1e4, seed=4))
    jcfg = JS.SvdConfig(method="zolo", qr_mode="chol",
                        extra=(("ops", JR.faulty_ops(indefinite_at_iter=0)),))
    _, trail = _escalate_both(a, jcfg, R.faulty_ops(indefinite_at_iter=0))
    assert trail[0].outcome == "failed"
    assert trail[-1].outcome == "passed"


def test_faulty_ops_wraps_the_kernel_bundle_on_a_static_schedule():
    # a static schedule: call indices are iterations in both packages;
    # the port's kernel bundle (plain versions on the CPU) stands where
    # the reference's default ops do
    from repro_torch.core.zolo_cuda import cuda_zolo_ops

    a = np.asarray(make_matrix(64, 48, kappa=1e4, seed=12))
    jcfg = JS.SvdConfig(method="zolo_static", qr_mode="cholqr2", kappa=1e4,
                        l0_policy="estimate_at_plan", r=2,
                        extra=(("ops", JR.faulty_ops(nan_at_iter=1)),))
    s, trail = _escalate_both(a, jcfg, R.faulty_ops(cuda_zolo_ops(),
                                                    nan_at_iter=1))
    assert [t.outcome for t in trail] == ["failed", "passed"]
    assert trail[1].reason == "first-iteration factorization -> householder"


def test_exhausted_ladder_raises_solve_failure_with_trail():
    a = np.asarray(make_matrix(64, 48, kappa=1e4, seed=5))

    def jbroken(x, t, aw, mh):
        return J_DEFAULT_OPS.polar_update(x, t, aw, mh) * float("nan")

    def tbroken(x, t, aw, mh):
        return tzolo.DEFAULT_OPS.polar_update(x, t, aw, mh) * float("nan")

    jcfg = JS.SvdConfig(method="zolo", extra=(
        ("ops", J_DEFAULT_OPS._replace(polar_update=jbroken)),))
    with pytest.raises(JR.SolveFailure) as ej:
        JR.solve_with_escalation(jnp.asarray(a), jcfg)
    tcfg = _port_config(jcfg).replace(extra=(
        ("ops", tzolo.DEFAULT_OPS._replace(polar_update=tbroken)),))
    with pytest.raises(R.SolveFailure) as ei:
        R.solve_with_escalation(torch.from_numpy(a.copy()), tcfg)
    trail = ei.value.trail
    assert len(trail) >= 2
    assert all(t.outcome in ("failed", "plan-error") for t in trail)
    assert "non-finite" in str(ei.value)
    assert _trail(trail) == _trail(ej.value.trail)
    assert isinstance(ei.value, R.ResilienceError)


def test_static_cholqr2_breakdown_climbs_to_householder():
    # the static CholeskyQR2 breakdown at kappa = 1e10 in f64: c_1 is
    # below the Gram's rounding noise and is never clamped in f64, so
    # the first iteration is NaN in both packages; the Householder rung
    # is finite on the same input
    a = np.asarray(make_matrix(64, 48, kappa=1e10, seed=3))
    jcfg = JS.SvdConfig(method="zolo_static", qr_mode="cholqr2",
                        kappa=1e10, l0_policy="estimate_at_plan")
    u_j, s_j, vh_j, trail_j = JR.solve_with_escalation(jnp.asarray(a), jcfg)
    u, s, vh, trail = R.solve_with_escalation(torch.from_numpy(a.copy()),
                                              _port_config(jcfg))
    assert _trail(trail) == _trail(trail_j) == [
        (0, "as planned", "failed"),
        (1, "first-iteration factorization -> householder", "passed")]
    assert "non-finite factors" in trail[0].verdict.reasons
    _s_close(s, s_j)


def test_batched_input_rejected():
    with pytest.raises(ValueError, match="one \\(m, n\\) matrix"):
        R.solve_with_escalation(torch.zeros((2, 8, 8)), S.SvdConfig())


def test_solve_failure_message_matches_reference():
    cfg = S.SvdConfig()
    verdict = R.judge(SolveHealth(torch.tensor(False), torch.tensor(1.0),
                                  torch.tensor(True),
                                  torch.tensor(float("nan"))),
                      orth_tol=1e-3)
    trail = (R.RungAttempt(0, "as planned", cfg, "failed", verdict=verdict),
             R.RungAttempt(1, "compute dtype -> float64", cfg, "plan-error",
                           error="no plan"))
    jv = JR.judge(JR.SolveHealth(jnp.asarray(False), jnp.asarray(1.0),
                                 jnp.asarray(True),
                                 jnp.asarray(float("nan"))), orth_tol=1e-3)
    jtrail = (JR.RungAttempt(0, "as planned", JS.SvdConfig(), "failed",
                             verdict=jv),
              JR.RungAttempt(1, "compute dtype -> float64", JS.SvdConfig(),
                             "plan-error", error="no plan"))
    assert str(R.SolveFailure(trail)) == str(JR.SolveFailure(jtrail))
    assert str(R.SolveFailure()) == str(JR.SolveFailure())
    for name in ("Backpressure", "CircuitOpen", "DeadlineExceeded",
                 "FutureTimeout"):
        assert issubclass(getattr(R, name), R.ResilienceError)
    assert R.ServiceFaults() == R.ServiceFaults(nan_below_rung=1)
    assert dataclasses.asdict(R.ServiceFaults()) == dataclasses.asdict(
        JR.ServiceFaults())
