"""repro_torch.spectral (and the norms and lowrank_truncate it brings)
against repro.spectral.

The reference draws its sketch test matrices and d&c probes from
``jax.random`` keys; those draws are carried into the port through
``repro_torch.interop.with_draws``, so both packages compute the same
thing on the same numpy input (``conftest.make_matrix``, f64).
Tolerances:

* the building blocks with no rounding freedom — ``_fwht``,
  ``needed_power_iters``, ``sketch_flops``, ``dnc_flops`` and the plan
  decisions — are exact;
* singular values and U diag(s) Vh within 1e-12 of s_max between the
  packages, beyond the reference's own distance from the exact
  leading-k answer (its inner solves carry its own rounding), and
  within the reference tests' 1e-10 of numpy's; the range finder's Q
  within 1e-12 (elementwise: the same CholeskyQR2 arithmetic on the
  same draw);
* the norms estimates within 1e-12 relative (the same deterministic
  iterations);
* ``lowrank_truncate`` plans its own draw in each package: both within
  sqrt(tol) s_max of the Eckart-Young optimum (the residual-level
  accuracy its tol = 1e-6 certifies), and within the reference test's
  own bound of the optimal error.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import make_matrix  # noqa: E402
import repro.core.norms as JN  # noqa: E402
import repro.spectral as JSP  # noqa: E402
import repro.spectral.sketch as JSK  # noqa: E402
from repro.optim import compression as JCP  # noqa: E402
import repro_torch.spectral as SP  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import norms as TN  # noqa: E402
from repro_torch.optim import lowrank_truncate  # noqa: E402
from repro_torch.solver import SvdConfig  # noqa: E402
from repro_torch.spectral import sketch as TSK  # noqa: E402

TOL = 1e-12


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


def _port_config(jcfg):
    d = dataclasses.asdict(jcfg)
    svd = interop.svd_config_from_dict(d.pop("svd"))
    return SP.TopKConfig(svd=svd, **d)


def _reference_draws(jplan):
    """The reference's draws for one solve of ``jplan``, as numpy."""
    key = jax.random.PRNGKey(jplan.config.seed)
    n, l, dt = min(jplan.shape), jplan.l, jplan.dtype
    if jplan.strategy == "dnc":
        return {"probe": np.asarray(jax.random.normal(key, (n, l), dt))}
    if jplan.config.sketch_kind == "gauss":
        return {"omega": np.asarray(jax.random.normal(key, (n, l), dt))}
    k_sign, k_pick = jax.random.split(key)
    return {"signs": np.asarray(jax.random.rademacher(k_sign, (n,), dt)),
            "cols": np.asarray(jax.random.choice(
                k_pick, TSK.srht_width(n), (l,), replace=False))}


def _plans(jcfg, shape):
    jp = JSP.plan_topk(jcfg, shape, jnp.float64)
    tp = SP.plan_topk(_port_config(jcfg), shape, torch.float64,
                      device="cpu")
    assert (tp.strategy, tp.l, tp.q_iters) == (jp.strategy, jp.l,
                                               jp.q_iters)
    if jp.strategy != "dense":
        tp = interop.with_draws(tp, **_reference_draws(jp))
    return jp, tp


def _diff(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                               - np.asarray(y, np.float64))))


def _assert_triplets_agree(t, j, a):
    """s and U diag(s) Vh of the two packages within 1e-12 of s_max plus
    the reference's own distance from the exact leading-k answer."""
    (u_t, s_t, vh_t), (u_j, s_j, vh_j) = [
        [np.asarray(x) for x in trip] for trip in (t, j)]
    k = s_j.shape[-1]
    u, s, vh = np.linalg.svd(np.asarray(a), full_matrices=False)
    best = (u[:, :k] * s[:k]) @ vh[:k]
    smax = float(s[0])
    assert u_t.shape == u_j.shape and vh_t.shape == vh_j.shape
    assert _diff(s_t, s_j) <= TOL * smax + _diff(s_j, s[:k])
    rec_j = (u_j * s_j) @ vh_j
    assert _diff((u_t * s_t) @ vh_t, rec_j) <= TOL * smax + _diff(rec_j,
                                                                  best)


# --- exact building blocks ---------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 16), (1,)])
def test_fwht_exact(shape):
    x = np.random.default_rng(0).standard_normal(shape)
    got = TSK._fwht(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JSK._fwht(jnp.asarray(x))))


def test_cost_and_accuracy_models_exact():
    for args in [(64, 8, 64, 1e6, 1e-10), (512, 8, 16, 1.0, 1e-10),
                 (512, 8, 40, 1e10, 1e-10), (11999, 128, 877, 9.06e3, 1e-5),
                 (4096, 16, 272, 1e6, 1e-6)]:
        assert SP.needed_power_iters(*args) == JSP.needed_power_iters(*args)
    for args in [(4096, 512, 16, 32, 2, 1e6), (11999, 11999, 128, 877, 7,
                                                3.1e13), (64, 48, 4, 12, 0)]:
        assert SP.sketch_flops(*args) == JSP.sketch_flops(*args)
    for args in [(256, 96, 8, 104, 12, 1e9, 2e7), (4096, 4096, 128, 384,
                                                   12, 4.2e12)]:
        assert SP.dnc_flops(*args) == JSP.dnc_flops(*args)


@pytest.mark.parametrize("shape", [(2048, 512), (512, 2048), (192, 192)])
def test_plan_topk_decisions_match_reference(shape):
    nmin = min(shape)
    for k in (8, nmin - 4):
        for kappa in (1.0, 1e4, 1e10):
            for tol in (1e-10, 1e-5):
                for strategy in ("auto", "dnc"):
                    jcfg = JSP.TopKConfig(k=k, kappa=kappa, tol=tol,
                                          strategy=strategy)
                    jp = JSP.plan_topk(jcfg, shape, jnp.float64)
                    tp = SP.plan_topk(_port_config(jcfg), shape,
                                      torch.float64, device="cpu")
                    assert (tp.strategy, tp.l, tp.q_iters) == \
                        (jp.strategy, jp.l, jp.q_iters)
                    assert tp.decision == jp.decision, (shape, k, kappa,
                                                        tol)
                    assert tp.flops_estimate == jp.flops_estimate
                    assert {n: p.method for n, p in tp._inner.items()} == \
                        {n: p.method for n, p in jp._inner.items()}


# --- the sketch on the reference's draws -------------------------------------


@pytest.mark.parametrize("kind", ["gauss", "srht"])
def test_randomized_range_on_reference_draw(kind):
    a = np.asarray(make_matrix(256, 64, 1e8, seed=16))
    key = jax.random.PRNGKey(0)
    q_j = JSK.randomized_range(jnp.asarray(a), 16, 4, key, kind=kind)
    jplan = type("P", (), {"config": JSP.TopKConfig(sketch_kind=kind),
                           "shape": a.shape, "l": 16, "strategy": "sketch",
                           "dtype": jnp.float64})
    draw = {k: torch.as_tensor(v) for k, v in
            _reference_draws(jplan).items()}
    q_t = TSK.randomized_range(torch.from_numpy(a), 4, draw, kind=kind)
    assert q_t.shape == (256, 16)
    assert _diff(q_t, q_j) <= TOL
    g = q_t.numpy().T @ q_t.numpy()
    assert np.linalg.norm(g - np.eye(16)) < 1e-12


def test_sketch_draw_shapes_and_determinism():
    gen = torch.Generator().manual_seed(3)
    d = TSK.sketch_draw("srht", 48, 12, generator=gen, dtype=torch.float64,
                        device="cpu")
    assert d["signs"].shape == (48,) and d["cols"].shape == (12,)
    assert set(d["signs"].tolist()) <= {-1.0, 1.0}
    assert len(set(d["cols"].tolist())) == 12 and int(d["cols"].max()) < 64
    a = torch.from_numpy(np.asarray(make_matrix(64, 48, 1e2, seed=17)))
    y1 = TSK.srht_sketch(a, **d)
    y2 = TSK.srht_sketch(a, **d)
    assert y1.shape == (64, 12) and torch.equal(y1, y2)
    with pytest.raises(ValueError, match="sketch kind"):
        TSK.sketch_draw("nope", 4, 2, generator=gen, dtype=torch.float64,
                        device="cpu")


@pytest.mark.parametrize("shape,kind", [((128, 64), "gauss"),
                                        ((48, 128), "gauss"),
                                        ((128, 96), "srht")])
def test_sketch_topk_matches_reference(shape, kind):
    a = np.asarray(make_matrix(*shape, 1e6, seed=5))
    jcfg = JSP.TopKConfig(k=6, kappa=1e6, strategy="sketch",
                          sketch_kind=kind)
    jp, tp = _plans(jcfg, shape)
    at = torch.from_numpy(a.copy())
    t, j = tp.topk(at), jp.topk(jnp.asarray(a))
    _assert_triplets_agree(t, j, a)
    ref = np.linalg.svd(a, compute_uv=False)[:6]
    assert _diff(t[1], ref) <= 1e-10 * ref[0]
    r_t, r_j = float(tp.residual(at, *t)), float(jp.residual(
        jnp.asarray(a), *j))
    assert r_t == pytest.approx(r_j, rel=1e-6, abs=1e-14)
    assert r_t <= 1e-5
    # the plan's own draw (no binding) reaches the same accuracy
    own = SP.plan_topk(_port_config(jcfg), shape, torch.float64,
                       device="cpu")
    assert own.draws is None and _diff(own.topk(at)[1], ref) <= \
        1e-10 * ref[0]


def test_topk_batched_matches_reference():
    mats = np.stack([np.asarray(make_matrix(128, 48, 1e4, seed=s))
                     for s in (1, 2, 3)])
    jcfg = JSP.TopKConfig(k=6, kappa=1e4)
    jp, tp = _plans(jcfg, (128, 48))
    assert tp.strategy == "sketch"
    t = tp.topk_batched(torch.from_numpy(mats.copy()))
    j = jp.topk_batched(jnp.asarray(mats))
    assert t[0].shape == (3, 128, 6) and t[1].shape == (3, 6)
    assert t[2].shape == (3, 6, 48)
    for i in range(3):
        _assert_triplets_agree([x[i] for x in t], [x[i] for x in j],
                               mats[i])


# --- d&c on the reference's probe --------------------------------------------


@pytest.mark.parametrize("shape", [(160, 64), (64, 160)])
def test_dnc_topk_matches_reference(shape):
    a = np.asarray(make_matrix(*shape, 1e3, seed=8))
    jcfg = JSP.TopKConfig(k=6, strategy="dnc", kappa=1e3)
    jp, tp = _plans(jcfg, shape)
    assert tp._inner["sign"].method == jp._inner["sign"].method
    u, s, vh, info = tp.topk_with_info(torch.from_numpy(a.copy()))
    *j, jinfo = jp.topk_with_info(jnp.asarray(a))
    _assert_triplets_agree((u, s, vh), j, a)
    ref = np.linalg.svd(a, compute_uv=False)[:6]
    assert _diff(s, ref) <= 1e-10 * ref[0]
    assert info["converged"] == bool(jinfo["converged"])
    assert info["count"] == float(jinfo["count"])
    assert info["rounds"] == int(jinfo["rounds"])
    assert float(info["shift"]) == pytest.approx(float(jinfo["shift"]),
                                                 rel=1e-12)
    assert info["converged"] and tp.k <= info["count"] <= tp.l


def test_count_above_and_bisect_shift_on_a_diagonal():
    w = np.asarray([3.0, 2.0, 1.0, 0.5, 0.1])
    q = np.diag(np.sign(w - 0.75))
    assert float(SP.count_above(torch.from_numpy(q))) == \
        float(JSP.count_above(jnp.asarray(q))) == 3.0
    w = np.geomspace(1.0, 1e-6, 32)
    out_t = SP.bisect_shift(
        torch.from_numpy(np.diag(w)), 4, 8,
        lambda x: torch.diag(torch.sign(torch.diagonal(x))),
        torch.tensor(1e-6, dtype=torch.float64),
        torch.tensor(1.0 + 1e-12, dtype=torch.float64), max_rounds=24)
    out_j = JSP.bisect_shift(
        jnp.diag(jnp.asarray(w)), 4, 8,
        lambda x: jnp.diag(jnp.sign(jnp.diag(x))), jnp.asarray(1e-6),
        jnp.asarray(1.0 + 1e-12), max_rounds=24)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    assert float(out_t[1]) == float(out_j[1])
    assert (out_t[2], out_t[3], out_t[4]) == (float(out_j[2]),
                                              bool(out_j[3]),
                                              int(out_j[4]))
    assert out_t[3] and 4 <= out_t[2] <= 8


def test_norms_for_dnc_match_reference():
    a = np.asarray(make_matrix(96, 64, 1e5, seed=19)) * 3.0
    at = torch.from_numpy(a.copy())
    lo_t, hi_t = TN.singular_interval(at)
    lo_j, hi_j = JN.singular_interval(jnp.asarray(a))
    assert float(hi_t) == pytest.approx(float(hi_j), rel=TOL)
    assert float(lo_t) == pytest.approx(float(lo_j), rel=TOL)
    assert float(TN.condition_estimate(at)) == pytest.approx(
        float(JN.condition_estimate(jnp.asarray(a))), rel=TOL)
    x0 = a / float(hi_j)
    gram = lambda x: x.mT @ x  # noqa: E731  (the ZoloOps gram contract)
    for kw_t, kw_j in (({}, {}), ({"gram": gram},
                                  {"gram": lambda x: x.T @ x})):
        assert float(TN.sigma_min_lower(torch.from_numpy(x0), **kw_t)) == \
            pytest.approx(float(JN.sigma_min_lower(jnp.asarray(x0),
                                                   **kw_j)), rel=TOL)
    # a bf16 input is estimated in f32, never at the bf16 floor
    lo16 = TN.sigma_min_lower(torch.from_numpy(x0).to(torch.bfloat16))
    assert lo16.dtype == torch.float32


# --- adaptive escalation through the resilience ladder -----------------------


def test_topk_adaptive_records_ladder_trail():
    a = np.asarray(make_matrix(96, 64, kappa=1e4, seed=6))
    jcfg = JSP.TopKConfig(k=4, strategy="sketch", power_iters=0, tol=1e-10)
    jp, tp = _plans(jcfg, (96, 64))
    # tol=0 forces the dense fallback; it must run verified and leave
    # the rung trail in info
    u, s, vh, info = tp.topk_adaptive(torch.from_numpy(a.copy()), tol=0.0)
    *j, jinfo = jp.topk_adaptive(jnp.asarray(a), tol=0.0)
    # the pre-escalation residuals both miss tol = 0; their values differ
    # through sigma_max_power's start vector (the under-powered sketch's
    # s_1 sits below the power estimate that normalizes them)
    assert info["escalated"] and jinfo["escalated"]
    assert info["residual"] > 0.0 and jinfo["residual"] > 0.0
    assert [(t.rung, t.reason, t.outcome) for t in info["trail"]] == \
        [(t.rung, t.reason, t.outcome) for t in jinfo["trail"]]
    assert info["trail"][-1].outcome == "passed"
    _assert_triplets_agree((u, s, vh), j, a)
    s_ref = np.linalg.svd(a, compute_uv=False)
    np.testing.assert_allclose(s.numpy(), s_ref[:4], atol=1e-9)
    assert u.shape == (96, 4) and vh.shape == (4, 64)
    # a dense plan is exact: no check, no escalation
    dense = SP.plan_topk(SP.TopKConfig(k=4, strategy="dense", kappa=1e4),
                         (96, 64), torch.float64, device="cpu")
    assert dense.topk_adaptive(torch.from_numpy(a))[3] == {
        "escalated": False, "residual": None}


@pytest.mark.parametrize("batched", [False, True])
def test_lowrank_truncate_matches_reference(batched):
    mats = np.stack([np.asarray(make_matrix(96, 48, 1e4, seed=s))
                     for s in (21, 22)])
    g = mats if batched else mats[0]
    p_t, q_t = lowrank_truncate(torch.from_numpy(g.copy()), 6, kappa=1e4)
    p_j, q_j = JCP.lowrank_truncate(jnp.asarray(g), 6, kappa=1e4)
    assert p_t.shape == p_j.shape and q_t.shape == q_j.shape
    approx_t = (p_t @ q_t.mT).numpy().reshape(-1, 96, 48)
    approx_j = np.asarray(p_j @ jnp.swapaxes(q_j, -1, -2)).reshape(
        -1, 96, 48)
    for i, x in enumerate(g.reshape(-1, 96, 48)):
        u, s, vh = np.linalg.svd(x, full_matrices=False)
        best = (u[:, :6] * s[:6]) @ vh[:6]
        # each package's own draw: both within the residual-level
        # accuracy sqrt(tol) s_max that the configured tol = 1e-6 certifies
        for approx in (approx_t[i], approx_j[i]):
            assert np.linalg.norm(approx - best, 2) <= 1e-3 * s[0]
        # the reference test's Eckart-Young bound
        assert np.linalg.norm(x - approx_t[i], 2) <= \
            s[6] * (1 + 1e-6) + 1e-10 * s[0]


# --- plan surface ------------------------------------------------------------


def test_config_and_plan_validation():
    c1 = SP.TopKConfig(k=8, kappa=1e6)
    assert c1 == SP.TopKConfig(k=8, kappa=1e6) and hash(c1) == hash(
        SP.TopKConfig(k=8, kappa=1e6))
    assert c1.replace(k=4).k == 4 and c1.k == 8
    with pytest.raises(dataclasses.FrozenInstanceError):
        c1.k = 3
    for bad, exc in (({"k": 0}, ValueError), ({"strategy": "nope"},
                                               ValueError),
                     ({"sketch_kind": "nope"}, ValueError),
                     ({"svd": "auto"}, TypeError)):
        with pytest.raises(exc):
            SP.TopKConfig(**bad)
    with pytest.raises(TypeError):
        SP.plan_topk("not-a-config", (64, 32), device="cpu")
    with pytest.raises(ValueError):
        SP.plan_topk(SP.TopKConfig(k=8), (64, 32, 2), device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        SP.plan_topk(SP.TopKConfig(k=64), (128, 32), device="cpu")


def test_plan_cache_and_checks():
    SP.clear_topk_cache()
    stats0 = SP.topk_cache_stats()
    cfg = SP.TopKConfig(k=4, kappa=1e4, svd=SvdConfig(method="zolo"))
    p1 = SP.plan_topk(cfg, (96, 48), torch.float64, device="cpu")
    assert SP.plan_topk(SP.TopKConfig(k=4, kappa=1e4, svd=SvdConfig(
        method="zolo")), (96, 48), torch.float64, device="cpu") is p1
    assert SP.plan_topk(cfg, (96, 64), torch.float64, device="cpu") \
        is not p1
    stats1 = SP.topk_cache_stats()
    assert stats1["plan_misses"] == stats0["plan_misses"] + 2
    assert stats1["plan_hits"] == stats0["plan_hits"] + 1
    assert stats1["plans"] == 2
    assert SP.plan_topk(cfg, (96, 48), device="cpu").dtype == \
        torch.get_default_dtype()
    with pytest.raises(ValueError, match="per-shape"):
        p1.topk(torch.zeros((96, 64), dtype=torch.float64))
    with pytest.raises(ValueError, match="dtype"):
        p1.topk(torch.zeros((96, 48), dtype=torch.float32))
    with pytest.raises(ValueError, match="device"):
        p1.topk(torch.zeros((96, 48), dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="draws"):
        interop.with_draws(p1, probe=np.zeros((48, 12)))
    with pytest.raises(ValueError, match="shape"):
        interop.with_draws(p1, omega=np.zeros((48, 3)))
    # trace_count counts TopKPlan constructions: the two misses above
    assert SP.trace_count() >= 2
    traces = SP.trace_count()
    assert SP.plan_topk(cfg, (96, 48), torch.float64, device="cpu") is p1
    assert SP.trace_count() == traces
    assert SP.topk_cache_stats()["traces"] == traces
    assert p1.audit().ok
