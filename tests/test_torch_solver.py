"""repro_torch.solver plans against repro.solver plans.

The reference's plan state (config, schedule, power-iteration start
vector) is carried into the port through ``repro_torch.interop``, so both
compute the same thing on the same numpy input.  Compared are invariants,
never raw singular-vector signs: singular values, U diag(s) Vh,
orthogonality and the polar factor Q.
"""

import dataclasses

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

F64_TOL = 1e-12


def _reference_state(jplan, jdtype):
    """The reference plan's schedule and start vector, as numpy."""
    sched = jplan.schedule
    arrays = [np.array([it.c for it in sched]),
              np.array([it.a for it in sched]),
              np.array([it.mhat for it in sched]),
              np.array([it.l_before for it in sched]),
              np.array([it.l_after for it in sched])]
    n = min(jplan.shape)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,), jdtype))
    return interop.schedule_from_arrays(*arrays), v0


def _port_plan(jcfg, shape, tdtype, jplan, jdtype):
    cfg = interop.svd_config_from_dict(dataclasses.asdict(jcfg))
    p = S.plan(cfg, shape, tdtype, device="cpu")
    sched, v0 = _reference_state(jplan, jdtype)
    assert sched == tuple(p.schedule)  # same f64 schedule, bit for bit
    return interop.with_state(p, schedule=sched, start_vector=v0)


def _rel(x, y, scale):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                               - np.asarray(y, np.float64)))) / scale


@pytest.mark.parametrize("shape", [(72, 48), (48, 48), (40, 64)])
def test_f64_zolo_static_svd_matches_reference(shape):
    a = np.asarray(make_matrix(*shape, 1e3, seed=7)) * 2.5
    jcfg = JS.SvdConfig(method="zolo_static", kappa=1e3,
                        l0_policy="estimate_at_plan")
    jp = JS.plan(jcfg, shape, jnp.float64)
    tp = _port_plan(jcfg, shape, torch.float64, jp, jnp.float64)
    u_j, s_j, vh_j = (np.asarray(x) for x in jp.svd(jnp.asarray(a)))
    u_t, s_t, vh_t = (x.numpy() for x in tp.svd(torch.from_numpy(a.copy())))
    smax = float(s_j[0])
    assert u_t.shape == u_j.shape and vh_t.shape == vh_j.shape
    assert _rel(s_t, s_j, smax) <= F64_TOL
    assert _rel((u_t * s_t) @ vh_t, (u_j * s_j) @ vh_j, smax) <= F64_TOL
    for x in (u_t, vh_t.T):
        assert float(tsvd.orthogonality(torch.from_numpy(x))) <= 1e-14
    q_j, h_j, _ = jp.polar(jnp.asarray(a))
    q_t, h_t, _ = tp.polar(torch.from_numpy(a.copy()))
    assert _rel(q_t.numpy(), q_j, 1.0) <= F64_TOL
    assert _rel(h_t.numpy(), h_j, smax) <= F64_TOL


def test_f32_zolo_cuda_plain_matches_pallas_interpret():
    # zolo_cuda on CPU tensors runs the kernels' plain versions; the JAX
    # zolo_pallas runs its Pallas kernels in interpret mode.  Bounds are
    # the repo's own f32 kernel bounds (tests/test_kernels.py).
    kappa = 1e3
    shape = (96, 64)
    a = np.asarray(make_matrix(*shape, kappa, seed=5), np.float32)
    jcfg = JS.SvdConfig(method="zolo_pallas", kappa=kappa, r=2,
                        l0_policy="estimate_at_plan")
    jp = JS.plan(jcfg, shape, jnp.float32)
    tp = _port_plan(jcfg, shape, torch.float32, jp, jnp.float32)
    assert tp.method == "zolo_cuda"
    u_j, s_j, vh_j = (np.asarray(x) for x in jp.svd(jnp.asarray(a)))
    u_t, s_t, vh_t = tp.svd(torch.from_numpy(a.copy()))
    assert s_t.dtype == torch.float32
    assert _rel(s_t.numpy(), s_j, 1.0) <= 5e-5
    for x in (u_t, vh_t.mT):
        assert float(tsvd.orthogonality(x.double())) < 5e-6
    q_j, _, _ = jp.polar(jnp.asarray(a), want_h=False)
    q_t, _, _ = tp.polar(torch.from_numpy(a.copy()), want_h=False)
    assert _rel(q_t.numpy(), q_j, 1.0) <= 5e-5


def test_wide_polar_reconstructs():
    a = torch.from_numpy(np.array(make_matrix(24, 40, 1e2, seed=8)))
    p = S.plan(S.SvdConfig(method="zolo_static", kappa=1e2,
                           l0_policy="estimate_at_plan"),
               a.shape, a.dtype, device="cpu")
    q, h, info = p.polar(a)
    assert q.shape == (24, 40) and h.shape == (40, 40)
    torch.testing.assert_close(q @ h, a, rtol=0, atol=1e-12)
    torch.testing.assert_close(h, h.mT, rtol=0, atol=1e-13)
    assert int(info.iterations) == len(p.schedule)


def test_plan_cache_hits_and_pins():
    cfg = S.SvdConfig(method="zolo_static", kappa=50.0,
                      l0_policy="estimate_at_plan", r=2)
    p = S.plan(cfg, (12, 8), torch.float64, device="cpu")
    before = S.cache_stats()
    traces = S.trace_count()
    assert S.plan(cfg, (12, 8), torch.float64, device="cpu") is p
    after = S.cache_stats()
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]
    # trace_count counts plan constructions: a hit builds nothing
    assert S.trace_count() == traces == S.plan_cache_stats()["traces"]
    S.pin(p)
    assert S.cache_stats()["pinned"] >= 1
    S.unpin(p)
    other = S.plan(cfg, (12, 8), torch.float32, device="cpu")
    assert other is not p
    assert S.trace_count() == traces + 1


def test_plan_defaults_to_the_card():
    cfg = S.SvdConfig(method="zolo_static", l0=0.1)
    if torch.cuda.is_available():
        assert S.plan(cfg, (8, 8), torch.float32).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            S.plan(cfg, (8, 8), torch.float32)


def test_auto_and_cuda_pricing_on_cpu():
    cfg = S.SvdConfig(kappa=1e3, l0_policy="estimate_at_plan")
    p = S.plan(cfg, (32, 16), torch.float32, device="cpu")
    # the reference's pick (test_auto_picks_the_reference_method): QDWH's
    # 4 iterations cost fewer flops than Zolo's 3 at r = 2; zolo_cuda is
    # priced +inf on CPU
    assert p.method == "qdwh_static"
    cuda_cfg = cfg.replace(method="zolo_cuda")
    price = {name: registry.get_polar(name).flops_fn(
        32, 16, r=2, kappa=1e3, dtype=torch.float32, device=dev)
        for name in ("zolo_cuda", "zolo_static", "qdwh_static", "newton")
        for dev in (torch.device("cpu"),)}
    assert price["zolo_cuda"] == float("inf")
    assert np.isfinite(price["zolo_static"])
    assert price["qdwh_static"] < price["zolo_static"]
    assert price["newton"] == float("inf")  # not square
    assert p.flops_estimate() == price["qdwh_static"]
    assert np.isfinite(registry.get_polar("zolo_cuda").flops_fn(
        32, 16, r=2, kappa=1e3, dtype=torch.float32,
        device=torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="zolo_static"):
        S.plan(cuda_cfg, (32, 16), torch.float64, device="cpu")
    with pytest.raises(ValueError, match="envelope"):
        S.plan(cuda_cfg.replace(kappa=10 * tsvd.CUDA_F32_KAPPA_MAX),
               (32, 16), torch.float32, device="cpu")


def test_not_yet_ported_values_raise():
    # the dynamic and grouped slices are ported: these configure, they do
    # not raise (a grouped plan needs a mesh: tests/test_torch_grouped.py)
    assert S.SvdConfig(mode="dynamic", l0_policy="runtime").mode == \
        "dynamic"
    assert S.SvdConfig(mode="grouped").mode == "grouped"
    with pytest.raises(ValueError, match="mode="):
        S.SvdConfig(mode="bogus")
    p = S.plan(S.SvdConfig(method="zolo_static", l0=0.1), (8, 8),
               torch.float64, device="cpu")
    # the plan audit is ported (tests/test_torch_analysis.py): it runs
    rep = p.audit()
    assert rep.ok and rep.host_syncs == 0 and rep.psum_counts == {}
    # svd_verified is ported (tests/test_torch_resilience.py): it runs
    u, s, vh, health = p.svd_verified(torch.eye(8, dtype=torch.float64))
    assert bool(health.finite) and torch.equal(s, p.svd(
        torch.eye(8, dtype=torch.float64))[1])
    with pytest.raises(ValueError, match="shape"):
        p.svd(torch.eye(7, dtype=torch.float64))
    with pytest.raises(ValueError, match="unknown SvdConfig"):
        interop.svd_config_from_dict({"bogus": 1})


def test_batched_matches_one_at_a_time():
    rng = np.random.default_rng(9)
    stack = np.stack([np.asarray(make_matrix(20, 12, 30.0, seed=s))
                      for s in range(3)]) * rng.uniform(0.5, 2.0)
    cfg = S.SvdConfig(method="zolo_static", kappa=30.0,
                      l0_policy="estimate_at_plan")
    p = S.plan(cfg, (20, 12), torch.float64, device="cpu")
    t = torch.from_numpy(stack.reshape(1, 3, 20, 12))
    u, s, vh = p.svd_batched(t)
    assert u.shape == (1, 3, 20, 12) and s.shape == (1, 3, 12)
    q, h, info = p.polar_batched(t)
    assert q.shape == (1, 3, 20, 12) and info.iterations.shape == (1, 3)
    for i in range(3):
        u1, s1, vh1 = p.svd(t[0, i])
        torch.testing.assert_close(s[0, i], s1, rtol=0, atol=1e-14)
        torch.testing.assert_close(u[0, i] * s[0, i] @ vh[0, i],
                                   u1 * s1 @ vh1, rtol=0, atol=1e-13)


# --- registrations, auto, and the one-call wrappers ---------------------------


def _reference_single_device(names, get):
    """The reference's registered names that run without a mesh, under
    the port's names."""
    return sorted(interop.METHOD_NAMES.get(n, n) for n in names
                  if not getattr(get(n), "requires_mesh", False))


def test_registered_names_equal_the_reference_single_device_ones():
    from repro.core import registry as jregistry

    single = [n for n in registry.list_polar()
              if not registry.get_polar(n).requires_mesh]
    assert single == _reference_single_device(
        jregistry.list_polar(), jregistry.get_polar)
    assert registry.list_eig() == jregistry.list_eig() == ["eigh",
                                                           "jacobi"]
    for name in ("qdwh", "qdwh_static", "newton"):
        spec, jspec = registry.get_polar(name), jregistry.get_polar(name)
        assert (spec.dynamic, spec.baseline, spec.is_oracle) == \
            (jspec.dynamic, jspec.baseline, jspec.is_oracle)


@pytest.mark.parametrize("policy", ["estimate_at_plan", "runtime"])
@pytest.mark.parametrize("shape", [(64, 48), (96, 96), (200, 40)])
def test_auto_picks_the_reference_method(shape, policy):
    # the reference's auto on the CPU (zolo_pallas priced x1e3 off-TPU,
    # zolo_cuda +inf on a CPU device) over a kappa grid: every pick equal.
    # The reference's choice comes from its resolution step, which builds
    # no plan: its plan cache (walked by its own audit) stays as it was.
    from repro.solver import planner as jplanner

    for kappa in (1.5, 10.0, 1e2, 1e4, 1e6, 1e8, 1e10, 1e14):
        for tdt, jdt in ((torch.float64, jnp.float64),
                         (torch.float32, jnp.float32)):
            jcfg = JS.SvdConfig(kappa=kappa, l0_policy=policy)
            want = jplanner._resolve(jcfg, shape, jdt, None)[0].name
            got = S.plan(interop.svd_config_from_dict(
                dataclasses.asdict(jcfg)), shape, tdt, device="cpu").method
            assert got == interop.METHOD_NAMES.get(want, want), \
                (kappa, tdt, want, got)


def _invariants(a, q, h, tol):
    m, n = a.shape
    assert q.shape == (m, n) and h.shape == (n, n)
    torch.testing.assert_close(q @ h, a, rtol=0, atol=tol)
    torch.testing.assert_close(h, h.mT, rtol=0, atol=tol)
    k = min(m, n)
    g = q @ q.mT if m < n else q.mT @ q
    assert float((g - torch.eye(k, dtype=a.dtype)).abs().max()) < tol


@pytest.mark.parametrize("method", ["zolo", "qdwh", "zolo_static",
                                    "qdwh_static", "zolo_cuda_dynamic"])
@pytest.mark.parametrize("shape", [(56, 40), (40, 40), (40, 56)])
def test_polar_decompose_matches_reference(shape, method):
    from repro.core import svd as jsvd

    a = np.asarray(make_matrix(*shape, 1e3, seed=12))
    kw = {"l0": 0.9e-3} if method.endswith("static") else {}
    dt = torch.float32 if "cuda" in method else torch.float64
    a_t = torch.from_numpy(a.astype(np.float32) if "cuda" in method
                           else a.copy())
    q, h, info = tsvd.polar_decompose(a_t, method=method, want_h=True,
                                      **kw)
    if "cuda" in method:
        # the reference's counterpart backend itself, in the canonical
        # orientation the wrapper hands it (an f32 plan in the
        # reference's cache would carry an f64 equation its own audit
        # flags: ROADMAP Queue C)
        from repro.core import zolo as jzolo
        from repro.core import zolo_pallas as jzolo_pallas

        jw, transposed = jzolo.polar_canonical(jnp.asarray(a_t.numpy()))
        q_j, h_j, info_j = jzolo_pallas.zolo_pd_pallas_dynamic(
            jw, want_h=True)
        if transposed:
            h_j = q_j @ h_j @ q_j.T
            q_j = q_j.T
    else:
        q_j, h_j, info_j = jsvd.polar_decompose(
            jnp.asarray(a_t.numpy()), method=method, want_h=True, **kw)
    tol = 1e-12 if dt == torch.float64 else 5e-5
    assert q.dtype == dt
    _invariants(a_t, q, h, tol if dt == torch.float64 else 1e-4)
    assert _rel(q.numpy(), q_j, 1.0) <= tol
    assert _rel(h.numpy(), h_j, 1.0) <= (tol if dt == torch.float64
                                         else 1e-4)
    assert int(info.iterations) == int(info_j.iterations)
    # the wrapper's plan is the one plan() builds for the same knobs
    p, runtime = S.plan_for_call(shape, a_t.dtype, method=method,
                                 device="cpu", kw=dict(kw, want_h=False))
    assert runtime == {"want_h": False} and p.config.scale == "none"
    assert S.plan(p.config, shape, a_t.dtype, device="cpu") is p


@pytest.mark.parametrize("shape,method,eig_method", [
    (shape, method, eig) for shape in ((56, 40), (48, 48), (40, 56))
    for method, eig in (("zolo", "eigh"), ("qdwh", "jacobi"),
                        ("zolo_static", "jacobi"))] + [
    ((48, 48), "newton", "eigh"), ((48, 48), "newton", "jacobi")])
def test_polar_svd_matches_reference(shape, method, eig_method):
    from repro.core import svd as jsvd

    a = np.asarray(make_matrix(*shape, 1e4, seed=13))
    kw = {"l0": 0.9e-4} if method.endswith("static") else {}
    u, s, vh = tsvd.polar_svd(torch.from_numpy(a.copy()), method=method,
                              eig_method=eig_method, nb=8, **kw)
    _, s_j, _ = jsvd.polar_svd(jnp.asarray(a), method=method,
                               eig_method=eig_method, nb=8, **kw)
    k = min(shape)
    assert u.shape == (shape[0], k) and vh.shape == (k, shape[1])
    assert float(np.abs(s.numpy() - np.asarray(s_j)).max()) <= F64_TOL
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(
        a, compute_uv=False), rtol=0, atol=F64_TOL)
    assert float(tsvd.orthogonality(u)) < F64_TOL
    assert float(tsvd.orthogonality(vh.mT)) < F64_TOL
    torch.testing.assert_close((u * s) @ vh, torch.from_numpy(a), rtol=0,
                               atol=1e-11)


def test_wrapper_misuse_names_the_value():
    a = torch.from_numpy(np.asarray(make_matrix(24, 16, 10.0, seed=1)))
    with pytest.raises(ValueError, match="'bogus'"):
        tsvd.polar_decompose(a, method="bogus")
    with pytest.raises(ValueError, match="'bogus_eig'"):
        tsvd.polar_svd(a, eig_method="bogus_eig")
    with pytest.raises(ValueError, match=r"\(24, 16\)"):
        tsvd.polar_decompose(a, method="newton")
    with pytest.raises(ValueError, match=r"\(24, 16\)"):
        tsvd.polar_svd(a.mT, method="newton")  # canonical: tall again
    with pytest.raises(ValueError, match="l0"):
        tsvd.polar_decompose(a, method="qdwh_static")
    import repro_torch

    assert repro_torch.polar_svd is tsvd.polar_svd
    assert repro_torch.polar_decompose is tsvd.polar_decompose
