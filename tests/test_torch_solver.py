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
    assert S.plan(cfg, (12, 8), torch.float64, device="cpu") is p
    after = S.cache_stats()
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]
    S.pin(p)
    assert S.cache_stats()["pinned"] >= 1
    S.unpin(p)
    other = S.plan(cfg, (12, 8), torch.float32, device="cpu")
    assert other is not p


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
    assert p.method == "zolo_static"  # zolo_cuda is priced +inf on CPU
    cuda_cfg = cfg.replace(method="zolo_cuda")
    price = {name: registry.get_polar(name).flops_fn(
        32, 16, r=2, kappa=1e3, dtype=torch.float32, device=dev)
        for name in ("zolo_cuda", "zolo_static")
        for dev in (torch.device("cpu"),)}
    assert price["zolo_cuda"] == float("inf")
    assert np.isfinite(price["zolo_static"])
    assert np.isfinite(registry.get_polar("zolo_cuda").flops_fn(
        32, 16, r=2, kappa=1e3, dtype=torch.float32,
        device=torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="zolo_static"):
        S.plan(cuda_cfg, (32, 16), torch.float64, device="cpu")
    with pytest.raises(ValueError, match="envelope"):
        S.plan(cuda_cfg.replace(kappa=1e5), (32, 16), torch.float32,
               device="cpu")


def test_not_yet_ported_values_raise():
    for kw in ({"mode": "dynamic"}, {"mode": "grouped"},
               {"l0_policy": "runtime"}, {"compute_dtype": "bfloat16"}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            S.SvdConfig(**kw)
    with pytest.raises(ValueError, match="mode="):
        S.SvdConfig(mode="bogus")
    p = S.plan(S.SvdConfig(method="zolo_static", l0=0.1), (8, 8),
               torch.float64, device="cpu")
    with pytest.raises(NotImplementedError):
        p.audit()
    with pytest.raises(NotImplementedError):
        p.svd_verified(torch.eye(8, dtype=torch.float64))
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
