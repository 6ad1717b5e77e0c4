"""repro_torch.optim (ZoloMuon, the LR schedule) against repro.optim.

``orthogonalize`` runs the port's plans on the CPU, where ``zolo_cuda``
runs the kernels' plain versions, against the reference's ``zolo_static``
plans (and ``qdwh_static``, and Newton-Schulz).  The fixture
``reference_draws`` binds the reference's prescale start vector (a JAX
normal draw from key 0) to every Muon plan, so the two packages scale by
the same power-iteration estimate; what remains between them is f32
rounding and the port's first-pass ridge in CholeskyQR2 (ROADMAP Queue
C), held to Q_TOL.  Against numpy's U Vᵀ both are held to the
reference's own tolerance (``tests/test_optim.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import muon as JMU  # noqa: E402
from repro.optim.schedule import warmup_cosine as jwarmup  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import interop, tree  # noqa: E402
from repro_torch.optim import muon as MU  # noqa: E402
from repro_torch.optim import warmup_cosine  # noqa: E402

# max|Q_port - Q_ref| for zolo/qdwh on the same start vector: f32
# rounding over ~3-6 iterations and the first-pass ridge (~1e-6 seen)
Q_TOL = 2e-5
NS5_TOL = 1e-5   # the same f32 products in another order
# the reference's own tolerance against numpy's U V^T (tests/test_optim.py)
MSIGN_TOL = {"zolo": 2e-3, "qdwh": 2e-3, "ns5": 0.35}
UPDATE_TOL = 2e-5  # a ZoloMuon update, relative to max|param|


@pytest.fixture(scope="module", autouse=True)
def _restore_reference_caches():
    """Leave the reference's plan caches as this module found them (the
    reference's Muon plans are also kept by its own lru_cache)."""
    from repro.solver import planner as jplanner
    from repro.spectral import topk as jtopk

    before = dict(jplanner._PLANS), dict(jtopk._TOPK_PLANS)
    yield
    for cache, saved in zip((jplanner._PLANS, jtopk._TOPK_PLANS), before):
        cache.clear()
        cache.update(saved)


def reference_v0(rows, cols, dtype=jnp.float32):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                        (min(rows, cols),), dtype))


@pytest.fixture
def reference_draws(monkeypatch):
    """Every Muon plan of the port bound to the reference's start
    vector (an uncached copy of the cached plan)."""
    real = MU._polar_plan

    def bound(method, rows, cols, *args):
        return interop.with_state(real(method, rows, cols, *args),
                                  start_vector=reference_v0(rows, cols))

    monkeypatch.setattr(MU, "_polar_plan", bound)


@pytest.mark.parametrize("method", ["zolo", "qdwh", "ns5"])
@pytest.mark.parametrize("shape", [(64, 64), (96, 48), (48, 96),
                                   (3, 64, 80)])
def test_orthogonalize_matches_reference_and_msign(method, shape, rng,
                                                   reference_draws):
    m = rng.standard_normal(shape).astype(np.float32)
    jo = np.asarray(JMU.orthogonalize(jnp.asarray(m), method=method))
    o = MU.orthogonalize(torch.from_numpy(m), method=method)
    assert o.dtype == torch.float32 and tuple(o.shape) == shape
    o = o.numpy()
    tol = NS5_TOL if method == "ns5" else Q_TOL
    np.testing.assert_allclose(o, jo, atol=tol, rtol=0)
    m2 = m.astype(np.float64).reshape(-1, *shape[-2:])
    for mm, oo in zip(m2, o.astype(np.float64).reshape(-1, *shape[-2:])):
        u, _, vt = np.linalg.svd(mm, full_matrices=False)
        np.testing.assert_allclose(oo, u @ vt, atol=MSIGN_TOL[method])


def test_zolo_tighter_than_ns5(rng):
    m = torch.from_numpy(rng.standard_normal((128, 96)).astype(np.float32))

    def orth_err(o):
        g = (o.mT @ o).double().numpy()
        return np.abs(g - np.eye(96)).max()

    assert orth_err(MU.orthogonalize(m, "zolo")) < \
        orth_err(MU.orthogonalize(m, "ns5"))


def test_polar_backend_follows_the_dtype():
    """zolo_cuda (K1/K2; their plain versions on a CPU iterate) for
    itemsize <= 4, zolo_static for f64; the plan cache keys the device."""
    assert MU.polar_method("zolo", "float32") == "zolo_cuda"
    assert MU.polar_method("zolo", "bfloat16") == "zolo_cuda"
    assert MU.polar_method("zolo", "float64") == "zolo_static"
    assert MU.polar_method("qdwh", "float32") == "qdwh_static"
    with pytest.raises(ValueError, match="ns5"):
        MU.polar_method("ns5", "float32")
    p32 = MU._polar_plan("zolo", 64, 48, 2, 1e-3, 4, "float32", "cpu")
    p64 = MU._polar_plan("zolo", 64, 48, 2, 1e-3, 4, "float64", "cpu")
    assert (p32.method, p64.method) == ("zolo_cuda", "zolo_static")
    assert p32.device == torch.device("cpu")
    assert p32 is MU._polar_plan("zolo", 64, 48, 2, 1e-3, 4, "float32",
                                 "cpu")
    # the reference's Muon schedule: r = 2 from l0 = 1e-3, 3 iterations
    jp = JMU._polar_plan("zolo", 64, 48, 2, 1e-3, 4, "float32")
    assert (p32.r, len(p32.schedule)) == (jp.r, len(jp.schedule)) == (2, 3)
    assert p32.config.qr_mode == "cholqr2" and p32.config.scale == "power"
    # f64 momentum: the plain engine (computing in f32, as the
    # reference's compute_dtype says), against the reference
    m = np.random.default_rng(2).standard_normal((64, 48))
    jo = np.asarray(JMU.orthogonalize(jnp.asarray(m), polar_dtype="float64"))
    plan = interop.with_state(p64, start_vector=reference_v0(
        64, 48, jnp.float64))
    q, _, _ = plan.polar_batched(torch.from_numpy(m)[None], want_h=False)
    assert q.dtype == torch.float64
    np.testing.assert_allclose(q[0].numpy(), jo, atol=Q_TOL, rtol=0)


def test_bf16_polar_dtype_rounds_only_the_momentum(rng, reference_draws):
    m = rng.standard_normal((2, 64, 48)).astype(np.float32)
    jo = np.asarray(JMU.orthogonalize(jnp.asarray(m),
                                      polar_dtype="bfloat16"))
    o = MU.orthogonalize(torch.from_numpy(m), polar_dtype="bfloat16")
    assert o.dtype == torch.float32
    # both return a bf16 polar factor cast up: within one bf16 ulp of 1
    np.testing.assert_allclose(o.numpy(), jo, atol=2.0 ** -8, rtol=0)


def test_muon_labels_match_reference():
    for arch in ("qwen3-8b", "olmo-1b", "musicgen-large"):
        jcfg, cfg = JC.get_smoke_config(arch), C.get_smoke_config(arch)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        p = interop.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)
        for min_dim in (16, 64):
            jl = jax.tree.leaves(JMU.muon_labels(jp, min_dim=min_dim))
            names, labels, _ = tree.flatten_with_names(
                MU.muon_labels(p, min_dim=min_dim))
            assert labels == [bool(x) for x in jl], (arch, min_dim)
    by_name = dict(zip(names, labels))
    assert by_name["embed"] is False and by_name["lm_head"] is False
    assert by_name["stages/0/mixer/wq"] is True
    assert all(not v for k, v in by_name.items() if "norm" in k)


def test_muon_step_descends(rng):
    """ZoloMuon on a quadratic (the reference's case, tests/test_optim.py):
    strong descent, fixed-spectral-norm steps."""
    w_true = torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    y = x @ w_true
    params = {"w": torch.zeros((64, 64))}

    def loss_fn(p):
        return torch.mean((x @ p["w"] - y) ** 2)

    opt = MU.ZoloMuon(MU.MuonConfig(lr=0.3, method="zolo"),
                      MU.muon_labels(params))
    state = opt.init(params)
    losses = []
    for _ in range(40):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(loss_fn({"w": w}), [w])
        params, state = opt.update({"w": g}, state, params)
        losses.append(float(loss_fn(params)))
    assert min(losses) < 0.2 * losses[0]
    assert losses[-1] < 0.5 * losses[0]


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_zolo_muon_update_matches_reference(weight_decay, reference_draws):
    """One update of every leaf kind (Muon on stacked matrices, AdamW on
    embed / lm_head / norms / narrow matrices) from the same momentum."""
    jcfg, cfg = JC.get_smoke_config("qwen3-8b"), C.get_smoke_config(
        "qwen3-8b")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    jg = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape), jnp.float32), jp)
    mcfg = dict(weight_decay=weight_decay)
    jopt = JMU.ZoloMuon(JMU.MuonConfig(**mcfg), JMU.muon_labels(jp))
    jstate = jopt.init(jp)
    jstate["mu"] = jax.tree.map(lambda g: 0.5 * g, jg)
    jnew, jst = jopt.update(jg, jstate, jp, lr_scale=0.7)

    to_t = lambda t: interop.tree_from_numpy(jax.tree.map(np.asarray, t))
    p, g = to_t(jp), to_t(jg)
    opt = MU.ZoloMuon(MU.MuonConfig(**mcfg), MU.muon_labels(p))
    state = opt.init(p)
    state["mu"] = tree.map(lambda t: 0.5 * t, g)
    new, st = opt.update(g, state, p, lr_scale=torch.tensor(0.7))
    assert int(st["count"]) == int(jst["count"]) == 1
    for want, got in ((jnew, new), (jst["mu"], st["mu"]),
                      (jst["nu"], st["nu"])):
        names, leaves, _ = tree.flatten_with_names(got)
        for name, a, b in zip(names, jax.tree.leaves(want), leaves):
            a = np.asarray(a, np.float64)
            scale = max(np.abs(a).max(), 1e-30)
            assert np.abs(a - b.double().numpy()).max() / scale < \
                UPDATE_TOL, name


def test_warmup_cosine_matches_reference():
    for step in (0, 1, 5, 50, 99, 100, 101, 5000, 10_000, 12_000):
        for warmup in (1, 100):
            want = float(jwarmup(jnp.int32(step), warmup=warmup))
            got = warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                warmup=warmup)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7)
    # step 0 gives 0 for any warmup, as in the reference
    assert float(warmup_cosine(0, warmup=1)) == 0.0
