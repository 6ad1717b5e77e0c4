"""repro_torch.models.{moe,ssm,rglru} against repro.models.

The reference's block weights (its ``*_init`` from a JAX key) are carried
into the port with ``interop.tree_from_numpy``; inputs are numpy draws
from a seed.  In f32:

* forwards (and the MoE aux loss) within FWD_TOL of max|out|;
* gradients (inputs and weights, through ``jax.grad`` and autograd)
  within GRAD_TOL of each leaf's max|grad|;
* the RG-LRU's log-depth scan sums in another order than
  ``jax.lax.associative_scan``: it is held to the same FWD_TOL (products
  of up to s gates in (0, 1), ~1e-6 measured) and to a sequential f64
  recurrence;
* streaming decode (one token at a time through the block's cache)
  against the full forward within STREAM_TOL (f32 sums in another order
  over a few dozen steps).

Ties in the router's top-k: ``jax.lax.top_k`` takes the lowest index
first; ``torch.topk`` does not promise an order (on the CPU it returns
[6, 5] for eight equal values), so the port selects by a stable
descending sort, and the tie test holds it to the reference's indices.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import rglru as JRGL  # noqa: E402
from repro.models import ssm as JSSD  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import interop, tree  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import rglru as RGL  # noqa: E402
from repro_torch.models import ssm as SSD  # noqa: E402

FWD_TOL = 1e-5     # max|err| / max|out|, f32
GRAD_TOL = 1e-4    # max|err| / max|grad| per leaf, f32
STREAM_TOL = 2e-5  # streaming decode against the forward, f32
INIT_TOL = 1e-5    # the deterministic init leaves, f32


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def _cfgs(arch, **overrides):
    return (dataclasses.replace(JC.get_smoke_config(arch), **overrides),
            dataclasses.replace(C.get_smoke_config(arch), **overrides))


def _weights(jinit, jcfg, seed):
    jp = jinit(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, interop.tree_from_numpy(jax.tree.map(np.asarray, jp))


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _grads_match(jfn, fn, jp, p, x):
    """jax.grad and autograd of sum(out^2) (+ aux) against each other,
    over the input and every weight."""
    jg = jax.jit(jax.grad(jfn, argnums=(0, 1)))(jp, jnp.asarray(x))
    names, leaves, tdef = tree.flatten_with_names(p)
    leaves = [t.clone().requires_grad_() for t in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    grads = torch.autograd.grad(fn(tree.unflatten(tdef, leaves), tx),
                                leaves + [tx])
    jleaves = jax.tree.leaves(jg[0]) + [jg[1]]
    assert len(jleaves) == len(grads)
    for name, a, g in zip(names + ["x"], jleaves, grads):
        assert tuple(g.shape) == a.shape, name
        assert _rel(a, g) < GRAD_TOL, name


# --- MoE --------------------------------------------------------------------


@pytest.mark.parametrize("arch,capacity_factor", [
    ("moonshot-v1-16b-a3b", 1.25), ("dbrx-132b", 1.25),
    ("moonshot-v1-16b-a3b", 0.25)])
def test_moe_apply_and_aux_loss_match_reference(arch, capacity_factor):
    """Forward, aux loss and gradients; capacity factor 0.25 drops
    tokens (capacity 8 for ~12 a expert)."""
    jcfg, cfg = _cfgs(arch, capacity_factor=capacity_factor)
    jp, p = _weights(JMOE.moe_init, jcfg, 0)
    rng = np.random.default_rng(1)
    x = _x(rng, 2, 24, cfg.d_model)
    jout, jaux = JMOE.moe_apply(jp, jnp.asarray(x), jcfg)
    out, aux = MOE.moe_apply(p, torch.from_numpy(x), cfg)
    assert out.dtype == torch.float32 and out.shape == jout.shape
    assert _rel(jout, out) < FWD_TOL
    assert float(aux) == pytest.approx(float(jaux), rel=FWD_TOL)
    assert MOE.moe_capacity(48, cfg) == JMOE.moe_capacity(48, jcfg)
    if capacity_factor < 1:
        # some slots were dropped: those tokens lose part of their output
        flat_e = np.asarray(jax.lax.top_k(jax.nn.softmax(
            jnp.asarray(x.reshape(-1, cfg.d_model)) @ jp["router"]),
            cfg.moe_top_k)[1]).reshape(-1)
        assert np.bincount(flat_e).max() > MOE.moe_capacity(48, cfg)

    def jfn(params, xx):
        o, a = JMOE.moe_apply(params, xx, jcfg)
        return jnp.sum(o ** 2) + a

    def fn(params, xx):
        o, a = MOE.moe_apply(params, xx, cfg)
        return torch.sum(o ** 2) + a

    _grads_match(jfn, fn, jp, p, x)


def test_router_ties_go_to_the_lowest_expert():
    """A zero router gives every expert the same probability: the
    reference's ``lax.top_k`` takes experts 0..k-1, and so does the port
    (``torch.topk`` would take others, see the module docstring)."""
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b")
    jp, p = _weights(JMOE.moe_init, jcfg, 2)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    probs = np.full((5, cfg.num_experts), 1.0 / cfg.num_experts, np.float32)
    jw, ji = jax.lax.top_k(jnp.asarray(probs), cfg.moe_top_k)
    w, i = MOE.top_k(torch.from_numpy(probs), cfg.moe_top_k)
    assert np.array_equal(np.asarray(ji), i.numpy())
    assert i.tolist()[0] == list(range(cfg.moe_top_k))
    assert np.array_equal(np.asarray(jw), w.numpy())
    x = _x(np.random.default_rng(3), 1, 16, cfg.d_model)
    jout, jaux = JMOE.moe_apply(jp, jnp.asarray(x), jcfg)
    out, aux = MOE.moe_apply(p, torch.from_numpy(x), cfg)
    assert _rel(jout, out) < FWD_TOL
    assert float(aux) == pytest.approx(float(jaux), rel=FWD_TOL)


# --- SSD --------------------------------------------------------------------


def _ssd_inputs(rng, bt, s, h, p, n):
    return (_x(rng, bt, s, h, p),
            (rng.random((bt, s, h)) * 0.5).astype(np.float32),
            (rng.random(h) * 2 + 0.5).astype(np.float32),
            _x(rng, bt, s, n), _x(rng, bt, s, n))


@pytest.mark.parametrize("s,chunk,init", [(32, 8, False), (40, 16, False),
                                          (37, 16, True), (16, 32, False)])
def test_ssd_scan_matches_reference(s, chunk, init):
    """Whole chunks, a padded last chunk (40 = 2.5 x 16, 37), one short
    chunk (16 < 32), and a carried-in state; forward and gradient."""
    rng = np.random.default_rng(s)
    bt, h, p, n = 2, 3, 4, 5
    args = _ssd_inputs(rng, bt, s, h, p, n)
    s0 = _x(rng, bt, h, p, n) if init else None
    jy, jst = JSSD.ssd_scan(*map(jnp.asarray, args), chunk,
                            init_state=None if s0 is None
                            else jnp.asarray(s0))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, st = SSD.ssd_scan(*ts, chunk, init_state=None if s0 is None
                         else torch.from_numpy(s0))
    assert y.shape == jy.shape and st.shape == jst.shape
    assert _rel(jy, y) < FWD_TOL and _rel(jst, st) < FWD_TOL

    def jfn(*a):
        yy, ss = JSSD.ssd_scan(*a, chunk)
        return jnp.sum(yy ** 2) + jnp.sum(ss ** 2)

    jg = jax.jit(jax.grad(jfn, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, args))
    yy, ss = SSD.ssd_scan(*ts, chunk)
    grads = torch.autograd.grad((yy ** 2).sum() + (ss ** 2).sum(), ts)
    for a, g in zip(jg, grads):
        assert np.isfinite(g.numpy()).all()
        assert _rel(a, g) < GRAD_TOL


@pytest.mark.parametrize("s", [24, 45])
def test_ssd_forward_matches_reference(s):
    """The full mixer (projections, causal conv, gated norm) on the
    mamba2 smoke config (chunk 32: 45 tokens pad the second chunk)."""
    jcfg, cfg = _cfgs("mamba2-130m")
    jp, p = _weights(JSSD.ssd_init, jcfg, 4)
    x = _x(np.random.default_rng(5), 2, s, cfg.d_model)
    jy, (jst, jtail) = JSSD.ssd_forward(jp, jnp.asarray(x), jcfg)
    y, (st, tail) = SSD.ssd_forward(p, torch.from_numpy(x), cfg)
    assert _rel(jy, y) < FWD_TOL
    assert _rel(jst, st) < FWD_TOL
    assert _rel(jtail, tail) < FWD_TOL

    def jfn(params, xx):
        return jnp.sum(JSSD.ssd_forward(params, xx, jcfg)[0] ** 2)

    def fn(params, xx):
        return torch.sum(SSD.ssd_forward(params, xx, cfg)[0] ** 2)

    _grads_match(jfn, fn, jp, p, x)


def test_ssd_decode_streaming_matches_forward():
    jcfg, cfg = _cfgs("mamba2-130m")
    _, p = _weights(JSSD.ssd_init, jcfg, 6)
    b, s = 2, 40
    x = torch.from_numpy(_x(np.random.default_rng(7), b, s, cfg.d_model))
    y_full, (st_full, tail_full) = SSD.ssd_forward(p, x, cfg)
    cache = SSD.init_ssd_cache(cfg, b, torch.float32, "cpu")
    ys = []
    for t in range(s):
        y, cache = SSD.ssd_decode(p, x[:, t:t + 1], cache, cfg)
        ys.append(y)
    assert _rel(y_full.detach(), torch.cat(ys, dim=1)) < STREAM_TOL
    assert _rel(st_full.detach(), cache[0]) < STREAM_TOL
    assert _rel(tail_full.detach(), cache[1]) < STREAM_TOL


# --- RG-LRU -----------------------------------------------------------------


def test_linear_scan_matches_a_sequential_recurrence():
    rng = np.random.default_rng(8)
    for s in (1, 2, 7, 64, 100):
        a = rng.uniform(0.5, 1.0, (2, s, 3))
        b = rng.standard_normal((2, s, 3))
        h, prod = np.zeros((2, 3)), np.ones((2, 3))
        hs, ps = [], []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            prod = prod * a[:, t]
            hs.append(h)
            ps.append(prod)
        av, bv = RGL.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(bv.numpy(), np.stack(hs, 1), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(av.numpy(), np.stack(ps, 1), rtol=1e-12)


@pytest.mark.parametrize("s,init", [(20, False), (50, True)])
def test_rglru_forward_matches_reference(s, init):
    jcfg, cfg = _cfgs("recurrentgemma-2b")
    jp, p = _weights(JRGL.rglru_init, jcfg, 9)
    rng = np.random.default_rng(10)
    x = _x(rng, 2, s, cfg.d_model)
    s0 = _x(rng, 2, cfg.rnn_width) if init else None
    jy, (jst, jtail) = JRGL.rglru_forward(
        jp, jnp.asarray(x), jcfg,
        init_state=None if s0 is None else jnp.asarray(s0))
    y, (st, tail) = RGL.rglru_forward(
        p, torch.from_numpy(x), cfg,
        init_state=None if s0 is None else torch.from_numpy(s0))
    assert st.dtype == torch.float32
    assert _rel(jy, y) < FWD_TOL and _rel(jst, st) < FWD_TOL
    assert _rel(jtail, tail) < FWD_TOL

    def jfn(params, xx):
        return jnp.sum(JRGL.rglru_forward(params, xx, jcfg)[0] ** 2)

    def fn(params, xx):
        return torch.sum(RGL.rglru_forward(params, xx, cfg)[0] ** 2)

    _grads_match(jfn, fn, jp, p, x)


def test_rglru_decode_streaming_matches_forward():
    jcfg, cfg = _cfgs("recurrentgemma-2b")
    _, p = _weights(JRGL.rglru_init, jcfg, 11)
    b, s = 2, 40
    x = torch.from_numpy(_x(np.random.default_rng(12), b, s, cfg.d_model))
    y_full, (st_full, tail_full) = RGL.rglru_forward(p, x, cfg)
    cache = RGL.init_rglru_cache(cfg, b, torch.float32, "cpu")
    ys = []
    for t in range(s):
        y, cache = RGL.rglru_decode(p, x[:, t:t + 1], cache, cfg)
        ys.append(y)
    assert _rel(y_full.detach(), torch.cat(ys, dim=1)) < STREAM_TOL
    assert _rel(st_full.detach(), cache[0]) < STREAM_TOL
    assert _rel(tail_full.detach(), cache[1]) < STREAM_TOL


@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_block_init_draws_the_reference_layout(kind):
    """The port's own initializers give the reference's leaves: names,
    shapes, dtypes, and the deterministic leaves' values (f32 log,
    expm1 and linspace in two libraries: a few ulps, INIT_TOL)."""
    arch = "mamba2-130m" if kind == "ssd" else "recurrentgemma-2b"
    jcfg, cfg = _cfgs(arch, dtype="bfloat16")
    jinit = JSSD.ssd_init if kind == "ssd" else JRGL.rglru_init
    init = SSD.ssd_init if kind == "ssd" else RGL.rglru_init
    jp = jinit(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    p = init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert sorted(p) == sorted(jp)
    for k in jp:
        assert tuple(p[k].shape) == jp[k].shape, k
        assert str(p[k].dtype).split(".")[-1] == str(jp[k].dtype), k
    for k in ("a_log", "d_skip", "dt_bias", "norm_scale", "lam"):
        if k in jp:
            assert _rel(jp[k], p[k]) < INIT_TOL, k
