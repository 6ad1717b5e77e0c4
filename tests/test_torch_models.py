"""repro_torch.models (the LM forward) against repro.models.

The reference's weights (``init_params`` from a JAX key) are carried into
the port with ``interop.model_params_from_numpy``, the batches come from
both registries' ``input_specs`` (the same numpy draws), and:

* logits and the chunked loss agree within FWD_TOL of max|logits| (f32
  smoke configs: f32 sums over d = 64 and the 512-token chunks, ~1e-6
  measured);
* gradients agree with ``jax.grad`` within GRAD_TOL of each leaf's max
  |grad| (the same f32 sums through the backward pass).

Every arch's SMOKE config is covered: olmo-1b (non-parametric
LayerNorm), qwen3-8b (qk-norm), yi-34b, h2o-danube-3-4b (sliding
window), musicgen-large (GELU), pixtral-12b (prefix embeds), mamba2-130m
(SSD, no MLP, tied embeddings), recurrentgemma-2b (RG-LRU + local
attention, a remainder of unstacked layers, softcapped logits),
dbrx-132b and moonshot-v1-16b-a3b (MoE, whose aux loss enters the loss
with the train step's weight).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import attention as JATT  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import ShapeConfig  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import interop, tree  # noqa: E402
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import step as S  # noqa: E402

ARCHS = tuple(C.list_archs())
AUX_WEIGHT = 0.01  # the train step's default weight of the MoE aux loss
FWD_TOL = 1e-5    # max|err| / max|logits|, f32
GRAD_TOL = 1e-4   # max|err| / max|grad| per leaf, f32
LAYER_TOL = 1e-6  # elementwise layers, f32, relative to max|out|
# a bf16 forward: products rounded to bf16 (2^-8 relative) through 3
# layers, against max|logits|
BF16_TOL = 5e-2
SHAPE = ShapeConfig("train_smoke", "train", 48, 2)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def _names(jtree):
    """The reference's leaf names (``checkpoint.manager._tree_paths``)."""
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]


def _pair(arch, seed=0, **overrides):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = dataclasses.replace(JC.get_smoke_config(arch), **overrides)
    cfg = dataclasses.replace(C.get_smoke_config(arch), **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    p = interop.model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, cfg, jp, p


def _batches(jcfg, cfg, shape=SHAPE, seed=1):
    jb = JC.input_specs(jcfg, shape, abstract=False, seed=seed)
    b = C.input_specs(cfg, shape, abstract=False, seed=seed)
    return jb, b


def _loss_pair(jcfg, cfg):
    """The train step's loss (cross entropy + the weighted aux loss) on
    given params, in each package."""

    def jloss(params, batch):
        x, aux = JM.hidden_states(params, batch, jcfg)
        w = params["embed"].T if jcfg.tie_embeddings else params["lm_head"]
        p = jcfg.num_prefix_embeds
        toks = batch["tokens"]
        return JS.chunked_ce_loss(x[:, p:p + toks.shape[1] - 1], w,
                                  toks[:, 1:], softcap=jcfg.logits_softcap) \
            + AUX_WEIGHT * aux

    def loss(params, batch):
        x, aux = M.hidden_states(params, batch, cfg)
        w = params["embed"].mT if cfg.tie_embeddings else params["lm_head"]
        p = cfg.num_prefix_embeds
        toks = batch["tokens"]
        return S.chunked_ce_loss(x[:, p:p + toks.shape[1] - 1], w,
                                 toks[:, 1:], softcap=cfg.logits_softcap) \
            + AUX_WEIGHT * aux

    return jloss, loss


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    jcfg, cfg, jp, p = _pair(arch)
    jb, b = _batches(jcfg, cfg)
    for k in jb:
        assert np.array_equal(np.asarray(jb[k]), b[k].numpy()), k
    jlogits, jaux = jax.jit(JM.forward, static_argnums=2)(jp, jb, jcfg)
    with torch.no_grad():
        logits, aux = M.forward(p, b, cfg)
    assert logits.shape == jlogits.shape == (
        2, SHAPE.seq_len, cfg.vocab_padded)
    if cfg.num_experts:
        assert float(aux) == pytest.approx(float(jaux), rel=FWD_TOL)
        assert float(aux) > 0.0
    else:
        assert float(aux) == float(jaux) == 0.0
    assert _rel(jlogits, logits) < FWD_TOL
    jloss, loss = _loss_pair(jcfg, cfg)
    with torch.no_grad():
        got = float(loss(p, b))
    assert got == pytest.approx(float(jax.jit(jloss)(jp, jb)), rel=FWD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    jcfg, cfg, jp, p = _pair(arch, seed=3)
    jb, b = _batches(jcfg, cfg, seed=4)
    jloss, loss = _loss_pair(jcfg, cfg)
    jg = jax.jit(jax.grad(jloss))(jp, jb)
    names, leaves, tdef = tree.flatten_with_names(p)
    leaves = [t.requires_grad_() for t in leaves]
    grads = torch.autograd.grad(loss(tree.unflatten(tdef, leaves), b),
                                leaves)
    assert names == _names(jg)
    for name, jgl, g in zip(names, jax.tree.leaves(jg), grads):
        assert tuple(g.shape) == jgl.shape, name
        assert _rel(jgl, g) < GRAD_TOL, name


def test_remat_does_not_change_the_gradient():
    _, cfg, _, p = _pair("qwen3-8b")
    _, b = _batches(C.get_smoke_config("qwen3-8b"), cfg)
    _, loss_on = _loss_pair(None, cfg)
    _, loss_off = _loss_pair(None, dataclasses.replace(cfg, remat=False))
    out = []
    for fn in (loss_on, loss_off):
        leaves, tdef = tree.flatten(p)
        leaves = [t.detach().clone().requires_grad_() for t in leaves]
        out.append(torch.autograd.grad(fn(tree.unflatten(tdef, leaves), b),
                                       leaves))
    for a, g in zip(*out):
        torch.testing.assert_close(a, g, rtol=0, atol=0)


def test_bf16_forward_tracks_the_reference():
    """The full-width configs compute in bf16: the same smoke weights in
    bf16 through both packages."""
    jcfg, cfg, jp, p = _pair("qwen3-8b", dtype="bfloat16")
    jb, b = _batches(jcfg, cfg)
    assert p["embed"].dtype == torch.bfloat16
    jlogits, _ = JM.forward(jp, jb, jcfg)
    with torch.no_grad():
        logits, _ = M.forward(p, b, cfg)
    assert logits.dtype == torch.bfloat16
    assert _rel(np.asarray(jlogits.astype(jnp.float32)),
                logits.float()) < BF16_TOL


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("chunks", [(16, 16), (24, 8)])
def test_flash_attention_chunks_match_reference(window, chunks):
    """Several query and key chunks (the full-width path's blocking),
    causal and windowed, forward and gradient."""
    rng = np.random.default_rng(5)
    b, s, kv, g, hd = 2, 48, 2, 2, 8
    qn = rng.standard_normal((b, s, kv, g, hd)).astype(np.float32)
    kn = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    vn = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    qc, kc = chunks

    def jfn(q, k, v):
        pos = jnp.arange(s, dtype=jnp.int32)
        return JATT.flash_attention(q, k, v, pos, pos, window=window,
                                    q_chunk=qc, kv_chunk=kc)

    jout = jax.jit(jfn)(*map(jnp.asarray, (qn, kn, vn)))
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) ** 2),
                              argnums=(0, 1, 2)))(
        *map(jnp.asarray, (qn, kn, vn)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn)]
    pos = torch.arange(s, dtype=torch.int32)
    out = ATT.flash_attention(*ts, pos, pos, window=window, q_chunk=qc,
                              kv_chunk=kc)
    assert _rel(jout, out.detach()) < FWD_TOL
    grads = torch.autograd.grad((out ** 2).sum(), ts)
    for jg, tg in zip(jgrads, grads):
        assert _rel(jg, tg) < GRAD_TOL


def test_layers_match_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)
    tx = torch.from_numpy(x)
    pairs = [
        (JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
         L.rms_norm(tx, torch.from_numpy(scale))),
        (JL.rms_norm(jnp.asarray(x)), L.rms_norm(tx)),
        (JL.nonparam_ln(jnp.asarray(x)), L.nonparam_ln(tx)),
        (JL.rope_freqs(16, 1e6), L.rope_freqs(16, 1e6)),
        (JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4),
         L.apply_rope(tx, torch.from_numpy(pos), 1e4)),
    ]
    w = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("wi_gate", (16, 24)), ("wi_up", (16, 24)), ("wi", (16, 24)),
        ("wo", (24, 16)))}
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    for kind in ("swiglu", "gelu"):
        pairs.append((JL.mlp_apply(jw, jnp.asarray(x), kind),
                      L.mlp_apply(tw, tx, kind)))
    for want, got in pairs:
        assert _rel(want, got) < LAYER_TOL
    assert L.norm_param(8, "nonparam_ln") is None


def test_truncated_normal_init_draws_from_its_generator():
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    a = L.truncated_normal_init(g1, (64, 32), 1.0)
    b = L.truncated_normal_init(g2, (64, 32), 1.0, torch.bfloat16)
    assert b.dtype == torch.bfloat16
    torch.testing.assert_close(a.to(torch.bfloat16), b, rtol=0, atol=0)
    # N(0, 1) on [-2, 2], times 1/sqrt(fan_in = 64)
    assert float(a.abs().max()) <= 2.0 / 8.0
    assert 0.08 < float(a.std()) < 0.13


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_and_param_count_match_reference(arch):
    jcfg, cfg, jp, p = _pair(arch)
    assert M.param_count(p) == JM.param_count(jp)
    ours = M.init_params(cfg, torch.Generator().manual_seed(0))
    names, leaves, _ = tree.flatten_with_names(ours)
    assert names == _names(jp)
    for t, jl in zip(leaves, jax.tree.leaves(jp)):
        assert tuple(t.shape) == jl.shape
        assert str(t.dtype).split(".")[-1] == str(jl.dtype)


def test_registry_matches_reference():
    assert C.list_archs() == JC.list_archs()
    for arch in C.list_archs():
        assert dataclasses.asdict(C.get_config(arch)) == \
            dataclasses.asdict(JC.get_config(arch))
        assert dataclasses.asdict(C.get_smoke_config(arch)) == \
            dataclasses.asdict(JC.get_smoke_config(arch))
    from repro.configs import registry as JR
    from repro.models.config import SHAPES as JSHAPES
    from repro_torch.models.config import SHAPES

    for name, shape in SHAPES.items():
        for arch in C.list_archs():
            assert C.cell_supported(C.get_config(arch), shape) == \
                JR.cell_supported(JC.get_config(arch), JSHAPES[name])
    specs = C.input_specs(C.get_config("pixtral-12b"), SHAPES["train_4k"])
    assert specs == {"tokens": ((256, 4096 - 256), torch.int32),
                     "embeds": ((256, 256, 5120), torch.bfloat16)}
    with pytest.raises(KeyError, match="unknown arch"):
        C.get_config("gpt-2")
