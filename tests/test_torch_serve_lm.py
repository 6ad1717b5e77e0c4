"""LM serving of repro_torch (caches, prefill, decode, ServeEngine, the
launcher) against repro.

The reference's weights (``init_params`` from a JAX key) are carried into
the port with ``interop.model_params_from_numpy`` and its caches with
``interop.caches_from_numpy``; prompts are numpy draws from a seed.  For
every arch's SMOKE config (f32):

* ``init_caches`` has the reference's tree: names, shapes, dtypes;
* ``prefill`` and DECODE_STEPS ``decode_step``s give the reference's
  logits within FWD_TOL of max|logits| (f32 sums, ~1e-6 measured), and
  every new cache leaf within FWD_TOL of its max; the port's
  ``decode_step`` on the reference's own caches gives its logits too;
* ``ServeEngine.generate`` at temperature 0 gives the reference's greedy
  tokens exactly;
* ``decode_step_``, the engine's in-place step, equals ``decode_step``
  bit for bit and writes into the buffers it is given; the decode taken
  over the ring in several chunks still gives the reference's logits.

The prompt (PROMPT tokens) is shorter than every smoke window (32), where
the reference's ring fill is right.  The ring-fill test covers prompts of
32, 40 and 64 tokens against the window of 32: the port's decode agrees
with the reference's full forward every time, while the reference's own
decode is wrong at 40 (a prompt longer than the window and not a multiple
of it: it stores the last w keys unrotated, so slot i holds position
s - w + i where its decode expects i (mod w)).

Temperature sampling is the Gumbel-max form of ``jax.random.categorical``
on a ``torch.Generator``: reproducible from the generator, never an id
of the padded vocab tail, but not JAX's draws (a deliberate divergence).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import interop, tree  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import ServeEngine, sample  # noqa: E402

ARCHS = tuple(C.list_archs())
FWD_TOL = 1e-5    # max|err| / max|logits| (or max|leaf|), f32
PROMPT = 24       # below every smoke window (32)
MAX_LEN = 64
BATCH = 2
DECODE_STEPS = 4
GEN_STEPS = 8
RING_WINDOW_ARCH = "h2o-danube-3-4b"  # smoke window 32

_jprefill = jax.jit(JM.prefill, static_argnums=(2, 3))
_jdecode = jax.jit(JM.decode_step, static_argnums=3)
_jforward = jax.jit(JM.forward, static_argnums=2)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    scale = np.abs(a).max() if a.size else 0.0
    if scale == 0.0:
        return float(np.abs(b).max()) if b.size else 0.0
    return np.abs(a - b).max() / scale


def _names(jtree):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]


def _pair(arch, seed=0):
    jcfg, cfg = JC.get_smoke_config(arch), C.get_smoke_config(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    p = interop.model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, cfg, jp, p


def _prompt(cfg, s, seed=1, batch=BATCH):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, s)).astype(np.int32)
    jb, b = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.num_prefix_embeds:
        e = rng.standard_normal(
            (batch, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
        jb["embeds"], b["embeds"] = jnp.asarray(e), torch.from_numpy(e)
    return jb, b


def _caches_err(jc, tc):
    """(worst leaf error, its name): names and shapes must agree."""
    names, leaves, _ = tree.flatten_with_names(tc)
    jleaves = jax.tree.leaves(jc)
    assert names == _names(jc)
    out = []
    for name, a, t in zip(names, jleaves, leaves):
        assert tuple(t.shape) == a.shape, name
        out.append((_rel(np.asarray(a, np.float64), t), name))
    return max(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_reference_layout(arch):
    jcfg, cfg = JC.get_smoke_config(arch), C.get_smoke_config(arch)
    jc = JM.init_caches(jcfg, BATCH, MAX_LEN)
    tc = M.init_caches(cfg, BATCH, MAX_LEN, device="cpu")
    names, leaves, _ = tree.flatten_with_names(tc)
    assert names == _names(jc)
    for t, a in zip(leaves, jax.tree.leaves(jc)):
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).split(".")[-1] == str(a.dtype)
        assert not t.any()
    assert tc["pos"].dtype == torch.int32 and tc["pos"].ndim == 0
    back = interop.caches_from_numpy(interop.caches_to_numpy(tc), cfg,
                                     BATCH, MAX_LEN)
    assert tree.flatten_with_names(back)[0] == names
    with pytest.raises(ValueError, match="layout"):
        interop.caches_from_numpy(interop.caches_to_numpy(tc), cfg,
                                  BATCH + 1, MAX_LEN)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, cfg, jp, p = _pair(arch)
    jb, b = _prompt(cfg, PROMPT)
    jlog, jc = _jprefill(jp, jb, jcfg, MAX_LEN)
    log, tc = M.prefill(p, b, cfg, MAX_LEN)
    assert log.shape == jlog.shape == (BATCH, cfg.vocab_padded)
    assert _rel(jlog, log) < FWD_TOL
    err, name = _caches_err(jc, tc)
    assert err < FWD_TOL, ("prefill", name, err)
    assert int(tc["pos"]) == PROMPT + cfg.num_prefix_embeds
    for step in range(DECODE_STEPS):
        nxt = np.argmax(np.asarray(jlog)[:, :cfg.vocab_size], -1)
        nxt = nxt.astype(np.int32)[:, None]
        before = [t.clone() for t in tree.leaves(tc)]
        # the port's step on the reference's caches, then on its own
        theirs = interop.caches_from_numpy(jax.tree.map(np.asarray, jc),
                                           cfg, BATCH, MAX_LEN)
        log_theirs, _ = M.decode_step(p, torch.from_numpy(nxt), theirs, cfg)
        jlog, jc = _jdecode(jp, jnp.asarray(nxt), jc, jcfg)
        log, new = M.decode_step(p, torch.from_numpy(nxt), tc, cfg)
        # functional: the input caches are untouched
        for t0, t in zip(before, tree.leaves(tc)):
            assert torch.equal(t0, t)
        tc = new
        assert _rel(jlog, log) < FWD_TOL, step
        assert _rel(jlog, log_theirs) < FWD_TOL, step
        err, name = _caches_err(jc, tc)
        assert err < FWD_TOL, (step, name, err)
        assert tc["pos"].dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    jcfg, cfg, jp, p = _pair(arch, seed=2)
    jb, b = _prompt(cfg, PROMPT, seed=3)
    jtoks, _ = JServeEngine(jcfg, jp, max_len=MAX_LEN).generate(
        jb, steps=GEN_STEPS)
    toks, caches = ServeEngine(cfg, p, max_len=MAX_LEN).generate(
        b, steps=GEN_STEPS)
    assert toks.dtype == torch.int32 and toks.shape == (BATCH, GEN_STEPS)
    assert np.array_equal(np.asarray(jtoks), toks.numpy())
    assert int(caches["pos"]) == \
        PROMPT + cfg.num_prefix_embeds + GEN_STEPS - 1


def test_temperature_sampling_is_reproducible_and_in_vocab():
    vocab, padded, rows = 5, 8, 20_000
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5, 1e4, 1e4, 1e4])
    logits = logits.expand(rows, padded)

    def draw(seed, t=0.7):
        return sample(logits, torch.Generator().manual_seed(seed), t, vocab)

    a, b, c = draw(5), draw(5), draw(6)
    assert a.dtype == torch.int32 and a.shape == (rows,)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) < vocab
    # the draws follow softmax(logits / t) over the real vocab
    want = torch.softmax(logits[0, :vocab] / 0.7, dim=0)
    freq = torch.bincount(a.long(), minlength=vocab).double() / rows
    assert (freq - want.double()).abs().max() < 0.02
    # temperature 0: the first maximum of the unmasked part
    tie = torch.tensor([[0.0, 3.0, 3.0, 1.0, 9.0]])
    assert sample(tie, None, 0.0, 4).tolist() == [1]

    jcfg, cfg, jp, p = _pair("qwen3-8b")
    _, batch = _prompt(cfg, PROMPT)
    eng = ServeEngine(cfg, p, max_len=MAX_LEN, temperature=0.9)
    outs = [eng.generate(batch, GEN_STEPS,
                         torch.Generator().manual_seed(11))[0]
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert int(outs[0].max()) < cfg.vocab_size
    assert torch.equal(eng.generate(batch, GEN_STEPS)[0],
                       eng.generate(batch, GEN_STEPS)[0])


@pytest.mark.parametrize("prompt", [32, 40, 64])
def test_ring_fill_matches_the_forward(prompt):
    """A windowed ring cache (window 32) after prompts of 32, 40 and 64
    tokens: the port's prefill + decode against the reference's full
    forward over the same tokens."""
    jcfg, cfg, jp, p = _pair(RING_WINDOW_ARCH, seed=4)
    assert cfg.window == 32
    steps = 8
    max_len = prompt + steps
    rng = np.random.default_rng(prompt)
    toks = rng.integers(0, cfg.vocab_size,
                        (BATCH, prompt + steps)).astype(np.int32)
    want, _ = _jforward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    want = np.asarray(want)[:, prompt - 1:prompt + steps - 1]

    log, caches = M.prefill(p, {"tokens": torch.from_numpy(
        toks[:, :prompt])}, cfg, max_len)
    got = [log]
    jlog, jc = _jprefill(jp, {"tokens": jnp.asarray(toks[:, :prompt])},
                         jcfg, max_len)
    ref = [np.asarray(jlog)]
    for i in range(prompt, prompt + steps - 1):
        log, caches = M.decode_step(p, torch.from_numpy(toks[:, i:i + 1]),
                                    caches, cfg)
        got.append(log)
        jlog, jc = _jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jc, jcfg)
        ref.append(np.asarray(jlog))
    got = torch.stack(got, dim=1)
    assert _rel(want, got) < FWD_TOL
    ref_err = _rel(want, np.stack(ref, axis=1))
    if prompt % cfg.window:
        assert ref_err > 0.1  # the reference's fault
    else:
        assert ref_err < FWD_TOL


@pytest.mark.parametrize("arch", ["qwen3-8b", "recurrentgemma-2b",
                                  "mamba2-130m", "moonshot-v1-16b-a3b"])
def test_launcher_serves_every_mixer_kind_on_the_cpu(arch, capsys):
    toks = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "40", "--gen",
                              "6"])
    assert toks.shape == (2, 6) and toks.device.type == "cpu"
    assert int(toks.max()) < C.get_smoke_config(arch).vocab_size
    assert "[serve] generated (2, 6)" in capsys.readouterr().out


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "qwen3-8b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_caches(C.get_smoke_config("qwen3-8b"), 1, 8)


def test_moe_decode_without_drops_matches_the_forward():
    """With a capacity factor of num_experts nothing is dropped, so the
    MoE model's decode (b tokens a step) agrees with its full forward
    (b s tokens): the capacity is the only thing that couples tokens."""
    arch = "moonshot-v1-16b-a3b"
    cfg = dataclasses.replace(C.get_smoke_config(arch),
                              capacity_factor=8.0)
    p = M.init_params(cfg, torch.Generator().manual_seed(5))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (BATCH, 30)).astype(np.int32))
    with torch.no_grad():
        want, _ = M.forward(p, {"tokens": toks}, cfg)
    log, caches = M.prefill(p, {"tokens": toks[:, :24]}, cfg, 32)
    got = [log]
    for i in range(24, 29):
        log, caches = M.decode_step(p, toks[:, i:i + 1], caches, cfg)
        got.append(log)
    assert _rel(want[:, 23:29], torch.stack(got, dim=1)) < FWD_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_in_place_decode_matches_the_functional_step(arch):
    """``decode_step_`` (the engine's step) gives ``decode_step``'s logits
    and caches bit for bit, writing them into the buffers it was given."""
    cfg = C.get_smoke_config(arch)
    p = M.init_params(cfg, torch.Generator().manual_seed(7))
    _, b = _prompt(cfg, PROMPT, seed=8)
    _, caches = M.prefill(p, b, cfg, MAX_LEN)
    nxt = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (BATCH, 1)).astype(np.int32))
    log, new = M.decode_step(p, nxt, caches, cfg)
    buffers = [t.data_ptr() for t in tree.leaves(caches)]
    log_, same = M.decode_step_(p, nxt, caches, cfg)
    assert same is caches
    assert [t.data_ptr() for t in tree.leaves(same)] == buffers
    assert torch.equal(log, log_)
    for t0, t in zip(tree.leaves(new), tree.leaves(same)):
        assert torch.equal(t0, t)


@pytest.mark.parametrize("arch", ["qwen3-8b", RING_WINDOW_ARCH])
def test_decode_over_several_ring_chunks_matches_reference(arch,
                                                           monkeypatch):
    """The decode's scores and PV product taken a few ring slots at a time
    (8 of a 64- or 32-slot ring) against the reference's decode."""
    from repro_torch.models import attention as ATT

    monkeypatch.setattr(ATT, "DECODE_CHUNK", 8)
    jcfg, cfg, jp, p = _pair(arch, seed=10)
    jb, b = _prompt(cfg, PROMPT, seed=11)
    jlog, jc = _jprefill(jp, jb, jcfg, MAX_LEN)
    _, caches = M.prefill(p, b, cfg, MAX_LEN)
    assert caches["stages"][0]["k"].shape[2] > ATT.DECODE_CHUNK
    for step in range(DECODE_STEPS):
        nxt = np.argmax(np.asarray(jlog)[:, :cfg.vocab_size], -1)
        nxt = nxt.astype(np.int32)[:, None]
        jlog, jc = _jdecode(jp, jnp.asarray(nxt), jc, jcfg)
        log, caches = M.decode_step_(p, torch.from_numpy(nxt), caches, cfg)
        assert _rel(jlog, log) < FWD_TOL, step
    err, name = _caches_err(jc, caches)
    assert err < FWD_TOL, (name, err)
