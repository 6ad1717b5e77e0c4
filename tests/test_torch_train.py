"""repro_torch.train, .data and .checkpoint against the reference.

* ``chunked_ce_loss`` against the reference's (padding, masking, softcap,
  z-loss) within FWD_TOL;
* two ``train_step``s of every arch's SMOKE config from the reference's
  initial state (carried over with ``interop.tree_from_numpy``), on the
  same ``SyntheticLM`` batches: every leaf of params, ``mu``, ``nu`` within
  STATE_TOL of its max, the metrics within METRIC_TOL.  The Muon plans
  are bound to the reference's prescale start vector; f32 rounding and
  the port's first-pass ridge (ROADMAP Queue C) are what remain;
* ``SyntheticLM`` batches are bit-identical to the reference's;
* a checkpoint the reference's ``CheckpointManager`` wrote restores in
  the port (and the reverse), plus the port's own round trip, GC,
  corruption and async cases, and ``TrainLoop`` resume, by the loop and
  by the launcher.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JCkpt  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.optim.muon import MuonConfig as JMuonConfig  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import interop, tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim import muon as MU  # noqa: E402
from repro_torch.train import TrainLoop  # noqa: E402
from repro_torch.train import step as S  # noqa: E402

FWD_TOL = 1e-5     # the loss, relative (f32 sums over 512-token chunks)
STATE_TOL = 1e-4   # max|err| / max|leaf| after two steps (~2e-5 seen)
METRIC_TOL = 1e-5  # loss, grad norm, lr scale, relative


@pytest.fixture(scope="module", autouse=True)
def _restore_reference_caches():
    from repro.solver import planner as jplanner
    from repro.spectral import topk as jtopk

    before = dict(jplanner._PLANS), dict(jtopk._TOPK_PLANS)
    yield
    for cache, saved in zip((jplanner._PLANS, jtopk._TOPK_PLANS), before):
        cache.clear()
        cache.update(saved)


@pytest.fixture
def reference_draws(monkeypatch):
    """Every Muon plan bound to the reference's prescale start vector."""
    real = MU._polar_plan

    def bound(method, rows, cols, *args):
        v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                          (min(rows, cols),), jnp.float32))
        return interop.with_state(real(method, rows, cols, *args),
                                  start_vector=v0)

    monkeypatch.setattr(MU, "_polar_plan", bound)


def _port_state(jstate):
    return S.TrainState(*[interop.tree_from_numpy(
        jax.tree.map(np.asarray, x)) for x in (jstate.step, jstate.params,
                                                jstate.opt)])


def _worst(jtree, ttree):
    """(worst max|err| / max|leaf|, its name) over matching leaves."""
    names, leaves, _ = tree.flatten_with_names(ttree)
    jleaves = jax.tree.leaves(jtree)
    assert len(jleaves) == len(leaves)
    out = []
    for name, a, b in zip(names, jleaves, leaves):
        a = np.asarray(a, np.float64)
        assert a.shape == tuple(b.shape), name
        out.append((np.abs(a - b.double().numpy()).max()
                    / max(np.abs(a).max(), 1e-30), name))
    return max(out)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("s", [40, 1100])
def test_chunked_ce_loss_matches_reference(softcap, s):
    """One chunk and three (padded), masked labels, softcap and z-loss."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, s, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(-1, 40, size=(2, s)).astype(np.int32)
    want = float(JS.chunked_ce_loss(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(labels), softcap=softcap))
    got = S.chunked_ce_loss(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(labels), softcap=softcap)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=FWD_TOL)


@pytest.mark.parametrize("arch", C.list_archs())
def test_two_train_steps_match_reference(arch, reference_draws):
    jcfg, cfg = JC.get_smoke_config(arch), C.get_smoke_config(arch)
    jinit, jstep = JS.make_train_step(jcfg, JMuonConfig(), total_steps=10,
                                      warmup=1)
    _, step = S.make_train_step(cfg, MU.MuonConfig(), total_steps=10,
                                warmup=1)
    js = jinit(jax.random.PRNGKey(0))
    st = _port_state(js)
    kw = dict(num_prefix_embeds=cfg.num_prefix_embeds, d_model=cfg.d_model,
              dtype=cfg.dtype)
    jdata = JData(jcfg.vocab_size, 64, 2, **kw)
    data = SyntheticLM(cfg.vocab_size, 64, 2, device="cpu", **kw)
    jstep = jax.jit(jstep)
    for i in range(2):
        js, jm = jstep(js, jdata.batch_at(i))
        st, m = step(st, data.batch_at(i))
        assert set(m) == set(jm)
        for k in m:
            assert m[k].device.type == "cpu" and m[k].ndim == 0
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=METRIC_TOL,
                                                abs=1e-12), (i, k)
    assert int(st.step) == 2 and st.step.dtype == torch.int32
    assert int(st.opt["count"]) == 2
    for part in ("params", "mu", "nu"):
        jt = js.params if part == "params" else js.opt[part]
        tt = st.params if part == "params" else st.opt[part]
        err, name = _worst(jt, tt)
        assert err < STATE_TOL, (part, name, err)


def test_train_step_leaves_its_input_state_alone():
    cfg = C.get_smoke_config("yi-34b")
    init, step = S.make_train_step(cfg, MU.MuonConfig(), warmup=1)
    st = init(torch.Generator().manual_seed(0))
    assert all(t.dtype in (torch.float32, torch.int32)
               for t in tree.leaves(st))
    before = [t.clone() for t in tree.leaves(st)]
    data = SyntheticLM(cfg.vocab_size, 32, 2, dtype=cfg.dtype, device="cpu")
    new, m = step(st, data.batch_at(0))
    new, m = step(new, data.batch_at(1))
    for a, b in zip(before, tree.leaves(st)):
        assert torch.equal(a, b)
    assert not any(t.requires_grad for t in tree.leaves(new))
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert float(m["lr_scale"]) == 1.0


@pytest.mark.parametrize("arch", ["pixtral-12b", "qwen3-8b"])
def test_synthetic_batches_are_the_reference_draws(arch):
    jcfg = dataclasses.replace(JC.get_smoke_config(arch), dtype="bfloat16")
    cfg = dataclasses.replace(C.get_smoke_config(arch), dtype="bfloat16")
    kw = lambda c: dict(num_prefix_embeds=c.num_prefix_embeds,
                        d_model=c.d_model, dtype=c.dtype, seed=5)
    jd = JData(jcfg.vocab_size, 40, 3, **kw(jcfg))
    d = SyntheticLM(cfg.vocab_size, 40, 3, device="cpu", **kw(cfg))
    for step in (0, 7):
        jb, b = jd.batch_at(step), d.batch_at(step)
        assert set(jb) == set(b)
        assert b["tokens"].dtype == torch.int32
        assert np.array_equal(np.asarray(jb["tokens"]), b["tokens"].numpy())
        if cfg.num_prefix_embeds:
            assert b["embeds"].dtype == torch.bfloat16
            assert np.array_equal(
                np.asarray(jb["embeds"].astype(jnp.float32)),
                b["embeds"].float().numpy())


def _small_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((16, 8), generator=g),
                       "stages": (torch.arange(12.0).reshape(3, 4),)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = _small_state()
    mgr.save(7, state)
    restored, step = mgr.restore(state)
    assert step == 7
    names, leaves, _ = tree.flatten_with_names(restored)
    assert names == ["params/stages/0", "params/w", "step"]
    for a, b in zip(tree.leaves(state), leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_k=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _small_state())
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_checkpoint_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = _small_state()
    mgr.save(1, state)
    victim = os.path.join(str(tmp_path), "step_1", "00001.npy")
    arr = np.load(victim)
    arr.reshape(-1)[0] += 1.0
    np.save(victim, arr)
    with pytest.raises(IOError, match="params/w"):
        mgr.restore(state)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_checkpoint_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _small_state()
    mgr.save(3, state)
    mgr.wait()
    restored, step = mgr.restore(state)
    assert step == 3
    assert torch.equal(restored["params"]["w"], state["params"]["w"])


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference's train state (olmo-1b SMOKE: no final_norm, a
    registered TrainState pytree) written by its CheckpointManager, read
    back by the port's into a port state of the same layout — and the
    port's save read back by the reference."""
    jcfg, cfg = JC.get_smoke_config("olmo-1b"), C.get_smoke_config("olmo-1b")
    jinit, _ = JS.make_train_step(jcfg, JMuonConfig())
    js = jinit(jax.random.PRNGKey(4))
    JCkpt(str(tmp_path / "ref"), async_save=False).save(5, js)
    init, _ = S.make_train_step(cfg, MU.MuonConfig())
    target = init(torch.Generator().manual_seed(0))
    st, step = CheckpointManager(str(tmp_path / "ref")).restore(target)
    assert step == 5 and isinstance(st, S.TrainState)
    names, leaves, _ = tree.flatten_with_names(st)
    with open(tmp_path / "ref" / "step_5" / "manifest.json") as f:
        manifest = json.load(f)
    assert names == [e["name"] for e in manifest["leaves"]]
    for a, b in zip(jax.tree.leaves(js), leaves):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert str(b.dtype).split(".")[-1] == str(np.asarray(a).dtype)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(6, st)
    back, step = JCkpt(str(tmp_path / "port")).restore(js)
    assert step == 6
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_loop_resume(tmp_path):
    """TrainLoop resumes from the latest checkpoint step."""
    cfg = C.get_smoke_config("olmo-1b")
    init_fn, step_fn = S.make_train_step(cfg, MU.MuonConfig(lr=0.01))
    data = SyntheticLM(cfg.vocab_size, 32, 2, dtype=cfg.dtype, device="cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    log = str(tmp_path / "log.jsonl")
    loop = TrainLoop(step_fn, data, ckpt=mgr, ckpt_every=2, log_every=2,
                     log_path=log, tokens_per_step=64)
    state = loop.resume_or_init(init_fn, torch.Generator().manual_seed(0))
    state = loop.run(state, 4)
    assert int(state.step) == 4
    assert mgr.all_steps() == [2, 4]
    # a fresh loop (a restarted process) resumes at 4 with the same state
    loop2 = TrainLoop(step_fn, data, ckpt=mgr, ckpt_every=2, log_every=2,
                      log_path=log)
    state2 = loop2.resume_or_init(init_fn, torch.Generator().manual_seed(1))
    assert int(state2.step) == 4
    for a, b in zip(tree.leaves(state), tree.leaves(state2)):
        assert torch.equal(a, b)
    state2 = loop2.run(state2, 6)
    assert int(state2.step) == 6
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [2, 4, 6]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert "tokens_per_sec" in recs[0]


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "qwen3-8b", "--smoke", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "2", "--log", str(tmp_path / "log.jsonl")]
    state = launch_train.main(args + ["--steps", "3"])
    assert int(state.step) == 3
    state = launch_train.main(args + ["--steps", "5"])
    assert int(state.step) == 5
    out = capsys.readouterr().out
    assert "[loop] resumed from step 3" in out
    assert "[train] finished at step 5" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3, 4, 5][-3:]


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "moonshot-v1-16b-a3b"])
def test_launcher_trains_every_family(arch, capsys):
    """The SSD, RG-LRU and MoE families through the launcher: finite
    losses, the MoE aux loss logged and positive."""
    state = launch_train.main(["--arch", arch, "--smoke", "--batch", "2",
                               "--seq", "32", "--device", "cpu", "--steps",
                               "2"])
    assert int(state.step) == 2
    assert "[train] finished at step 2" in capsys.readouterr().out


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "mamba2-130m", "--smoke", "--steps",
                           "1"])
