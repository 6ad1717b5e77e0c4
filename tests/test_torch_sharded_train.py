"""The sharded train path on a (2, 2) ("data", "model") mesh of 4 gloo
ranks on the CPU, against the port's unsharded path and the reference.

One job of 4 rank processes (module fixture) runs every case on the
same ranks and writes what each rank saw, while this process computes
the same cases unsharded in the port and in the reference; the tests
compare:

* ``orthogonalize`` of a (4, 96, 64) and a (4, 64, 96) stack under the
  hints equals the unsharded port's within 1e-12 (f64) and 1e-5 (f32),
  with one all-reduce over "data" per Gram of the engine (two in the
  CholeskyQR2 iteration, one in each Cholesky one: MODE_SEP_PSUMS) and
  none over "model"; the gathered factor equals the reference's
  (``repro.optim.muon.orthogonalize`` in f32, the same static f64 plan
  in f64) within the same tolerances;
* two train steps of the qwen3-8b and mamba2-130m smoke configs, the
  initial state placed by ``tree_shardings(arch_rules(...))``
  and run under the hints, equal two unsharded port steps within 1e-5 of
  max|p| (losses and grad norms too), and the reference's jitted steps
  within test_torch_train's tolerances.  Every Muon plan, here and in
  the ranks, is bound to the reference's prescale start vector;
* a checkpoint saved from the (2, 2) state restores into (2, 2)
  placements unchanged, and into a (1, 1) mesh (a one-rank gloo group in
  this process) unchanged.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro import solver as JSOLVER  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.optim import muon as JMU  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import interop, tree  # noqa: E402
from repro_torch.analysis.plan_audit import MODE_SEP_PSUMS  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.optim import muon as MU  # noqa: E402
from repro_torch.optim.muon import MuonConfig  # noqa: E402
from repro_torch.train.step import (make_train_step,  # noqa: E402
                                    state_axes_for_params)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240
ARCHS = ("qwen3-8b", "mamba2-130m")
ORTHO_CASES = [(dt, shape) for dt in ("float64", "float32")
               for shape in ((4, 96, 64), (4, 64, 96))]
ORTHO_TOL = {"float64": 1e-12, "float32": 1e-5}
STEP_TOL = 1e-5
TRAIN_SHAPE = dict(seq_len=32, global_batch=4)
SCHEDULE = dict(total_steps=10, warmup=1)
# the train steps against the reference: test_torch_train's tolerances
STATE_TOL = 1e-4
METRIC_TOL = 1e-5

_SCRIPT = r"""
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist


def run(rank, out, c):
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as C, interop, solver, tree
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import sharding as S
    from repro_torch.launch.dryrun import CollectiveRecorder, mesh_group_axes
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import muon as MU
    from repro_torch.train.step import make_train_step, state_axes_for_params

    # every Muon plan bound to the reference's prescale start vector
    real = MU._polar_plan

    def bound(method, rows, cols, *args):
        return interop.with_state(real(method, rows, cols, *args),
                                  start_vector=np.asarray(
                                      c["v0"][str(min(rows, cols))],
                                      np.float32))

    MU._polar_plan = bound
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    meta = {"ortho": [], "train": {}}
    arrays = {}

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    rules = S.LogicalRules({"opt_stack": "model", "opt_rows": "data"},
                           mesh=mesh)
    for k, (dt, shape) in enumerate(c["ortho_cases"]):
        dtype = getattr(torch, dt)
        m = torch.from_numpy(np.random.default_rng(5).standard_normal(
            shape)).to(dtype)
        n = min(shape[1:])
        rec = CollectiveRecorder(mesh_group_axes(mesh))
        if dt == "float32":
            # ZoloMuon's own plan and entry point
            plan = MU._polar_plan("zolo", shape[1], shape[2], 2, 1e-3, 4, dt,
                                  "cpu")
            ref = MU.orthogonalize(m, polar_dtype=dt)
            with S.activation_hints(rules), rec:
                q = MU.orthogonalize(m, polar_dtype=dt)
        else:
            # Muon's plans factorize in f32: the f64 case is the same
            # static schedule computed in f64, through the same sharded
            # solve
            plan = interop.with_state(solver.plan(solver.SvdConfig(
                method="zolo_static", r=2, l0=1e-3, max_iters=4,
                qr_mode="cholqr2", qr_iters=1, scale="power"),
                shape[1:], dtype, device="cpu"),
                start_vector=np.asarray(c["v0_64"][str(n)]))
            ref = plan.polar_batched(m, want_h=False)[0]
            axes = ("opt_stack", "opt_rows", None) if shape[1] >= shape[2] \
                else ("opt_stack", None, "opt_rows")
            with S.activation_hints(rules), rec:
                q = MU._polar_sharded(plan, S.hint(m, *axes))
        arrays[f"ortho_{k}"] = full(q).numpy()
        meta["ortho"].append({
            "dtype": dt, "shape": shape,
            "placements": [str(p) for p in q.placements],
            "local_stack": q.to_local().shape[0],
            "iterations": len(plan.schedule),
            "err": float((full(q) - ref).abs().max() / ref.abs().max()),
            # Grams are (n, n) or (r, n, n) in f32 or f64, the prescale's
            # reductions (n,) vectors and scalars
            "gram_reduces_data": sum(
                1 for r in rec.records if r.kind == "all-reduce"
                and r.axis == "data" and r.nbytes >= n * n * 4),
            "other_reduces_data": sum(
                1 for r in rec.records if r.kind == "all-reduce"
                and r.axis == "data" and r.nbytes < n * n * 4),
            "reduces_model": sum(1 for r in rec.records
                                 if r.axis == "model"
                                 and r.kind == "all-reduce")})

    shape = ShapeConfig("smoke", "train", **c["train_shape"])
    for arch in c["archs"]:
        cfg = C.get_smoke_config(arch)
        init_fn, step = make_train_step(cfg, MU.MuonConfig(),
                                        **c["schedule"])
        state0 = init_fn(torch.Generator().manual_seed(0))
        data = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch,
                           device="cpu")
        rules = S.arch_rules(cfg, mesh, shape)
        st = S.distribute_tree(state0, S.tree_shardings(
            mesh, rules, state_axes_for_params(cfg, state0.params)))
        metrics = []
        with S.activation_hints(rules):
            for i in range(2):
                b = S.distribute_tree(data.batch_at(i), S.tree_shardings(
                    mesh, rules, {"tokens": ("batch", None)}))
                st, m = step(st, b)
                metrics.append(m)
        for i, x in enumerate(tree.leaves(st.params)):
            arrays[f"{arch}_{i:05d}"] = full(x).numpy()
        meta["train"][arch] = {
            "loss": [float(m["loss"]) for m in metrics],
            "grad_norm": [float(m["grad_norm"]) for m in metrics],
            "placements": str(st.params["stages"][0]["mixer"][
                "in_proj" if arch.startswith("mamba") else "wq"].placements)}
        if arch == c["ckpt_arch"]:
            names, leaves, _ = tree.flatten_with_names(st)
            fulls = [full(x) for x in leaves]
            ck = CheckpointManager(os.path.join(out, "ckpt"),
                                   async_save=False)
            ck.save(2, st)
            dist.barrier()
            back, step_no = ck.restore(st)
            meta["restore_2x2"] = {
                "step": step_no,
                "same": all(torch.equal(full(x), y) for x, y in
                            zip(tree.leaves(back), fulls)),
                "placed": all(
                    (not isinstance(x, DTensor)) or
                    tuple(x.placements) == tuple(y.placements)
                    for x, y in zip(tree.leaves(back), leaves))}
            arrays.update({f"state_{i:05d}": f.numpy()
                           for i, f in enumerate(fulls)})
            meta["names"] = names
    if rank == 0:
        np.savez(os.path.join(out, "arrays.npz"), **arrays)
    with open(os.path.join(out, f"rank_{rank}.json"), "w") as fh:
        json.dump(meta, fh)


def work(rank, out, c):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out, "init"),
        rank=rank, world_size=c["world"],
        timeout=datetime.timedelta(seconds=c["timeout"] // 2))
    try:
        run(rank, out, c)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    out, rank = sys.argv[1], int(sys.argv[2])
    c = json.loads(open(os.path.join(out, "consts.json")).read())
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    work(rank, out, c)
    print("SHARDED_OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _restore_reference_caches():
    from repro.solver import planner as jplanner
    from repro.spectral import topk as jtopk

    before = dict(jplanner._PLANS), dict(jtopk._TOPK_PLANS)
    yield
    for cache, saved in zip((jplanner._PLANS, jtopk._TOPK_PLANS), before):
        cache.clear()
        cache.update(saved)


def _v0(n, dtype=jnp.float32):
    """The reference's prescale start vector for a Muon plan of min
    dimension n."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,), dtype))


def _reference_side(states):
    """The job's cases computed here, unsharded: the reference's
    orthogonal factors, and two train steps of each arch from the port's
    initial state ``states[arch]`` in the reference (jitted) and in the
    port (Muon plans bound to the reference's start vector), as {"ortho": [q], arch: {"reference"/"port": (params leaves,
    losses, grad norms)}}."""
    out = {"ortho": []}
    for dt, shape in ORTHO_CASES:
        m = np.random.default_rng(5).standard_normal(shape).astype(dt)
        if dt == "float32":
            q = JMU.orthogonalize(jnp.asarray(m), polar_dtype=dt)
        else:
            q = JSOLVER.plan(JSOLVER.SvdConfig(
                method="zolo_static", r=2, l0=1e-3, max_iters=4,
                qr_mode="cholqr2", qr_iters=1, scale="power"),
                shape[1:], jnp.float64).polar_batched(
                    jnp.asarray(m), want_h=False)[0]
        out["ortho"].append(np.asarray(q))
    real = MU._polar_plan

    def bound(method, rows, cols, *args):
        return interop.with_state(real(method, rows, cols, *args),
                                  start_vector=_v0(min(rows, cols)))

    kw = dict(TRAIN_SHAPE)
    MU._polar_plan = bound
    try:
        for arch in ARCHS:
            jcfg, cfg = JC.get_smoke_config(arch), C.get_smoke_config(arch)
            _, jstep = JS.make_train_step(jcfg, JMU.MuonConfig(), **SCHEDULE)
            _, step = make_train_step(cfg, MuonConfig(), **SCHEDULE)
            jstep = jax.jit(jstep)
            st = states[arch]
            # the same initial state in the reference
            js = JS.TrainState(*[jax.tree.map(
                jnp.asarray, interop.tree_to_numpy(x))
                for x in (st.step, st.params, st.opt)])
            jdata = JData(jcfg.vocab_size, kw["seq_len"], kw["global_batch"])
            data = SyntheticLM(cfg.vocab_size, kw["seq_len"],
                               kw["global_batch"], device="cpu")
            jm, tm = [], []
            for i in range(2):
                js, m = jstep(js, jdata.batch_at(i))
                jm.append(m)
                st, m = step(st, data.batch_at(i))
                tm.append(m)
            out[arch] = {
                "reference": ([np.asarray(x, np.float64) for x in
                               jax.tree.leaves(js.params)],
                              [float(m["loss"]) for m in jm],
                              [float(m["grad_norm"]) for m in jm]),
                "port": ([x.double().numpy() for x in
                          tree.leaves(st.params)],
                         [float(m["loss"]) for m in tm],
                         [float(m["grad_norm"]) for m in tm])}
    finally:
        MU._polar_plan = real
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Run the 4-rank job once (one process a rank), and meanwhile the
    same cases unsharded here; returns (its out dir, [per-rank records], rank 0's arrays, the
    unsharded side)."""
    out = tmp_path_factory.mktemp("sharded_train")
    states, ns = {}, {min(s[1:]) for _, s in ORTHO_CASES}
    for arch in ARCHS:
        init_fn, _ = make_train_step(C.get_smoke_config(arch), MuonConfig(),
                                     **SCHEDULE)
        st = states[arch] = init_fn(torch.Generator().manual_seed(0))
        ns |= {min(p.shape[-2:]) for p, is_muon in zip(
            tree.leaves(st.params), tree.leaves(MU.muon_labels(st.params)))
            if is_muon}
    consts = {"world": WORLD, "timeout": TIMEOUT, "archs": list(ARCHS),
              "ckpt_arch": ARCHS[0], "ortho_cases": ORTHO_CASES,
              "train_shape": TRAIN_SHAPE, "schedule": SCHEDULE,
              "v0": {str(n): _v0(n).tolist() for n in ns},
              "v0_64": {str(n): _v0(n, jnp.float64).tolist() for n in ns}}
    (out / "consts.json").write_text(json.dumps(consts))
    script = out / "job.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    logs = [out / f"rank_{r}.log" for r in range(WORLD)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, str(script), str(out), str(r)],
                    cwd=ROOT, env=env, stdout=fh, stderr=subprocess.STDOUT))
        unsharded = _reference_side(states)
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for log in logs:
        text = log.read_text()
        assert "SHARDED_OK" in text, text[-6000:]
    with np.load(out / "arrays.npz") as z:
        arrays = dict(z)
    return out, [json.loads((out / f"rank_{r}.json").read_text())
                 for r in range(WORLD)], arrays, unsharded


@pytest.mark.parametrize("case", range(len(ORTHO_CASES)),
                         ids=[f"{dt}-{'x'.join(map(str, s))}"
                              for dt, s in ORTHO_CASES])
def test_sharded_orthogonalize_matches_unsharded(job, case):
    dt, shape = ORTHO_CASES[case]
    for rank, meta in enumerate(job[1]):
        rec = meta["ortho"][case]
        assert rec["dtype"] == dt and tuple(rec["shape"]) == shape
        assert rec["err"] <= ORTHO_TOL[dt], (rank, rec)
        # the long dimension over "data", the stack over "model"
        long_dim = 1 if shape[1] >= shape[2] else 2
        assert rec["placements"] == [f"S({long_dim})", "S(0)"], rec
        # one all-reduce over "data" per Gram, none over "model"
        grams = MODE_SEP_PSUMS["cholqr2"] + MODE_SEP_PSUMS["chol"] * (
            rec["iterations"] - 1)
        assert rec["gram_reduces_data"] == rec["local_stack"] * grams, rec
        # the prescale: 8 power steps and the final norm, each reduced
        assert rec["other_reduces_data"] == rec["local_stack"] * 9, rec
        assert rec["reduces_model"] == 0, rec
        assert rec["local_stack"] == shape[0] // 2


@pytest.mark.parametrize("case", range(len(ORTHO_CASES)),
                         ids=[f"{dt}-{'x'.join(map(str, s))}"
                              for dt, s in ORTHO_CASES])
def test_sharded_orthogonalize_matches_reference(job, case):
    dt, shape = ORTHO_CASES[case]
    q, want = job[2][f"ortho_{case}"], job[3]["ortho"][case]
    assert q.shape == want.shape == shape and q.dtype == want.dtype
    np.testing.assert_allclose(q, want, atol=ORTHO_TOL[dt], rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_steps_match_single_rank(job, arch):
    params, loss, gnorm = job[3][arch]["port"]
    scale = max(np.abs(p).max() for p in params)
    err = max(np.abs(job[2][f"{arch}_{i:05d}"] - p).max()
              for i, p in enumerate(params))
    assert err / scale <= STEP_TOL, err / scale
    for rank, meta in enumerate(job[1]):
        rec = meta["train"][arch]
        np.testing.assert_allclose(rec["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(rec["grad_norm"], gnorm, rtol=1e-5)
        assert "Shard" in rec["placements"], rec
    # every rank computed the same loss
    assert len({tuple(m["train"][arch]["loss"]) for m in job[1]}) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_steps_match_reference(job, arch):
    """The gathered (2, 2) params, every leaf within STATE_TOL of its
    max, and the losses and grad norms within METRIC_TOL, of the
    reference's jitted steps from the same state and batches."""
    params, loss, gnorm = job[3][arch]["reference"]
    for i, p in enumerate(params):
        got = job[2][f"{arch}_{i:05d}"]
        assert got.shape == p.shape, i
        err = np.abs(got - p).max() / max(np.abs(p).max(), 1e-30)
        assert err < STATE_TOL, (i, err)
    for meta in job[1]:
        rec = meta["train"][arch]
        np.testing.assert_allclose(rec["loss"], loss, rtol=METRIC_TOL)
        np.testing.assert_allclose(rec["grad_norm"], gnorm, rtol=METRIC_TOL)


def test_checkpoint_restores_into_2x2(job):
    for meta in job[1]:
        assert meta["restore_2x2"] == {"step": 2, "same": True,
                                       "placed": True}


def test_checkpoint_restores_into_1x1(job, tmp_path):
    """The (2, 2) checkpoint into a (1, 1) mesh's placements (a one-rank
    gloo group in this process): every leaf a DTensor there, unchanged."""
    from torch.distributed.tensor import DTensor

    out, ranks, arrays, _ = job
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "init"), rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        cfg = C.get_smoke_config(ARCHS[0])
        init_fn, _ = make_train_step(cfg, MuonConfig())
        target = init_fn(torch.Generator().manual_seed(1))
        target = S.distribute_tree(target, S.tree_shardings(
            mesh, S.arch_rules(cfg, mesh, None),
            state_axes_for_params(cfg, target.params)))
        back, step = CheckpointManager(str(out / "ckpt")).restore(target)
        assert step == 2
        names, leaves, _ = tree.flatten_with_names(back)
        assert names == ranks[0]["names"]
        for i, x in enumerate(leaves):
            assert isinstance(x, DTensor) and x.device_mesh == mesh
            np.testing.assert_array_equal(x.full_tensor().numpy(),
                                          arrays[f"state_{i:05d}"])
    finally:
        dist.destroy_process_group()
