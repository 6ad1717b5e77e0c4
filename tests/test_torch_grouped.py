"""repro_torch.dist (paper Algorithm 3 on torch.distributed) against
repro.dist, in two worlds.

* The reference's world: one subprocess with 8 virtual JAX devices runs
  the reference's own grouped cases (``tests/test_grouped.py``): the
  static driver at m = 260, n = 96, kappa = 9.06e3, f64, l0 = 0.9/kappa
  on the (r, sep) meshes (2, 4), (4, 2), (8, 1); the dynamic driver with
  the default first_mode on (2, 4) and (4, 2), with a pinned l, with
  first_mode="householder" on (8, 1) (and refused on sep > 1), and at
  kappa = 1e10 (the extreme regime) on (2, 4) and (8, 1); the plan
  path at (256, 128) on (2, 4); the escalation ladder on a grouped plan;
  ``compressed_psum`` over the "zolo" axis of (2, 4).
* The port's world: one subprocess spawning 8 gloo ranks on the CPU runs
  the same inputs through the port, every rank with the full input.

Both write their results to a temporary directory; each comparison
below is a test of its own.  Tolerances: Q against the reference's
grouped Q within 1e-10 (the reference's own grouped-vs-single bound);
orthogonality < 1e-13 and ||QH - A||_F/||A||_F < 1e-12; the port's
grouped Q against its single-device ``zolo_pd_static`` within 1e-10;
dynamic l_init within 1e-12 relative; singular values within 1e-11
(the reference's bound against numpy); ``compressed_psum`` within
1e-12.  Every result must be bit-identical on the 8 ranks.

Hang safety: ``init_process_group`` has a timeout, the ranks are joined
with one, and each world runs under a subprocess timeout.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import make_matrix  # noqa: E402
from repro.analysis import jaxpr_audit as JA  # noqa: E402
from repro.core import svd as jsvd  # noqa: E402
from repro.dist import grouped as jgrouped  # noqa: E402
from repro_torch.analysis.plan_audit import \
    executed_dynamic_psums  # noqa: E402
from repro_torch.core import coeffs as tcoeffs  # noqa: E402
from repro_torch.core import qdwh as tqdwh  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.core import svd as tsvd  # noqa: E402
from repro_torch.core import zolo as tzolo  # noqa: E402
from repro_torch.dist import grouped as tgrouped  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
M, N, KAPPA = 260, 96, 9.06e3
L0 = 0.9 / KAPPA
PLAN_SHAPE, PLAN_KAPPA = (256, 128), 1e4
HARD_KAPPA = 1e10   # the run-time bound in the extreme regime
# the bf16 compute plan: the reference's bf16 shape and criteria
# (tests/test_bf16_envelope.py, tests/test_torch_compute_dtype.py)
BF16_SHAPE, BF16_KAPPA, BF16_SEED = (192, 96), 1.0e3, 11
BF16_EPS = 2.0 ** -7
MESHES = ((2, 4), (4, 2), (8, 1))
DYN_MESHES = ((2, 4), (4, 2))
WORLD = 8
CPSUM_SHAPE, CPSUM_RANK = (64, 48), 4
WORLD_TIMEOUT = 240   # seconds, each subprocess
Q_TOL = 1e-10

_REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_ENABLE_X64"] = "1"
sys.path.insert(0, "src")
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
import repro.solver as S
from repro.dist import (grouped_zolo_pd_dynamic, grouped_zolo_pd_static,
                        zolo_group_mesh)
from repro.optim.compression import compressed_psum
from repro.resilience import SolveFailure, solve_with_escalation

out_dir = sys.argv[1]
d = np.load(os.path.join(out_dir, "inputs.npz"))
c = json.loads(open(os.path.join(out_dir, "consts.json")).read())
a = jnp.asarray(d["a"])
l0 = c["l0"]
arrays, meta = {}, {}


def trail(tr):
    return [[t.rung, t.reason, t.outcome, t.config.method] for t in tr]


def jitted(driver, **kw):
    # one compiled executable per case (eager shard_map dispatches op
    # by op, ten times slower)
    return jax.jit(lambda x: driver(x, **kw))


def dynamic(key, **kw):
    q, info = jitted(grouped_zolo_pd_dynamic, return_info=True, **kw)(a)
    arrays[key] = np.asarray(q)
    meta[key] = {"iterations": int(info.iterations),
                 "l_init": float(info.l_init)}


for r, sep in c["meshes"]:
    mesh = zolo_group_mesh(r)
    assert mesh.shape == {"zolo": r, "sep": sep}
    arrays[f"static_{r}x{sep}"] = np.asarray(
        jitted(grouped_zolo_pd_static, mesh=mesh, l0=l0, r=r)(a))
for r, sep in c["dyn_meshes"]:
    dynamic(f"dynamic_{r}x{sep}", mesh=zolo_group_mesh(r))
dynamic("dynamic_l_2x4", mesh=zolo_group_mesh(2), l=l0)
dynamic("dynamic_hh_8x1", mesh=zolo_group_mesh(8), first_mode="householder")
a = jnp.asarray(d["a_hard"])
for r, sep in ((2, 4), (8, 1)):
    dynamic(f"dynamic_hard_{r}x{sep}", mesh=zolo_group_mesh(r))
a = jnp.asarray(d["a"])
try:
    grouped_zolo_pd_dynamic(a, mesh=zolo_group_mesh(2),
                            first_mode="householder")
except ValueError as e:
    meta["dynamic_hh_refused"] = str(e)

mesh = zolo_group_mesh(2)
ap = jnp.asarray(d["a_plan"])
for name, cfg in (("plan_static", S.SvdConfig(kappa=c["plan_kappa"],
                                              l0_policy="estimate_at_plan")),
                  ("plan_dynamic", S.SvdConfig(l0_policy="runtime"))):
    p = S.plan(cfg, ap.shape, ap.dtype, mesh=mesh)
    meta[name] = {"mode": p.mode, "r": p.r, "sep": p.sep,
                  "method": p.method, "flops": float(p.flops_estimate)}
    q, h, _ = p.polar(ap)
    u, s, vh = p.svd(ap)
    arrays[name + "_q"], arrays[name + "_s"] = np.asarray(q), np.asarray(s)
try:
    S.plan(S.SvdConfig(kappa=c["plan_kappa"], l0_policy="estimate_at_plan",
                       qr_mode="householder"), ap.shape, ap.dtype, mesh=mesh)
except ValueError as e:
    meta["plan_hh_refused"] = str(e)

lcfg = S.SvdConfig(method="zolo_grouped", kappa=c["kappa"],
                   l0_policy="estimate_at_plan")
u, s, vh, tr = solve_with_escalation(a, lcfg, mesh=mesh)
meta["ladder_passed"] = trail(tr)
arrays["ladder_s"] = np.asarray(s)
try:
    solve_with_escalation(a, lcfg, mesh=mesh, orth_tol=0.0)
except SolveFailure as e:
    meta["ladder_exhausted"] = trail(e.trail)

spec = P(("zolo", "sep"))
f = shard_map(lambda g, e, q: compressed_psum(g, e, q, c["cpsum_rank"],
                                              "zolo"),
              mesh=mesh, in_specs=(spec, spec, P()),
              out_specs=(spec, spec, spec), check_rep=False)
g_hat, err, q = f(jnp.asarray(d["g"]), jnp.asarray(d["err"]),
                  jnp.asarray(d["q_prev"]))
arrays["cpsum_g_hat"] = np.asarray(g_hat)
arrays["cpsum_err"] = np.asarray(err)
arrays["cpsum_q"] = np.asarray(q)

ab = jnp.asarray(d["a_bf16"])
p = S.plan(S.SvdConfig(kappa=c["bf16_kappa"], l0_policy="estimate_at_plan",
                       compute_dtype="bfloat16"), ab.shape, ab.dtype,
           mesh=zolo_group_mesh(4))
meta["bf16_plan"] = {"mode": p.mode, "r": p.r, "sep": p.sep,
                     "method": p.method, "steps": len(p.schedule)}
for key, x in zip(("bf16_u", "bf16_s", "bf16_vh"), p.svd(ab)):
    arrays[key] = np.asarray(x)

np.savez(os.path.join(out_dir, "ref.npz"), **arrays)
with open(os.path.join(out_dir, "ref.json"), "w") as fh:
    json.dump(meta, fh)
print("REF_OK")
"""

_PORT_SCRIPT = r"""
import datetime, json, os, sys
sys.path.insert(0, "src")
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, out_dir, c):
    import repro_torch.solver as S
    from repro_torch import interop, polar_decompose, polar_svd
    from repro_torch.dist import (grouped_zolo_pd_dynamic,
                                  grouped_zolo_pd_static, zolo_group_mesh)
    from repro_torch.optim import compressed_psum
    from repro_torch.resilience import SolveFailure, solve_with_escalation

    d = np.load(os.path.join(out_dir, "inputs.npz"))
    a = torch.from_numpy(d["a"])
    l0 = c["l0"]
    arrays, meta = {}, {}
    meshes = {r: zolo_group_mesh(r, device="cpu") for r in (2, 4, 8)}
    axis = {}
    for mesh in meshes.values():
        axis[id(mesh.sep_group)], axis[id(mesh.zolo_group)] = "sep", "zolo"
    calls = []
    real = dist.all_reduce

    def counted(t, *args, group=None, **kw):
        calls.append((axis[id(group)], tuple(t.shape)))
        return real(t, *args, group=group, **kw)

    dist.all_reduce = counted

    def case(name, fn):
        calls.clear()
        out = fn()
        meta.setdefault("counts", {})[name] = {
            ax: sum(1 for x, _ in calls if x == ax) for ax in ("sep", "zolo")}
        meta.setdefault("zolo_shapes", {})[name] = sorted(
            {s for x, s in calls if x == "zolo"})
        return out

    def trail(tr):
        return [[t.rung, t.reason, t.outcome, t.config.method] for t in tr]

    for r, sep in c["meshes"]:
        mesh = meshes[r]
        assert mesh.shape == {"zolo": r, "sep": sep}
        meta.setdefault("position", {})[f"{r}x{sep}"] = [mesh.zolo_index,
                                                          mesh.sep_index]
        arrays[f"static_{r}x{sep}"] = case(
            f"static_{r}x{sep}",
            lambda: grouped_zolo_pd_static(a, mesh=mesh, l0=l0, r=r))
    for r, sep in c["dyn_meshes"]:
        q, info = case(f"dynamic_{r}x{sep}", lambda: grouped_zolo_pd_dynamic(
            a, mesh=meshes[r], return_info=True))
        arrays[f"dynamic_{r}x{sep}"] = q
        meta[f"dynamic_{r}x{sep}"] = {"iterations": int(info.iterations),
                                      "l_init": float(info.l_init)}
    q, info = case("dynamic_l_2x4", lambda: grouped_zolo_pd_dynamic(
        a, mesh=meshes[2], l=l0, return_info=True))
    arrays["dynamic_l_2x4"] = q
    meta["dynamic_l_2x4"] = {"iterations": int(info.iterations),
                             "l_init": float(info.l_init)}
    q, info = case("dynamic_hh_8x1", lambda: grouped_zolo_pd_dynamic(
        a, mesh=meshes[8], first_mode="householder", return_info=True))
    arrays["dynamic_hh_8x1"] = q
    meta["dynamic_hh_8x1"] = {"iterations": int(info.iterations),
                              "l_init": float(info.l_init)}
    try:
        grouped_zolo_pd_dynamic(a, mesh=meshes[2], first_mode="householder")
    except ValueError as e:
        meta["dynamic_hh_refused"] = str(e)
    hard = torch.from_numpy(d["a_hard"])
    for r, sep in ((2, 4), (8, 1)):
        key = f"dynamic_hard_{r}x{sep}"
        q, info = case(key, lambda: grouped_zolo_pd_dynamic(
            hard, mesh=meshes[r], return_info=True))
        arrays[key] = q
        meta[key] = {"iterations": int(info.iterations),
                     "l_init": float(info.l_init)}

    mesh = meshes[2]
    ap = torch.from_numpy(d["a_plan"])
    for name, cfg in (("plan_static", S.SvdConfig(
            kappa=c["plan_kappa"], l0_policy="estimate_at_plan")),
            ("plan_dynamic", S.SvdConfig(l0_policy="runtime"))):
        p = S.plan(cfg, tuple(ap.shape), ap.dtype, mesh=mesh)
        meta[name] = {"mode": p.mode, "r": p.r, "sep": p.sep,
                      "method": p.method, "flops": p.flops_estimate()}
        q, h, _ = p.polar(ap)
        u, s, vh = p.svd(ap)
        arrays[name + "_q"], arrays[name + "_s"] = q, s
        try:
            p.svd_batched(ap[None])
        except ValueError as e:
            meta[name + "_batched_refused"] = str(e)
    try:
        S.plan(S.SvdConfig(kappa=c["plan_kappa"], l0_policy="estimate_at_plan",
                           qr_mode="householder"), tuple(ap.shape), ap.dtype,
               mesh=mesh)
    except ValueError as e:
        meta["plan_hh_refused"] = str(e)
    try:
        zolo_group_mesh(3, device="cpu")
    except ValueError as e:
        meta["divisor_error"] = str(e)

    arrays["wrapper_q"], _, _ = polar_decompose(
        a, method="zolo_grouped", mesh=mesh, l0=l0, want_h=True)
    arrays["wrapper_s"] = polar_svd(a, method="zolo_grouped", mesh=mesh,
                                    l0=l0)[1]

    lcfg = S.SvdConfig(method="zolo_grouped", kappa=c["kappa"],
                       l0_policy="estimate_at_plan")
    u, s, vh, tr = solve_with_escalation(a, lcfg, mesh=mesh)
    meta["ladder_passed"] = trail(tr)
    arrays["ladder_s"] = s
    try:
        solve_with_escalation(a, lcfg, mesh=mesh, orth_tol=0.0)
    except SolveFailure as e:
        meta["ladder_exhausted"] = trail(e.trail)

    g_hat, err, q = compressed_psum(
        torch.from_numpy(d["g"][rank]), torch.from_numpy(d["err"][rank]),
        torch.from_numpy(d["q_prev"]), c["cpsum_rank"], mesh.zolo_group)
    arrays["cpsum_g_hat"], arrays["cpsum_err"], arrays["cpsum_q"] = \
        g_hat, err, q
    dist.all_reduce = real

    # the plan audit on (4, 2): the static plan and the dynamic one, on a
    for name, cfg in (("audit_static_4x2", S.SvdConfig(
            method="zolo_grouped", l0=l0)),
            ("audit_dynamic_4x2", S.SvdConfig(l0_policy="runtime"))):
        p = S.plan(cfg, tuple(a.shape), a.dtype, mesh=meshes[4])
        rep = p.audit(a)
        meta[name] = {"ok": rep.ok, "violations": rep.violations,
                      "method": p.method, "psums": rep.psum_counts,
                      "expect": rep.expect_psums,
                      "collectives": rep.collectives,
                      "schedule": (None if p.schedule is None
                                   else len(p.schedule))}

    # a bf16 compute plan on (4, 2), with the reference's bf16 start vector
    ab = torch.from_numpy(d["a_bf16"])
    p = S.plan(S.SvdConfig(kappa=c["bf16_kappa"], l0_policy="estimate_at_plan",
                           compute_dtype="bfloat16"), tuple(ab.shape),
               ab.dtype, mesh=meshes[4])
    p = interop.with_state(p, start_vector=d["v0_bf16"])
    meta["bf16_plan"] = {"mode": p.mode, "r": p.r, "sep": p.sep,
                         "method": p.method, "steps": len(p.schedule)}
    for key, x in zip(("bf16_u", "bf16_s", "bf16_vh"), p.svd(ab)):
        assert x.dtype == torch.float32, (key, x.dtype)
        arrays[key] = x

    # a grid over a sub-group: ranks 0 and 1 as (2, 1), None elsewhere
    sub = zolo_group_mesh(2, group=dist.new_group([0, 1]), device="cpu")
    meta["subgroup"] = None if sub is None else {"shape": sub.shape,
                                                 "ranks": sub.ranks}
    if sub is not None:
        arrays["static_sub_2x1"] = grouped_zolo_pd_static(a, mesh=sub,
                                                          l0=l0, r=2)

    np.savez(os.path.join(out_dir, f"port_{rank}.npz"),
             **{k: v.numpy() for k, v in arrays.items()})
    with open(os.path.join(out_dir, f"port_{rank}.json"), "w") as fh:
        json.dump(meta, fh)


def work(rank, out_dir, c):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "init"),
        rank=rank, world_size=c["world"],
        timeout=datetime.timedelta(seconds=c["timeout"] // 2))
    try:
        run(rank, out_dir, c)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    out_dir = sys.argv[1]
    c = json.loads(open(os.path.join(out_dir, "consts.json")).read())
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=work, args=(r, out_dir, c))
             for r in range(c["world"])]
    for p in procs:
        p.start()
    for p in procs:
        p.join(c["timeout"] - 20)
    for p in procs:
        if p.is_alive():
            p.kill()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * c["world"], codes
    print("PORT_OK")
"""


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


def _inputs():
    rng = np.random.default_rng(23)
    world = {"a": np.asarray(make_matrix(M, N, KAPPA, seed=7)),
             "a_plan": np.asarray(make_matrix(*PLAN_SHAPE, PLAN_KAPPA,
                                              seed=11)),
             "a_hard": np.asarray(make_matrix(M, N, HARD_KAPPA, seed=13)),
             "g": rng.standard_normal((WORLD,) + CPSUM_SHAPE),
             "err": 1e-3 * rng.standard_normal((WORLD,) + CPSUM_SHAPE),
             "q_prev": rng.standard_normal((CPSUM_SHAPE[1], CPSUM_RANK)),
             "a_bf16": np.asarray(make_matrix(*BF16_SHAPE, BF16_KAPPA,
                                              dtype=jnp.float32,
                                              seed=BF16_SEED)),
             # the reference's prescale draws its start vector in bf16
             "v0_bf16": np.asarray(jax.random.normal(
                 jax.random.PRNGKey(0), (min(BF16_SHAPE),), jnp.bfloat16)
                 .astype(jnp.float32))}
    consts = {"l0": L0, "kappa": KAPPA, "plan_kappa": PLAN_KAPPA,
              "meshes": MESHES, "dyn_meshes": DYN_MESHES, "world": WORLD,
              "cpsum_rank": CPSUM_RANK, "timeout": WORLD_TIMEOUT,
              "bf16_kappa": BF16_KAPPA}
    return world, consts


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Run both worlds at once (each in its own subprocess, under its own
    timeout) on the same inputs; returns (inputs, ref, port) with
    ``ref = (arrays, meta)`` and ``port`` a list of per-rank ones."""
    out = tmp_path_factory.mktemp("grouped_worlds")
    world, consts = _inputs()
    np.savez(out / "inputs.npz", **world)
    (out / "consts.json").write_text(json.dumps(consts))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = {}
    for name, script in (("ref", _REF_SCRIPT), ("port", _PORT_SCRIPT)):
        path = out / f"{name}_world.py"
        path.write_text(script)
        procs[name] = subprocess.Popen(
            [sys.executable, str(path), str(out)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    logs = {}
    for name, p in procs.items():
        try:
            logs[name] = p.communicate(timeout=WORLD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"the {name} world timed out after "
                        f"{WORLD_TIMEOUT} s")
    for name, marker in (("ref", "REF_OK"), ("port", "PORT_OK")):
        stdout, stderr = logs[name]
        assert marker in stdout, stdout[-2000:] + stderr[-4000:]

    def load(stem):
        with np.load(out / f"{stem}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        return arrays, json.loads((out / f"{stem}.json").read_text())

    return world, load("ref"), [load(f"port_{r}") for r in range(WORLD)]


def _tag(rs):
    return f"{rs[0]}x{rs[1]}"


def port_of(worlds):
    return worlds[2]


def _err(x, y):
    return float(np.abs(np.asarray(x) - np.asarray(y)).max())


def _polar_quality(a, q):
    at, qt = torch.from_numpy(a), torch.from_numpy(q)
    h = tqdwh.form_h(qt, at)
    rec = float(torch.linalg.matrix_norm(qt @ h - at)
                / torch.linalg.matrix_norm(at))
    return float(tsvd.orthogonality(qt)), rec


# --- static driver -----------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_static_q_matches_the_reference(worlds, mesh):
    _, (ref, _), port = worlds
    key = f"static_{_tag(mesh)}"
    assert _err(port[0][0][key], ref[key]) < Q_TOL


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_static_q_is_orthogonal_and_reconstructs(worlds, mesh):
    world, _, port = worlds
    orth, rec = _polar_quality(world["a"], port[0][0][f"static_{_tag(mesh)}"])
    assert orth < 1e-13 and rec < 1e-12, (orth, rec)


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_static_q_matches_the_single_device_engine(worlds, mesh):
    world, _, port = worlds
    q1, _, _ = tzolo.zolo_pd_static(torch.from_numpy(world["a"]), l0=L0,
                                    r=mesh[0])
    assert _err(port[0][0][f"static_{_tag(mesh)}"], q1) < Q_TOL


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_every_rank_holds_its_row_block(worlds, mesh):
    """The "zolo" combine all-reduces this rank's local iterate, so its
    shape is the per-rank block: (m_pad / sep, n) with m_pad = 260
    padded to a multiple of sep; and ranks sit at (rank // sep, rank %
    sep)."""
    r, sep = mesh
    m_pad = M + (-M) % sep
    for rank, (_, meta) in enumerate(port_of(worlds)):
        assert meta["position"][_tag(mesh)] == list(divmod(rank, sep))
        assert meta["zolo_shapes"][f"static_{_tag(mesh)}"] == \
            [[m_pad // sep, N]]


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_static_all_reduces_follow_the_reference_budget(worlds, mesh):
    """At sep > 1 each rank issues exactly the reference's per-axis psum
    budget (``expected_grouped_psums``); at sep = 1 the one-rank "sep"
    all-reduces are not issued (a deliberate divergence)."""
    r, sep = mesh
    sched = tuple(tcoeffs.zolo_schedule_np(L0, r, max_iters=6))
    want = JA.expected_grouped_psums(
        "zolo_grouped", {"schedule": sched, "qr_mode": "cholqr2",
                         "qr_iters": 1}, sep=sep)
    if sep == 1:
        want = dict(want, sep=0)
    for _, meta in port_of(worlds):
        assert meta["counts"][f"static_{_tag(mesh)}"] == want


# --- dynamic driver ----------------------------------------------------------


@pytest.mark.parametrize("mesh", DYN_MESHES, ids=_tag)
def test_dynamic_q_matches_the_reference(worlds, mesh):
    world, (ref, _), port = worlds
    key = f"dynamic_{_tag(mesh)}"
    assert _err(port[0][0][key], ref[key]) < Q_TOL
    orth, rec = _polar_quality(world["a"], port[0][0][key])
    assert orth < 1e-13 and rec < 1e-12, (orth, rec)


@pytest.mark.parametrize("key", ["dynamic_2x4", "dynamic_4x2",
                                 "dynamic_l_2x4", "dynamic_hh_8x1",
                                 "dynamic_hard_2x4", "dynamic_hard_8x1"])
def test_dynamic_iterations_and_l_init_agree(worlds, key):
    """Iterations equal to the reference's and on every rank (the host
    loop's stop test is the same on all of them), l_init within 1e-12
    relative."""
    _, (_, rmeta), port = worlds
    got = [meta[key] for _, meta in port]
    assert all(g == got[0] for g in got), got
    assert got[0]["iterations"] == rmeta[key]["iterations"]
    assert got[0]["l_init"] == pytest.approx(rmeta[key]["l_init"],
                                             rel=1e-12)


@pytest.mark.parametrize("mesh", DYN_MESHES, ids=_tag)
def test_dynamic_all_reduces_follow_the_reference_budget(worlds, mesh):
    """kappa = 9.06e3 puts l0 in the CholeskyQR2 regime (10 sqrt(eps) <=
    l0 < 0.05), so the executed first branch is cholqr2."""
    key = f"dynamic_{_tag(mesh)}"
    for _, meta in port_of(worlds):
        iters = meta[key]["iterations"]
        assert meta["counts"][key] == executed_dynamic_psums("cholqr2",
                                                              iters)


def test_plan_audits_hold_the_budget(worlds):
    """``plan.audit()`` on every rank of the (4, 2) grid: the static
    plan's all-reduces per axis are the reference's budget
    (``expected_grouped_psums``), the dynamic plan's those of the
    branches it ran (``executed_dynamic_psums``: CholeskyQR2 first at
    kappa = 9.06e3, the solve's iterations); the sep group's one gather
    is an axis-bound collective."""
    for _, meta in port_of(worlds):
        st, dy = meta["audit_static_4x2"], meta["audit_dynamic_4x2"]
        assert st["method"] == "zolo_grouped"
        assert dy["method"] == "zolo_grouped_dynamic"
        sched = tuple(tcoeffs.zolo_schedule_np(L0, 4, max_iters=6))
        assert st["schedule"] == len(sched)
        want = JA.expected_grouped_psums(
            "zolo_grouped", {"schedule": sched, "qr_mode": "cholqr2",
                             "qr_iters": 1}, sep=2)
        assert st["ok"] and st["psums"] == st["expect"] == want
        iters = meta["dynamic_4x2"]["iterations"]
        want = executed_dynamic_psums("cholqr2", iters)
        assert dy["ok"] and dy["psums"] == dy["expect"] == want
        for rec in (st, dy):
            assert rec["collectives"]["sep:allgather_"] == 1


@pytest.mark.parametrize("key", ["dynamic_l_2x4", "dynamic_hh_8x1"])
def test_dynamic_pinned_l_and_householder_match_the_reference(worlds, key):
    world, (ref, _), port = worlds
    assert _err(port[0][0][key], ref[key]) < Q_TOL
    orth, _ = _polar_quality(world["a"], port[0][0][key])
    assert orth < 1e-13
    meta = port[0][1]
    iters = meta[key]["iterations"]
    if key == "dynamic_l_2x4":  # a pinned bound skips the estimate
        want = executed_dynamic_psums("cholqr2", iters, estimate=False)
    else:  # sep = 1: no "sep" all-reduce at all
        want = {"sep": 0, "zolo": iters}
    assert meta["counts"][key] == want


@pytest.mark.parametrize("mesh", [(2, 4), (8, 1)], ids=_tag)
def test_extreme_regime_first_iteration(worlds, mesh):
    """kappa = 1e10 puts the run-time bound below 10 sqrt(eps): the first
    iteration is the structured Householder QR on a sep = 1 mesh and
    shifted CholeskyQR2 in its place on a sep > 1 one (its two "sep"
    Gram all-reduces show which ran), in both packages.  At this kappa
    an f64 polar factor is determined only to about eps kappa (2.2e-6),
    which bounds the two packages' difference; orthogonality is held to
    twice the reference's."""
    world, (ref, _), port = worlds
    key = f"dynamic_hard_{_tag(mesh)}"
    got, want = port[0][0][key], ref[key]
    assert _err(got, want) < np.finfo(np.float64).eps * HARD_KAPPA
    orth, rec = _polar_quality(world["a_hard"], got)
    orth_ref, _ = _polar_quality(world["a_hard"], want)
    assert orth <= 2 * orth_ref + 1e-13 and rec < 1e-12, (orth, orth_ref)
    for _, meta in port:
        iters = meta[key]["iterations"]
        want_c = (executed_dynamic_psums("cholqr2", iters) if mesh[1] > 1
                  else {"sep": 0, "zolo": iters})
        assert meta["counts"][key] == want_c


def test_householder_is_refused_on_a_sep_mesh(worlds):
    _, (_, rmeta), port = worlds
    meta = port[0][1]
    for key, words in (("dynamic_hh_refused", ("first_mode", "sep")),
                       ("plan_hh_refused", ("householder", "sep"))):
        assert key in rmeta and key in meta, key
        assert all(w in meta[key] for w in words), meta[key]


# --- the plan path -----------------------------------------------------------


@pytest.mark.parametrize("name", ["plan_static", "plan_dynamic"])
def test_plan_resolves_as_the_reference(worlds, name):
    _, (_, rmeta), port = worlds
    got = port[0][1][name]
    want = rmeta[name]
    assert {k: got[k] for k in ("mode", "r", "sep", "method")} == \
        {k: want[k] for k in ("mode", "r", "sep", "method")}
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-12)


@pytest.mark.parametrize("name", ["plan_static", "plan_dynamic"])
def test_plan_solves_match_the_reference(worlds, name):
    world, (ref, _), port = worlds
    arrays = port[0][0]
    assert _err(arrays[name + "_q"], ref[name + "_q"]) < Q_TOL
    s_np = np.linalg.svd(world["a_plan"], compute_uv=False)
    assert _err(arrays[name + "_s"], s_np) < 1e-11
    assert _err(arrays[name + "_s"], ref[name + "_s"]) < 1e-11


@pytest.mark.parametrize("key", ["static_2x4", "static_4x2", "static_8x1",
                                 "dynamic_2x4", "dynamic_4x2",
                                 "dynamic_hard_2x4", "dynamic_hard_8x1",
                                 "plan_static_q", "plan_static_s",
                                 "plan_dynamic_s", "ladder_s",
                                 "wrapper_q"])
def test_results_are_identical_on_every_rank(worlds, key):
    """SPMD contract: every rank returns the full, identical result."""
    port = port_of(worlds)
    first = port[0][0][key]
    for arrays, _ in port[1:]:
        assert np.array_equal(arrays[key], first), key


def test_a_mesh_over_a_sub_group(worlds):
    """``zolo_group_mesh(r, group=)`` lays the grid over that group's
    ranks and gives the others None; the (2, 1) grid over ranks 0 and 1
    gives the (2, 4) grid's Q (the reference's sep > 1 against sep = 1
    parity)."""
    port = port_of(worlds)
    for rank, (arrays, meta) in enumerate(port):
        if rank < 2:
            assert meta["subgroup"] == {"shape": {"zolo": 2, "sep": 1},
                                        "ranks": [[0], [1]]}
            assert _err(arrays["static_sub_2x1"],
                        port[0][0]["static_2x4"]) < Q_TOL
        else:
            assert meta["subgroup"] is None


def test_mesh_errors_and_batched_plans_are_refused(worlds):
    meta = port_of(worlds)[0][1]
    assert "r=3" in meta["divisor_error"]
    assert "[1, 2, 4, 8]" in meta["divisor_error"]
    for name in ("plan_static", "plan_dynamic"):
        assert "batching is not supported" in meta[name + "_batched_refused"]


def test_the_one_call_wrappers_route_through_the_mesh(worlds):
    world, (ref, _), port = worlds
    arrays = port[0][0]
    assert _err(arrays["wrapper_q"], ref["static_2x4"]) < Q_TOL
    s_np = np.linalg.svd(world["a"], compute_uv=False)
    assert _err(arrays["wrapper_s"], s_np) < 1e-11


# --- resilience and the optimizer --------------------------------------------


@pytest.mark.parametrize("key", ["ladder_passed", "ladder_exhausted"])
def test_grouped_ladder_trail_matches_the_reference(worlds, key):
    """The ladder on a grouped plan: healthy at rung 0; with orth_tol=0
    every rung fails, and the householder rung is a plan error on the
    sep = 4 mesh, recorded and skipped, in both packages."""
    _, (ref, rmeta), port = worlds
    for _, meta in port:
        assert meta[key] == rmeta[key], (meta[key], rmeta[key])
    if key == "ladder_passed":
        assert _err(port[0][0]["ladder_s"], ref["ladder_s"]) < 1e-12
    else:
        assert [t[2] for t in rmeta[key]] == ["failed", "plan-error",
                                              "failed"]


def test_compressed_psum_matches_the_reference(worlds):
    _, (ref, _), port = worlds
    for rank, (arrays, _) in enumerate(port):
        for name in ("g_hat", "err", "q"):
            got, want = arrays[f"cpsum_{name}"], ref[f"cpsum_{name}"][rank]
            assert _err(got, want) < 1e-12, (rank, name)


# --- in-process: the cost models and mesh validation -------------------------


@pytest.mark.parametrize("grouped,sep", [(False, 1), (True, 1), (True, 2),
                                         (True, 4)])
def test_flop_models_match_the_reference(grouped, sep, monkeypatch):
    kw = dict(r=2, kappa=KAPPA, grouped=grouped, sep=sep)
    for name in ("zolo_grouped", "zolo_grouped_dynamic", "zolo_static"):
        want = jsvd._registry.get_polar(name).flops_fn(*PLAN_SHAPE, **kw)
        got = registry.get_polar(name).flops_fn(*PLAN_SHAPE, **kw)
        assert got == pytest.approx(want, rel=1e-14), name
    monkeypatch.setenv("REPRO_COMM_FLOPS_PER_WORD", "7.5")
    args = (*PLAN_SHAPE, 2, 3, False)
    assert tgrouped.grouped_iteration_flops(*args, sep=sep) == \
        jgrouped.grouped_iteration_flops(*args, sep=sep)
    assert tgrouped.DEFAULT_COMM_FLOPS_PER_WORD == \
        jgrouped.DEFAULT_COMM_FLOPS_PER_WORD


def test_grouped_backends_are_registered_as_in_the_reference():
    for name in ("zolo_grouped", "zolo_grouped_dynamic", "zolo_static"):
        spec, jspec = registry.get_polar(name), jsvd._registry.get_polar(name)
        assert (spec.supports_grouped, spec.requires_mesh, spec.dynamic) == \
            (jspec.supports_grouped, jspec.requires_mesh, jspec.dynamic)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_cpu_iterate_takes_the_plain_ops(dtype):
    """The local ops follow the iterate alone: K1/K2 on a CUDA iterate of
    itemsize <= 4, the plain torch ops on a CPU iterate, whatever its
    dtype."""
    mesh = types.SimpleNamespace(r=1, sep=1, zolo_index=0, sep_index=0,
                                 zolo_group=None, sep_group=None)
    ops = tgrouped._group_ops(mesh, torch.zeros((4, 4), dtype=dtype))
    plain = tzolo.DEFAULT_OPS
    assert (ops.gram, ops.gram_local) == (plain.gram, plain.gram_local)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 4))).to(dtype)
    t = torch.from_numpy(rng.standard_normal((1, 6, 4))).to(dtype)
    got = ops.polar_update(x, t, torch.tensor([0.7], dtype=dtype), 1.3)
    want = tref.grouped_combine_ref(x, t, torch.tensor([0.7], dtype=dtype),
                                    1.3, 1.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_the_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tgrouped.zolo_group_mesh(2, device="cpu")
    import repro_torch.solver as S

    with pytest.raises(ValueError, match="mesh=zolo_group_mesh"):
        S.plan(S.SvdConfig(mode="grouped", l0=0.1), (8, 8), torch.float64,
               device="cpu")
    with pytest.raises(ValueError, match="runs grouped only"):
        S.plan(S.SvdConfig(method="zolo_grouped", l0=0.1), (8, 8),
               torch.float64, device="cpu")
    with pytest.raises(ValueError, match="zolo_group_mesh"):
        tgrouped.grouped_zolo_pd_static(torch.eye(8, dtype=torch.float64),
                                        mesh=object(), l0=0.1)


# --- the bf16 compute plan on a mesh -----------------------------------------


def test_bf16_grouped_plan_resolves_as_the_reference(worlds):
    _, (_, rmeta), port = worlds
    for _, meta in port:
        assert meta["bf16_plan"] == rmeta["bf16_plan"]
    assert rmeta["bf16_plan"]["sep"] == 2


def test_bf16_grouped_plan_matches_the_reference(worlds):
    """The (4, 2) bf16 compute plan (the K2 output all-reduced in bf16
    over the zolo group) against the reference's, held to the
    reference's bf16 criteria: s and U diag(s) Vh within eps(bf16) of
    s_max of the reference's, the top half of s within 5e-2 relative of
    the exact spectrum, and U, V orthogonal within 8 eps(bf16); every
    rank returns the same factors."""
    world, (ref, _), port = worlds
    s_exact = np.linalg.svd(world["a_bf16"].astype(np.float64),
                            compute_uv=False)
    u_j, s_j, vh_j = (ref[k].astype(np.float64)
                      for k in ("bf16_u", "bf16_s", "bf16_vh"))
    smax = float(s_j[0])
    for arrays, _ in port[1:]:
        for k in ("bf16_u", "bf16_s", "bf16_vh"):
            assert np.array_equal(arrays[k], port[0][0][k]), k
    u_t, s_t, vh_t = (port[0][0][k].astype(np.float64)
                      for k in ("bf16_u", "bf16_s", "bf16_vh"))
    assert np.max(np.abs(s_t - s_j)) / smax <= BF16_EPS
    assert np.max(np.abs((u_t * s_t) @ vh_t - (u_j * s_j) @ vh_j)) / smax \
        <= BF16_EPS
    top = slice(0, BF16_SHAPE[1] // 2)
    for u, s, vh in ((u_t, s_t, vh_t), (u_j, s_j, vh_j)):
        assert np.max(np.abs(s[top] - s_exact[top]) / s_exact[top]) <= 5e-2
        for q in (u, vh.T):
            assert float(tsvd.orthogonality(torch.from_numpy(q))) <= \
                8 * BF16_EPS
