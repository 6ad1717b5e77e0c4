"""repro_torch.analysis.plan_audit against repro.analysis.jaxpr_audit.

The same plan configs go through both audits — the reference's walks the
lowered jaxpr, the port's runs the plan under a dispatch mode — and must
reach the same verdict with the same violation class (:func:`_classes`):
a dense static f64 plan, a dense f32 plan, an f32 dynamic ``zolo`` plan
with a given l (flagged by both: its coefficients are computed in f64),
a bf16 compute plan, an f32 block-Jacobi plan (green: its f64 rotations
are the ``wide_ok`` scope) and a top-k plan.  The grouped cases (the
per-axis all-reduce budget, the double-reduced Gram the reference's
``tests/test_analysis.py`` reintroduces on purpose) run on two gloo
ranks spawned on the CPU, under a subprocess timeout.
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

import jax.numpy as jnp  # noqa: E402
from conftest import make_matrix  # noqa: E402
from repro.analysis import jaxpr_audit as JA  # noqa: E402
import repro.dist as JD  # noqa: E402
import repro.solver as JS  # noqa: E402
import repro.spectral as JSP  # noqa: E402
import repro_torch.serve as SV  # noqa: E402
import repro_torch.solver as S  # noqa: E402
import repro_torch.spectral as SP  # noqa: E402
from repro_torch.analysis import plan_audit as PA  # noqa: E402
from repro_torch.kernels import gram as kgram  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 120   # seconds, the two-rank subprocess


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


def _classes(violations):
    """The violation classes of a report, in both packages' words."""
    out = set()
    for v in violations:
        if "f64" in v:
            out.add("f64-compute")
        elif "psum" in v:
            out.add("psum-count")
        elif "collective" in v or "axis" in v:
            out.add("collective-axis")
        elif "host" in v:
            out.add("host")
        else:
            out.add(v)
    return out


# config, shape, dtype name: the reference's and the port's plans alike
PLANS = {
    "f64-static": (dict(method="zolo_static", l0=0.9 / 1e3, r=2),
                   (48, 32), "float64"),
    "f32-static": (dict(method="zolo_static", kappa=1e3,
                        l0_policy="estimate_at_plan"), (48, 32), "float32"),
    "f32-zolo-given-l": (dict(method="zolo", l0=0.9 / 1e3), (48, 32),
                         "float32"),
    "bf16-compute": (dict(method="zolo_static", kappa=1e2,
                          l0_policy="estimate_at_plan",
                          compute_dtype="bfloat16"), (64, 32), "float32"),
    "f32-jacobi": (dict(method="zolo_static", kappa=1e3,
                        l0_policy="estimate_at_plan", eig_method="jacobi"),
                   (64, 64), "float32"),
}
VERDICTS = {"f64-static": set(), "f32-static": set(),
            "f32-zolo-given-l": {"f64-compute"}, "bf16-compute": set(),
            "f32-jacobi": set()}


def _plans(name):
    cfg, shape, dtype = PLANS[name]
    jp = JS.plan(JS.SvdConfig(**cfg), shape, getattr(jnp, dtype))
    tp = S.plan(S.SvdConfig(**cfg), shape, getattr(torch, dtype),
                device="cpu")
    return jp, tp


@pytest.mark.parametrize("name", sorted(PLANS))
def test_verdict_matches_the_reference(name):
    jp, tp = _plans(name)
    jrep = JA.audit_plan(jp, raise_on_fail=False)
    trep = tp.audit(raise_on_fail=False)
    assert trep.ok == jrep.ok
    assert _classes(trep.violations) == _classes(jrep.violations) == \
        VERDICTS[name]
    assert trep.psum_counts == jrep.psum_counts == {}
    assert trep.axis_names == jrep.axis_names == ()
    assert "collective-axis-validity" in trep.checks
    assert ("no-f64-compute" in trep.checks) == \
        ("no-f64-compute" in jrep.checks)
    # on the CPU every kernel wrapper runs its plain version
    assert not any(trep.kernel_launches.values())
    assert trep.device_syncs is None
    if not trep.ok:
        with pytest.raises(PA.AuditError, match="f64"):
            tp.audit()


def test_static_plans_owe_no_host_sync_and_loops_are_reported():
    """Static + eigh: the no-host-syncs check runs and finds 0.  The
    dynamic solver's, QDWH's and the Jacobi sweeps' host reads are
    reported, never flagged."""
    _, tp = _plans("f32-static")
    rep = tp.audit()
    assert "no-host-syncs" in rep.checks and rep.host_syncs == 0
    for cfg, eig in ((dict(method="zolo", l0_policy="runtime"), "eigh"),
                     (dict(method="qdwh", l0_policy="runtime"), "eigh"),
                     (dict(method="zolo_static", kappa=1e3,
                           l0_policy="estimate_at_plan"), "jacobi")):
        p = S.plan(S.SvdConfig(eig_method=eig, **cfg), (64, 64),
                   torch.float32, device="cpu")
        rep = p.audit()
        assert rep.ok and "no-host-syncs" not in rep.checks
        assert rep.host_syncs >= 1
        assert rep.host_sync_ops.get("_local_scalar_dense", 0) >= 1


def test_jacobi_lists_its_wide_ok_scope():
    _, tp = _plans("f32-jacobi")
    rep = tp.audit()
    assert rep.ok and rep.wide_compute == 0
    assert set(rep.wide_ok) == {"block-jacobi rotations"}
    assert rep.wide_ok["block-jacobi rotations"] > 0


def test_topk_plan_verdict_matches_the_reference():
    jp = JSP.plan_topk(JSP.TopKConfig(k=4, kappa=1e4), (96, 48))
    tp = SP.plan_topk(SP.TopKConfig(k=4, kappa=1e4), (96, 48),
                      torch.float64, device="cpu")
    assert tp.strategy == jp.strategy
    jrep, trep = jp.audit(raise_on_fail=False), tp.audit()
    assert trep.ok and jrep.ok
    assert trep.psum_counts == jrep.psum_counts == {}
    assert trep.entry.startswith(f"TopKPlan[{tp.strategy}")


def test_audit_callable_checks():
    """The three checks on hand-made callables: a host read in a
    no-sync run, f64 compute outside and inside a wide_ok scope, and the
    kernel-launch counters' delta."""
    x = torch.ones((4, 4))

    def reads(t):
        return float(t.sum())

    rep = PA.audit_callable(reads, (x,), forbid_host_syncs=True,
                            raise_on_fail=False)
    assert _classes(rep.violations) == {"host"} and rep.host_syncs == 1
    assert PA.audit_callable(reads, (x,)).ok  # reported, not checked

    def wide(t):
        y = t.double() @ t.double()
        with PA.wide_ok("jacobi-svd rotations"):
            y = y @ y
        return y

    rep = PA.audit_callable(wide, (x,), forbid_wide_compute=True,
                            raise_on_fail=False)
    assert rep.wide_compute == 1 and rep.wide_ops == {"mm": 1}
    assert rep.wide_ok == {"jacobi-svd rotations": 1}
    with pytest.raises(ValueError, match="wide_ok scope"):
        PA.wide_ok("an undocumented f64 site")

    def launches(t):
        kgram.launches += 1
        kgram.launches_by_route["simt"] += 1
        return t

    before = (kgram.launches, dict(kgram.launches_by_route))
    try:
        rep = PA.audit_callable(launches, (x,))
    finally:
        kgram.launches = before[0]
        kgram.launches_by_route.update(before[1])
    assert rep.kernel_launches["gram"] == 1
    assert rep.kernel_launches["gram/simt"] == 1
    assert rep.kernel_launches["grouped_combine"] == 0


def test_expected_psum_model_matches_the_reference():
    cases = [("zolo_grouped", {"schedule": (0.0,) * 5, "qr_mode": "cholqr2",
                               "qr_iters": 1}, 1),
             ("zolo_grouped", {"schedule": (0.0,) * 3,
                               "qr_mode": "householder"}, 1),
             ("zolo_grouped_dynamic", {"first_mode": "auto"}, 1),
             ("zolo_grouped_dynamic", {"first_mode": "auto", "l": 1e-3}, 4),
             ("zolo_grouped_dynamic", {"first_mode": "chol"}, 2),
             ("zolo_static", {}, 1)]
    for method, kw, sep in cases:
        assert PA.expected_grouped_psums(method, kw, sep=sep) == \
            JA.expected_grouped_psums(method, kw, sep=sep)
    assert PA.MODE_SEP_PSUMS == JA.MODE_SEP_PSUMS
    # the executed branches: estimate + CholeskyQR2 + residual, then one
    # Gram and one residual per Cholesky iteration
    assert PA.executed_dynamic_psums("cholqr2", 3) == {"sep": 8, "zolo": 3}
    assert PA.executed_dynamic_psums("householder", 1,
                                     estimate=False) == {"sep": 1,
                                                         "zolo": 1}


def test_audit_input_is_deterministic():
    a = PA.audit_input((40, 24), torch.float64, "cpu", kappa=1e3)
    assert torch.equal(a, PA.audit_input((40, 24), torch.float64, "cpu",
                                         kappa=1e3))
    s = torch.linalg.svdvals(a)
    np.testing.assert_allclose(s.numpy(), np.geomspace(1, 1e-3, 24),
                               rtol=1e-12)
    wide = PA.audit_input((24, 40), torch.bfloat16, "cpu")
    assert wide.shape == (24, 40) and wide.dtype == torch.bfloat16


def test_plan_audit_takes_its_input():
    """``audit(a)`` runs on the given matrix, ``audit()`` on the
    deterministic one; a wrong shape is refused as by ``svd``."""
    _, tp = _plans("f64-static")
    a = torch.from_numpy(np.asarray(make_matrix(48, 32, 1e3, seed=4)))
    assert tp.audit(a).ok and tp.audit().ok
    with pytest.raises(ValueError, match="shape"):
        tp.audit(a[:40])


def test_audit_rejects_non_plan_object():
    with pytest.raises(TypeError, match="neither _svd_impl nor _impl"):
        PA.audit_plan(object())


def test_audit_all_plans_over_a_filled_cache():
    """``audit_all_plans`` walks the port's two caches: filled here with
    two green plans, a top-k plan and the flagged given-l plan, then
    restored."""
    from repro_torch.solver import planner as tplanner
    from repro_torch.spectral import topk as ttopk

    saved = (dict(tplanner._PLANS), set(tplanner._PINNED),
             dict(ttopk._TOPK_PLANS))
    try:
        S.clear_plan_cache()
        SP.clear_topk_cache()
        assert PA.audit_all_plans() == []
        for name in ("f64-static", "f32-static", "f32-zolo-given-l"):
            _plans(name)
        SP.plan_topk(SP.TopKConfig(k=4, kappa=1e4), (96, 48),
                     torch.float64, device="cpu")
        before = PA.audit_stats()
        failures = PA.audit_all_plans()
        after = PA.audit_stats()
        assert [entry for entry, _ in failures] == \
            ["SvdPlan[zolo, (48, 32), float32]"]
        assert _classes(failures[0][1]) == {"f64-compute"}
        n = len(tplanner._PLANS) + len(ttopk._TOPK_PLANS)
        assert after["audited"] - before["audited"] == n
        assert after["failed"] - before["failed"] == 1
        with pytest.raises(RuntimeError, match="plan audits failed"):
            PA.audit_all_plans(raise_on_fail=True)
    finally:
        S.clear_plan_cache()
        SP.clear_topk_cache()
        tplanner._PLANS.update(saved[0])
        tplanner._PINNED.update(saved[1])
        ttopk._TOPK_PLANS.update(saved[2])


def test_service_stats_report_plan_audits():
    before = PA.audit_stats()
    svc = SV.SvdService(SV.ServiceConfig(batch_size=2, max_wait=0.0,
                                         audit_plans=True, device="cpu"))
    svc.warmup([(48, 32)])
    audits = svc.stats()["plan_audits"]
    assert set(audits) == {"audited", "passed", "failed"}
    assert audits["audited"] == 1 and audits["failed"] == 0
    assert audits["passed"] == audits["audited"]
    after = PA.audit_stats()  # module counters are monotonic
    assert after["audited"] - before["audited"] >= audits["audited"]


def test_service_audit_off_by_default():
    svc = SV.SvdService(SV.ServiceConfig(batch_size=2, max_wait=0.0,
                                         device="cpu"))
    svc.warmup([(48, 32)])
    assert svc.stats()["plan_audits"]["audited"] == 0


# --- grouped plans on two gloo ranks -----------------------------------------

_WORLD = r"""
import datetime, json, os, sys
sys.path.insert(0, "src")
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, out_dir):
    import repro_torch.solver as S
    from repro_torch.analysis import plan_audit as PA
    from repro_torch.dist import grouped_ops as gops
    from repro_torch.dist import zolo_group_mesh

    mesh = zolo_group_mesh(1, device="cpu")   # (r, sep) = (1, 2)
    cfg = S.SvdConfig(method="zolo_grouped", kappa=3.7e3,
                      l0_policy="estimate_at_plan")
    out = {}

    def rec(name, rep):
        out[name] = {"ok": rep.ok, "violations": rep.violations,
                     "psums": rep.psum_counts, "axes": list(rep.axis_names),
                     "collectives": rep.collectives,
                     "expect": rep.expect_psums}

    p = S.plan(cfg, (64, 32), torch.float64, mesh=mesh)
    rec("static", p.audit())
    out["static_schedule"] = len(p.schedule)
    p = S.plan(S.SvdConfig(l0_policy="runtime"), (64, 32), torch.float64,
               mesh=mesh)
    rec("dynamic", p.audit())
    real = gops.sep_reduce_ops

    def double_reduced(base=None, **kw):
        ops = real(base, **kw)
        return ops._replace(gram_local=ops.gram)

    gops.sep_reduce_ops = double_reduced
    try:
        p = S.plan(cfg.replace(r=1), (64, 32), torch.float64, mesh=mesh)
        rec("double", p.audit(raise_on_fail=False))
    finally:
        gops.sep_reduce_ops = real
    t = torch.ones(3)
    rec("non_grouped", PA.audit_callable(
        lambda x: dist.all_reduce(x), (t,), allow_collectives=False,
        raise_on_fail=False))
    rec("unbound", PA.audit_callable(
        lambda x: dist.all_reduce(x), (t,), axes={mesh.sep_group: "sep"},
        raise_on_fail=False))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def work(rank, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "init"),
        rank=rank, world_size=2, timeout=datetime.timedelta(seconds=60))
    try:
        run(rank, out_dir)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [mp.get_context("spawn").Process(target=work,
                                             args=(r, sys.argv[1]))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(100)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0], [p.exitcode for p in procs]
    print("WORLD_OK")
"""


@pytest.fixture(scope="module")
def grouped_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("audit_world")
    script = out / "world.py"
    script.write_text(_WORLD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(script), str(out)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=WORLD_TIMEOUT)
    assert "WORLD_OK" in proc.stdout, proc.stdout[-2000:] + \
        proc.stderr[-4000:]
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(2)]


def test_grouped_static_audit_holds_the_budget(grouped_world):
    """(r, sep) = (1, 2): the "sep" all-reduces are the reference's budget
    and the one-rank "zolo" axis owes none; the sep group's gather is an
    axis-bound collective."""
    for rank in grouped_world:
        st = rank["static"]
        iters = rank["static_schedule"]
        want = JA.expected_grouped_psums(
            "zolo_grouped", {"schedule": (0.0,) * iters}, sep=2)
        assert st["ok"], st["violations"]
        assert st["psums"] == {"sep": want["sep"]}
        assert st["expect"] == {"sep": want["sep"], "zolo": 0}
        assert st["axes"] == ["sep"]
        assert st["collectives"]["sep:allgather_"] == 1


def test_grouped_dynamic_audit_holds_the_executed_budget(grouped_world):
    for rank in grouped_world:
        dy = rank["dynamic"]
        assert dy["ok"], dy["violations"]
        assert dy["psums"] == {"sep": dy["expect"]["sep"]}
        assert dy["expect"]["zolo"] == 0


def test_double_reduced_gram_is_flagged(grouped_world):
    """The reference's regression reintroduced on purpose: a bundle whose
    gram_local all-reduces makes CholeskyQR2's Q2-Gram reduce twice.  Both
    audits reject it in the psum-count class, with the double-psum
    diagnosis."""
    from repro.dist import grouped_ops as jgops
    from repro.solver import planner as jplanner

    real = jgops.sep_reduce_ops

    def double_reduced(base=None, *, axis="sep"):
        ops = real(base, axis=axis)
        return ops._replace(gram_local=ops.gram)

    jgops.sep_reduce_ops = double_reduced
    try:
        jp = JS.plan(JS.SvdConfig(method="zolo_grouped", kappa=3.7e3,
                                  l0_policy="estimate_at_plan"),
                     (64, 32), jnp.float64, mesh=JD.zolo_group_mesh(1))
        jrep = JA.audit_plan(jp, raise_on_fail=False)
    finally:
        jgops.sep_reduce_ops = real
        for key in [k for k, v in jplanner._PLANS.items() if v is jp]:
            del jplanner._PLANS[key]
    for rank in grouped_world:
        db = rank["double"]
        assert not db["ok"] and not jrep.ok
        assert _classes(db["violations"]) == _classes(jrep.violations) == \
            {"psum-count"}
        joined = "\n".join(db["violations"])
        assert "'sep'" in joined and "gram_local" in joined
        assert db["psums"]["sep"] == rank["static"]["psums"]["sep"] + 1


def test_stray_collectives_are_flagged(grouped_world):
    for rank in grouped_world:
        assert _classes(rank["non_grouped"]["violations"]) == \
            {"collective-axis"}
        assert "non-grouped" in rank["non_grouped"]["violations"][0]
        assert "not bound" in rank["unbound"]["violations"][0]
        assert rank["unbound"]["axes"] == ["unbound"]
