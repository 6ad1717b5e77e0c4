"""repro_torch.serve (the SVD service) against repro.serve.

The cases of ``tests/test_svd_service.py`` and the service cases of
``tests/test_resilience.py``, ported.  Where a case runs a stream, the
same numpy matrices go through the reference's service (f64, x64) and
the port's (on the CPU), with the same fake clock, and:

* the bucket keys are equal, and so are the ``stats()`` counters
  (:data:`COUNTERS`: batches, slots, pad waste, slot fill, hit rate,
  retraces, retries, quarantined, deadlines, dispatch errors and the
  breaker counts);
* per request, s is within 1e-12 s_max of the reference's and
  ||A - U S Vh||_F / ||A||_F <= 1e-12.

The bf16 lane is held to the reference's bf16 criteria, the top-k lane
and the rank-deficient round trip to the reference test's own bounds
against numpy.  ``retraces`` counts backend traces in the reference and
plan constructions in the port; both are 0 over a warmed stream and
compared wherever no retry climbs to a rung plan (``_same_stats``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from conftest import make_matrix  # noqa: E402
import repro.resilience as JR  # noqa: E402
import repro.serve as JSV  # noqa: E402
from repro.launch import svd_serve as jlaunch  # noqa: E402
import repro_torch.resilience as R  # noqa: E402
import repro_torch.serve as SV  # noqa: E402
import repro_torch.solver as S  # noqa: E402
from repro_torch.launch import svd_serve as tlaunch  # noqa: E402
from repro_torch.serve.bucketing import pad_waste  # noqa: E402
from repro_torch.serve.scheduler import MicroBatchScheduler  # noqa: E402

S_TOL = 1e-12
RESID_TOL = 1e-12
COUNTERS = ("solves", "batches", "slots", "slots_filled", "pad_waste",
            "slot_fill", "plan_cache_hit_rate", "retraces",
            "health_failures", "retries", "quarantined", "shed",
            "deadline_expired", "dispatch_errors", "circuit_opens",
            "circuit_rejects", "pending", "inflight")


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


def _fake_clock(t0=0.0):
    state = {"t": t0}

    def clock():
        return state["t"]

    clock.advance = lambda dt: state.__setitem__("t", state["t"] + dt)
    clock.set = lambda t: state.__setitem__("t", t)
    return clock


def _mat(m, n, seed=0, kappa=1e3):
    return np.asarray(make_matrix(m, n, kappa=kappa, seed=seed))


def _services(clock=None, faults=None, **kw):
    """The reference's service and the port's (CPU) on one config."""
    jfaults = None if faults is None else JR.ServiceFaults(**faults)
    tfaults = None if faults is None else R.ServiceFaults(**faults)
    extra = {} if clock is None else {"clock": clock}
    jsvc = JSV.SvdService(JSV.ServiceConfig(faults=jfaults, **kw), **extra)
    tsvc = SV.SvdService(SV.ServiceConfig(faults=tfaults, device="cpu",
                                          **kw), **extra)
    return jsvc, tsvc


def _submit_both(svcs, a, *args, **kw):
    jsvc, tsvc = svcs
    return (jsvc.submit(jnp.asarray(a), *args, **kw),
            tsvc.submit(torch.from_numpy(a), *args, **kw))


def _same_stats(svcs, retraces=True):
    """The counters of both services equal.  ``retraces=False`` leaves
    out the one counter whose meaning differs once a retry climbs to a
    rung plan: the reference counts the traces of each executable a plan
    runs (a cached plan can still trace a new one), the port counts plan
    constructions (a rung plan cached by an earlier stream builds
    nothing)."""
    jst, tst = (svc.stats() for svc in svcs)
    keys = [k for k in COUNTERS if retraces or k != "retraces"]
    assert {k: tst[k] for k in keys} == {k: jst[k] for k in keys}
    return tst


def _same_solve(a, jfut, tfut):
    """The port's result against the reference's on one request."""
    ju, js, jvh = (np.asarray(x) for x in jfut.result())
    tu, ts, tvh = (x.numpy() for x in tfut.result())
    assert (tu.shape, ts.shape, tvh.shape) == (ju.shape, js.shape, jvh.shape)
    assert np.max(np.abs(ts - js)) <= S_TOL * js[0]
    rec = np.linalg.norm(a - (tu * ts) @ tvh) / np.linalg.norm(a)
    assert rec <= RESID_TOL, rec
    return tu, ts, tvh


# --- bucketing policy --------------------------------------------------------


def test_bucket_ladder_is_geometric():
    pol = SV.BucketPolicy(base=32, growth=1.5)
    assert [pol.rung(s) for s in (1, 32, 33, 48, 49, 100, 150)] == \
        [32, 32, 48, 48, 72, 108, 162]
    jpol = JSV.BucketPolicy(base=32, growth=1.5)
    for s in range(1, 5000, 37):
        assert pol.rung(s) == jpol.rung(s)
        assert pol.rung(s) >= s
        assert pol.rung(s + 1) >= pol.rung(s)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_bucket_key_orientation_free(dtype):
    """Keys carry the reference's bare dtype names, so they compare equal
    to the reference's keys."""
    pol, jpol = SV.BucketPolicy(), JSV.BucketPolicy()
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    k1 = pol.key_for((40, 100), tdt, "standard")
    k2 = pol.key_for((100, 40), tdt, "standard")
    assert k1 == k2 == SV.BucketKey(108, 48, dtype, "standard")
    assert k1 == jpol.key_for((40, 100), jdt, "standard")
    assert pol.key_for((40, 100), dtype, "standard") == k1
    assert pol.key_for((40, 100), tdt, "fast") != k1
    other = torch.float32 if dtype != "float32" else torch.float64
    assert pol.key_for((40, 100), other, "standard") != k1


def test_bucket_policy_validates():
    with pytest.raises(ValueError, match="growth"):
        SV.BucketPolicy(growth=1.0)
    with pytest.raises(ValueError, match="base"):
        SV.BucketPolicy(base=0)
    with pytest.raises(ValueError, match=">= 1"):
        SV.BucketPolicy().rung(0)
    with pytest.raises(ValueError, match="dtype"):
        SV.BucketPolicy().key_for((4, 4), "float17", "standard")


def test_pad_waste_accounting():
    assert pad_waste([(48, 32)], 48, 32, 1) == 0.0
    assert pad_waste([(48, 32)], 48, 32, 2) == pytest.approx(0.5)
    assert pad_waste([(32, 48)], 48, 32, 1) == 0.0
    key = SV.BucketKey(48, 32, "float64", "standard")
    from repro_torch.serve.svd_service import batch_pad_waste

    assert batch_pad_waste([(40, 30)], key, 2) == \
        pad_waste([(40, 30)], 48, 32, 2)


# --- padded-solve exactness across the ladder --------------------------------


@pytest.mark.parametrize("shape", [(96, 64), (33, 97), (48, 48), (100, 40),
                                   (108, 72), (7, 5)])
def test_padded_solve_matches_the_reference(shape):
    """A bucketed (padded rows + cols, masked-out) solve through both
    services: tall, wide, square, exact-fit and tiny shapes."""
    m, n = shape
    a = _mat(m, n, seed=m * 100 + n)
    svcs = _services(batch_size=2, max_wait=0.0)
    futs = _submit_both(svcs, a, mode="standard")
    u, s, vh = _same_solve(a, *futs)
    k = min(m, n)
    assert u.shape == (m, k) and s.shape == (k,) and vh.shape == (k, n)
    np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False),
                               atol=1e-11)
    assert np.linalg.norm(u.T @ u - np.eye(k)) / k < 1e-11
    assert np.linalg.norm(vh @ vh.T - np.eye(k)) / k < 1e-11
    assert svcs[1].policy.key_for(shape, torch.float64, "standard") == \
        svcs[0].policy.key_for(shape, jnp.float64, "standard")
    _same_stats(svcs)


def test_padded_solve_bf16():
    """bf16 requests route through an f32 compute plan and come back in
    bf16, held to the reference test's bf16 criterion."""
    a = np.asarray(make_matrix(60, 40, 1e2, dtype=jnp.float32, seed=3))
    svc = SV.SvdService(SV.ServiceConfig(batch_size=2, max_wait=0.0,
                                         device="cpu"))
    ab = torch.from_numpy(a).to(torch.bfloat16)
    u, s, vh = svc.submit(ab, mode="fast").result()
    assert u.dtype == s.dtype == vh.dtype == torch.bfloat16
    plan, _ = svc._bucket_plan(svc.policy.key_for((60, 40), torch.bfloat16,
                                                  "fast"))
    assert plan.compute_dtype == torch.float32
    a64 = ab.double()
    rec = (u.double() * s.double()[None, :]) @ vh.double()
    err = float(torch.linalg.norm(rec - a64) / torch.linalg.norm(a64))
    assert err < 5e-2


# --- scheduler policy (a copy of the reference's) ----------------------------


def test_scheduler_full_batches_never_wait():
    clk = _fake_clock()
    sched = MicroBatchScheduler(2, max_wait=10.0, clock=clk)
    sched.enqueue("k", "a")
    assert sched.ready() == []
    sched.enqueue("k", "b")
    assert sched.ready() == [("k", ["a", "b"])]
    assert sched.pending() == 0


def test_scheduler_partial_flush_by_head_age_no_starvation():
    clk = _fake_clock()
    sched = MicroBatchScheduler(4, max_wait=0.01, clock=clk)
    sched.enqueue("rare", "r0")
    rare_flushed_at = None
    for burst in range(3):
        for i in range(4):
            sched.enqueue("hot", f"h{burst}{i}")
        clk.advance(0.004)
        batches = sched.ready()
        assert ("hot", [f"h{burst}{i}" for i in range(4)]) in batches
        if ("rare", ["r0"]) in batches and rare_flushed_at is None:
            rare_flushed_at = clk()
    assert rare_flushed_at is not None and rare_flushed_at >= 0.01
    assert sched.pending() == 0


def test_scheduler_oldest_head_first_and_burst_drain():
    clk = _fake_clock()
    sched = MicroBatchScheduler(2, max_wait=0.0, clock=clk)
    sched.enqueue("b", "b0")
    clk.advance(0.001)
    for item in ("a0", "a1", "a2", "a3", "a4"):
        sched.enqueue("a", item)
    assert sched.ready() == [("b", ["b0"]), ("a", ["a0", "a1"]),
                             ("a", ["a2", "a3"]), ("a", ["a4"])]


def test_scheduler_force_flush_and_validation():
    sched = MicroBatchScheduler(4, max_wait=100.0, clock=_fake_clock())
    sched.enqueue("k", "x")
    assert sched.ready() == []
    assert sched.ready(force=True) == [("k", ["x"])]
    with pytest.raises(ValueError, match="batch_size"):
        MicroBatchScheduler(0)
    with pytest.raises(ValueError, match="max_wait"):
        MicroBatchScheduler(1, max_wait=-1.0)


def test_scheduler_per_key_max_wait_override():
    clk = _fake_clock()
    sched = MicroBatchScheduler(4, max_wait=1.0, clock=clk)
    sched.set_max_wait("fast", 0.01)
    assert sched.max_wait_for("fast") == 0.01
    assert sched.max_wait_for("slow") == 1.0
    sched.enqueue("fast", "f0")
    sched.enqueue("slow", "s0")
    clk.advance(0.02)
    assert sched.ready() == [("fast", ["f0"])]
    assert sched.pending() == 1
    clk.advance(1.0)
    assert sched.ready() == [("slow", ["s0"])]
    sched.set_max_wait("fast", None)
    assert sched.max_wait_for("fast") == 1.0
    with pytest.raises(ValueError, match="max_wait"):
        sched.set_max_wait("fast", -1.0)


def test_scheduler_drop_preserves_fifo():
    sched = MicroBatchScheduler(4, clock=lambda: 0.0)
    for i in range(5):
        sched.enqueue("k", i)
    assert sched.drop(lambda x: x % 2 == 1) == [1, 3]
    assert sched.pending() == 3
    (_, items), = sched.ready(force=True)
    assert items == [0, 2, 4]


# --- service: futures, ordering, steady state --------------------------------


def test_futures_resolve_in_submission_order_per_bucket():
    """FIFO within a bucket: each future reconstructs its own matrix, in
    both services, and completion follows submission."""
    clk = _fake_clock()
    svcs = _services(clock=clk, batch_size=2, max_wait=0.0)
    mats = [_mat(40, 30, seed=s) for s in range(5)]
    pairs = [_submit_both(svcs, a) for a in mats]
    assert svcs[1].pending() == 5
    for svc in svcs:
        svc.poll(force=True)
    assert svcs[1].pending() == 0
    for a, (jf, tf) in zip(mats, pairs):
        _same_solve(a, jf, tf)
    futs = [tf for _, tf in pairs]
    assert [f.seq for f in futs] == sorted(f.seq for f in futs)
    done = [f.t_done for f in futs]
    assert done == sorted(done)
    st = svcs[1].stats()
    assert st["batches"] == svcs[0].stats()["batches"] == 3


def test_mixed_stream_zero_retraces_full_hit_rate():
    """After warmup over the expected shapes, a mixed-shape/mode stream
    runs at a 100% plan-cache hit rate with zero plan constructions —
    and every counter equals the reference's on the same stream."""
    shapes = [(96, 64), (40, 100), (64, 48)]
    clk = _fake_clock()
    svcs = _services(clock=clk, batch_size=4, max_wait=0.0)
    keys = [svc.warmup(shapes, modes=("fast", "standard"),
                       dtypes=("float64",)) for svc in svcs]
    assert keys[1] == keys[0]
    rng = np.random.default_rng(0)
    mats, pairs = [], []
    for i in range(17):   # not a batch multiple: exercises empty slots
        m, n = shapes[int(rng.integers(len(shapes)))]
        mode = ("fast", "standard")[int(rng.integers(2))]
        mats.append(_mat(m, n, seed=i, kappa=1e2))
        pairs.append(_submit_both(svcs, mats[-1], mode))
    for svc in svcs:
        svc.flush()
    assert all(tf.done() for _, tf in pairs)
    for a, (jf, tf) in zip(mats, pairs):
        _same_solve(a, jf, tf)
    st = _same_stats(svcs)
    assert st["solves"] == 17
    assert st["plan_cache_hit_rate"] == 1.0 and st["retraces"] == 0
    assert 0.0 < st["pad_waste"] < 1.0
    assert st["warm_buckets"] == svcs[0].stats()["warm_buckets"]


def test_warmup_pins_buckets_against_eviction():
    svc = SV.SvdService(SV.ServiceConfig(batch_size=2, max_wait=0.0,
                                         device="cpu"))
    assert len(svc.warmup([(48, 32)], modes=("standard",),
                          dtypes=("float64",))) == 1
    prev = S.set_plan_cache_capacity(1)
    try:
        for k in (1e2, 1e3, 1e4):
            S.plan(S.SvdConfig(method="zolo_static", l0=0.9 / k),
                   (30, 20), torch.float64, device="cpu")
        assert S.cache_stats()["evictions"] >= 2
        fut = svc.submit(_mat(48, 32, seed=1))
        before = S.cache_stats()
        svc.poll(force=True)
        fut.result()
        after = S.cache_stats()
        # the dispatch re-looked its bucket plan up and HIT: the pin held
        assert after["misses"] == before["misses"]
        assert after["hits"] == before["hits"] + 1
    finally:
        S.set_plan_cache_capacity(prev)
    with pytest.raises(ValueError, match="capacity"):
        S.set_plan_cache_capacity(0)


def test_service_validates_requests():
    svc = SV.SvdService(SV.ServiceConfig(device="cpu"))
    with pytest.raises(ValueError, match="accuracy mode"):
        svc.submit(torch.zeros((4, 4)), mode="nope")
    with pytest.raises(ValueError, match="one .m, n. matrix"):
        svc.submit(torch.zeros((2, 4, 4)))
    with pytest.raises(ValueError, match="does not divide"):
        SV.SvdService(SV.ServiceConfig(batch_size=3,
                                       data_axis=("d0", "d1")))


def test_no_card_raises_instead_of_running_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SV.SvdService(SV.ServiceConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.synth_matrix(8, 8)


def test_latency_stamps():
    clk = _fake_clock()
    svc = SV.SvdService(SV.ServiceConfig(batch_size=1, max_wait=0.0,
                                         device="cpu"), clock=clk)
    fut = svc.submit(_mat(16, 16, kappa=1e2))
    clk.advance(0.25)
    svc.poll()
    fut.result()
    assert fut.done()
    assert fut.latency == pytest.approx(0.25)


def test_data_axis_splits_the_slots():
    """batch_size over a device tuple: each device solves its share of
    the slots through its own plan; results and counters as on one."""
    svc = SV.SvdService(SV.ServiceConfig(batch_size=4, max_wait=0.0,
                                         data_axis=("cpu", "cpu")))
    assert svc.devices == (torch.device("cpu"),) * 2
    svc.warmup([(48, 32)], modes=("standard",), dtypes=("float64",))
    mats = [_mat(48, 32, seed=s) for s in range(3)]
    futs = [svc.submit(torch.from_numpy(a)) for a in mats]
    svc.poll(force=True)
    for a, f in zip(mats, futs):
        u, s, vh = (x.numpy() for x in f.result())
        assert np.linalg.norm(a - (u * s) @ vh) / np.linalg.norm(a) \
            <= RESID_TOL
    st = svc.stats()
    assert st["batches"] == 1 and st["slots"] == 4
    assert st["retraces"] == 0 and st["plan_cache_hit_rate"] == 1.0


def test_service_mode_wait_override():
    clk = _fake_clock()
    svc = SV.SvdService(SV.ServiceConfig(
        batch_size=4, max_wait=10.0, max_wait_overrides=(("fast", 0.0),),
        device="cpu"), clock=clk)
    f_fast = svc.submit(_mat(24, 16, seed=0, kappa=1e2), mode="fast")
    f_std = svc.submit(_mat(24, 16, seed=1, kappa=1e2), mode="standard")
    clk.advance(0.001)
    svc.poll()
    assert f_fast.dispatched and not f_std.dispatched
    svc.poll(force=True)
    assert f_std.dispatched


def _rankdef(m, n, kappa, rank, seed=0):
    a = _mat(m, n, seed=seed, kappa=kappa)
    u, s, vh = np.linalg.svd(a, full_matrices=False)
    s[rank:] = 0.0
    return u @ np.diag(s) @ vh


@pytest.mark.parametrize("shape,rank", [((100, 40), 10), ((40, 100), 10),
                                        ((40, 40), 5)])
def test_rank_deficient_padded_round_trip(shape, rank):
    """Genuine triplets are selected by padded index, not by (tied zero)
    value: the eig-side factor stays an orthonormal basis and the
    reconstruction is exact (the reference test's bounds)."""
    svc = SV.SvdService(SV.ServiceConfig(batch_size=1, max_wait=0.0,
                                         device="cpu"))
    a = _rankdef(*shape, 1e3, rank, seed=2)
    fut = svc.submit(torch.from_numpy(a))
    svc.poll(force=True)
    u, s, vh = (x.numpy() for x in fut.result())
    m, n = shape
    nmin = min(m, n)
    assert u.shape == (m, nmin) and s.shape == (nmin,)
    assert vh.shape == (nmin, n)
    if m >= n:
        assert np.linalg.norm(vh @ vh.T - np.eye(nmin)) < 1e-10
    else:
        assert np.linalg.norm(u.T @ u - np.eye(nmin)) < 1e-10
        assert np.linalg.norm(vh[:rank] @ vh[:rank].T
                              - np.eye(rank)) < 1e-10
    np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False),
                               atol=1e-10)
    assert np.linalg.norm(a - (u * s) @ vh) < 1e-10


# --- the topk:<k> serving lane -----------------------------------------------


def test_topk_mode_parse():
    assert SV.topk_mode_k("topk:16") == JSV.topk_mode_k("topk:16") == 16
    assert SV.topk_mode_k("standard") is None
    for bad in ("topk:0", "topk:banana"):
        with pytest.raises(ValueError, match="topk"):
            SV.topk_mode_k(bad)


def test_topk_lane_end_to_end():
    """topk:<k> requests batch in their own buckets and come back as
    (m, k)/(k,)/(k, n) factors matching the leading spectrum (the
    reference test's 1e-10 s_max against numpy)."""
    svc = SV.SvdService(SV.ServiceConfig(batch_size=2, max_wait=0.0,
                                         device="cpu"))
    svc.warmup([(100, 40)], modes=("topk:4",))
    tall, wide = _mat(100, 40, seed=3), _mat(30, 90, seed=4)
    futs = [svc.submit(torch.from_numpy(a), mode="topk:4")
            for a in (tall, wide)]
    svc.poll(force=True)
    for a, fut in zip((tall, wide), futs):
        u, s, vh = (x.numpy() for x in fut.result())
        m, n = a.shape
        assert u.shape == (m, 4) and s.shape == (4,) and vh.shape == (4, n)
        ref = np.linalg.svd(a, compute_uv=False)[:4]
        np.testing.assert_allclose(s, ref, atol=1e-10 * ref[0])
    key4 = svc.policy.key_for((100, 40), torch.float64, "topk:4")
    assert key4 != svc.policy.key_for((100, 40), torch.float64, "topk:8")
    assert key4 == JSV.BucketPolicy().key_for((100, 40), jnp.float64,
                                              "topk:4")


def test_topk_lane_steady_state_zero_retraces():
    svc = SV.SvdService(SV.ServiceConfig(batch_size=2, max_wait=0.0,
                                         device="cpu"))
    svc.warmup([(64, 32)], modes=("topk:4",))
    for seed in range(4):
        fut = svc.submit(torch.from_numpy(_mat(60, 30, seed=seed)),
                         mode="topk:4")
        svc.poll(force=True)
        fut.result()
    st = svc.stats()
    assert st["retraces"] == 0, st
    assert st["solves"] == 4


def test_topk_lane_validates_k():
    svc = SV.SvdService(SV.ServiceConfig(device="cpu"))
    with pytest.raises(ValueError, match="triplets"):
        svc.submit(torch.zeros((16, 8)), mode="topk:12")


# --- fault tolerance (tests/test_resilience.py's service cases) --------------


def test_dispatch_exception_fails_every_batched_future():
    svcs = _services(batch_size=2,
                     faults={"dispatch_error_batches": (0,)})
    for svc in svcs:
        svc.warmup([(48, 32)])
    pairs = [_submit_both(svcs, _mat(48, 32, seed=s)) for s in (0, 1)]
    for svc in svcs:
        svc.flush()
    for _, f in pairs:
        assert f.done() and isinstance(f.exception(), RuntimeError)
        with pytest.raises(RuntimeError, match="injected dispatch fault"):
            f.result()
    assert _same_stats(svcs)["dispatch_errors"] == 1


def test_kernel_failure_fails_the_request(monkeypatch):
    """A failing kernel launch surfaces as the batch's requests' error —
    the plain ops never stand in for it."""
    from repro_torch.kernels import ops

    def broken(*args, **kwargs):
        raise RuntimeError("K1 launch failed")

    svc = SV.SvdService(SV.ServiceConfig(batch_size=2, max_wait=0.0,
                                         method="zolo_cuda", device="cpu"))
    monkeypatch.setattr(ops, "gram", broken)
    fut = svc.submit(torch.from_numpy(_mat(48, 32)).float())
    svc.flush()
    assert isinstance(fut.exception(), RuntimeError)
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        fut.result()
    assert svc.stats()["dispatch_errors"] == 1


def test_injected_nan_retries_on_next_rung_only_culprit():
    svcs = _services(batch_size=2, max_retries=2,
                     faults={"nan_request_seqs": (1,)})
    for svc in svcs:
        svc.warmup([(48, 32)])
    mats = [_mat(48, 32, seed=s) for s in (0, 1)]
    pairs = [_submit_both(svcs, a) for a in mats]
    for svc in svcs:
        svc.flush()
    for a, (jf, tf) in zip(mats, pairs):
        _same_solve(a, jf, tf)
    st = _same_stats(svcs)
    assert st["health_failures"] == 1 and st["retries"] == 1
    assert st["quarantined"] == 0
    s_ref = np.linalg.svd(mats[1], compute_uv=False)
    np.testing.assert_allclose(pairs[1][1].result()[1].numpy(), s_ref,
                               atol=1e-8)


def test_poison_request_quarantined_with_trail():
    svcs = _services(batch_size=1, max_retries=2)
    for svc in svcs:
        svc.warmup([(48, 32)])
    jf, tf = _submit_both(svcs, np.full((48, 32), np.nan))
    for svc in svcs:
        svc.flush()
    exc = tf.exception()
    assert isinstance(exc, R.SolveFailure)
    assert len(exc.trail) == 3       # rung 0 + max_retries
    assert [t.reason for t in exc.trail] == \
        [t.reason for t in jf.exception().trail]
    assert _same_stats(svcs, retraces=False)["quarantined"] == 1


def test_deadline_and_backpressure():
    clk = _fake_clock()
    svcs = _services(clock=clk, batch_size=4, deadline=0.5,
                     max_queue_depth=2)
    for svc in svcs:
        svc.warmup([(48, 32)])
    pairs = [_submit_both(svcs, _mat(48, 32, seed=s)) for s in (0, 1)]
    with pytest.raises(R.Backpressure):
        svcs[1].submit(torch.from_numpy(_mat(48, 32, seed=2)))
    with pytest.raises(JR.Backpressure):
        svcs[0].submit(jnp.asarray(_mat(48, 32, seed=2)))
    clk.set(1.0)                     # both expire while queued
    for svc in svcs:
        svc.poll()
    for _, f in pairs:
        assert isinstance(f.exception(), R.DeadlineExceeded)
        with pytest.raises(R.DeadlineExceeded):
            f.result()
    st = _same_stats(svcs)
    assert st["deadline_expired"] == 2 and st["shed"] == 1


def test_circuit_breaker_opens_and_cools_down():
    clk = _fake_clock()
    svcs = _services(clock=clk, batch_size=1, breaker_threshold=2,
                     breaker_cooldown=10.0,
                     faults={"dispatch_error_batches": tuple(range(8))})
    for _ in range(2):
        _submit_both(svcs, _mat(48, 32))
        for svc in svcs:
            svc.poll(force=True)
    with pytest.raises(R.CircuitOpen):
        svcs[1].submit(torch.from_numpy(_mat(48, 32)))
    with pytest.raises(JR.CircuitOpen):
        svcs[0].submit(jnp.asarray(_mat(48, 32)))
    st = _same_stats(svcs)
    assert st["circuit_opens"] == 1 and st["circuit_rejects"] == 1
    clk.set(20.0)                    # cooldown over: breaker closes
    _submit_both(svcs, _mat(48, 32))


def test_future_result_timeout(monkeypatch):
    clk = _fake_clock()
    svc = SV.SvdService(SV.ServiceConfig(batch_size=2, device="cpu"),
                        clock=clk)
    f = svc.submit(torch.from_numpy(_mat(48, 32)))
    monkeypatch.setattr(svc._sched, "ready",
                        lambda now=None, force=False: [])
    with pytest.raises(R.FutureTimeout, match="still queued"):
        f.result(timeout=0.0)
    assert not f.done()


def test_skewed_clock_ages_deadlines():
    clk = _fake_clock()
    svcs = _services(clock=clk, batch_size=4,
                     faults={"clock_skew": 100.0})
    jf, tf = _submit_both(svcs, _mat(48, 32), deadline=50.0)
    assert tf.t_submit == jf.t_submit == 100.0
    clk.set(60.0)
    for svc in svcs:
        svc.poll()
    assert isinstance(tf.exception(), R.DeadlineExceeded)
    _same_stats(svcs)


def test_chaos_mixed_stream_drains_with_zero_hung_futures():
    """Injected NaN solves, dispatch exceptions and expired deadlines in
    one stream: every future terminates, none hang, and both services
    account for every recovery path with the same counters."""
    clk = _fake_clock()
    svcs = _services(clock=clk, batch_size=2, max_retries=2,
                     max_queue_depth=4, breaker_threshold=99,
                     faults={"nan_request_seqs": (1,),
                             "dispatch_error_batches": (2,)})
    for svc in svcs:
        svc.warmup([(48, 32)])

    def flush():
        for svc in svcs:
            svc.flush()

    futures = {}
    futures["ok"] = _submit_both(svcs, _mat(48, 32))
    futures["injected"] = _submit_both(svcs, _mat(48, 32, seed=1))
    flush()
    futures["derr_a"] = _submit_both(svcs, _mat(48, 32, seed=2))
    futures["derr_b"] = _submit_both(svcs, _mat(48, 32, seed=3))
    flush()
    futures["poison"] = _submit_both(svcs, np.full((48, 32), np.nan))
    flush()
    futures["late"] = _submit_both(svcs, _mat(48, 32, seed=4), deadline=0.5)
    clk.set(1.0)
    flush()
    futures["tail"] = _submit_both(svcs, _mat(48, 32, seed=5))
    for svc, exc in zip(svcs, (JR.Backpressure, R.Backpressure)):
        with pytest.raises(exc):
            for _ in range(10):
                svc.submit((jnp.asarray if svc is svcs[0]
                            else torch.from_numpy)(_mat(48, 32, seed=6)))
    flush()

    tf = {name: pair[1] for name, pair in futures.items()}
    assert all(f.done() for f in tf.values())
    for name, seed in (("ok", 0), ("injected", 1), ("tail", 5)):
        _same_solve(_mat(48, 32, seed=seed), *futures[name])
    assert isinstance(tf["derr_a"].exception(), RuntimeError)
    assert isinstance(tf["derr_b"].exception(), RuntimeError)
    assert isinstance(tf["poison"].exception(), R.SolveFailure)
    assert len(tf["poison"].exception().trail) == 3
    assert isinstance(tf["late"].exception(), R.DeadlineExceeded)
    st = _same_stats(svcs)
    assert (st["retries"], st["health_failures"], st["quarantined"],
            st["dispatch_errors"], st["deadline_expired"]) == (3, 4, 1, 1, 1)
    assert st["shed"] >= 1 and st["pending"] == st["inflight"] == 0


# --- the launcher ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(40, 30), (30, 40)])
def test_synth_matrix_is_the_reference_matrix(shape):
    got = tlaunch.synth_matrix(*shape, 1e3, seed=5, device="cpu")
    want = np.asarray(jlaunch.synth_matrix(*shape, 1e3, seed=5))
    assert got.dtype == torch.float64 and got.shape == shape
    assert np.max(np.abs(got.numpy() - want)) <= 1e-13
    assert tlaunch.synth_matrix(*shape, seed=5, dtype=torch.float32,
                                device="cpu").dtype == torch.float32


def test_run_workload_on_the_cpu():
    """The open-loop workload on the CPU: the reference's record keys, every
    request served, and the warmed steady state (real clock, so the
    batching itself is timing-dependent and not compared)."""
    svc = SV.SvdService(SV.ServiceConfig(batch_size=2, max_wait=0.0,
                                         device="cpu"))
    shapes = [(24, 16), (16, 24)]
    rec = tlaunch.run_workload(svc, shapes, requests=6, rate=1e4, seed=1)
    jrec = jlaunch.run_workload(
        JSV.SvdService(JSV.ServiceConfig(batch_size=2, max_wait=0.0)),
        shapes, requests=6, rate=1e4, seed=1)
    assert set(rec) == set(jrec)
    assert rec["ok"] == jrec["ok"] == rec["requests"] == 6
    assert rec["retraces"] == jrec["retraces"] == 0
    assert rec["plan_cache_hit_rate"] == 1.0
    assert rec["p50_ms"] <= rec["p99_ms"] and 0.0 < rec["pad_waste"] < 1.0
