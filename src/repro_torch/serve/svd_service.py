"""SVD serving: heterogeneous request stream -> bucketed, micro-batched,
plan-cached solves.

Port of ``repro/serve/svd_service.py``.  The paper's pitch is throughput
— Zolotarev order-r iterations trade flops for parallelism so many
processes finish a factorization sooner — and the plan/execute surface
already builds one plan per (shape, dtype, config, device).  This
module turns that cache into a *service*:

    svc = SvdService(ServiceConfig(batch_size=8))   # on the CUDA card
    svc.warmup([(96, 64), (100, 33)])          # populate + pin the pool
    fut = svc.submit(a, mode="standard")       # any (m, n), any dtype
    svc.poll()                                 # drain queues -> dispatch
    u, s, vh = fut.result()                    # waits HERE, nowhere else

Request path (each stage is its own module):

1.  **Bucketing** (:mod:`repro_torch.serve.bucketing`) — canonical
    transpose, geometric size ladder, zero padding that is exact through
    the polar iteration (f(0) = 0; see that module's proof), spectrum
    masked back out at unpack.
2.  **Scheduling** (:mod:`repro_torch.serve.scheduler`) — continuous
    micro-batching: per-bucket FIFOs drained into fixed-slot batches,
    slots refilled between dispatches, partial batches forced by
    head-of-line age so no shape starves.
3.  **Execution** — ``SvdPlan.svd_batched`` at the bucket's padded
    shape.  The batch slot count is FIXED (empty slots carry zero
    matrices), so each bucket is one plan and the steady state builds no
    plan (``stats()["retraces"]`` counts plan constructions,
    :func:`repro_torch.solver.trace_count`); the plan is re-looked-up
    through :func:`repro_torch.solver.plan` on every dispatch, which is
    what the service's plan-cache hit-rate metric measures (warmed
    buckets are ``pin``-ned so LRU pressure from other tenants cannot
    evict them).
4.  **Response edge** — the solve's kernels are queued on the device's
    current stream as the host runs the plan; one CUDA event recorded
    after a batch's dispatch marks its completion.  The sweep finds
    finished batches with the non-blocking ``event.query()`` (the
    reference's ``Array.is_ready``), health is read to the host only
    once the event is ready, and the one wait, ``event.synchronize()``,
    runs only inside ``SvdFuture.result`` and ``flush``.  A CPU batch is
    ready at once.  (The solve itself still synchronises once, in
    ``eigh``'s info check at its end, so a dispatch returns only once
    the card has finished the batch; ROADMAP Queue C.)

The service is single-threaded and cooperative: ``submit`` enqueues,
``poll`` dispatches and sweeps.  ``result()`` on a not-yet-dispatched
future flushes its bucket, so simple callers never deadlock.

It plans on ``ServiceConfig.device`` — the CUDA card unless the caller
asks for ``"cpu"``; without a card it raises, it never falls back to the
CPU.  A bucket plan on the card runs its backend's kernels (K1/K2 for
``zolo_cuda``); a failing kernel fails the batch's requests with its
error in their futures.

Fault tolerance: with ``ServiceConfig.verify`` (the default) every
dispatched batch runs ``svd_batched_verified`` — the device-side
:class:`repro_torch.resilience.health.SolveHealth` rides back with the
factors — and the completion sweep *triages* each ready batch
per-entry: healthy entries resolve, unhealthy ones retry on the next
rung of the bucket's escalation ladder (clean input, fresh plan through
the LRU cache), and entries out of retries are quarantined with a typed
:class:`~repro_torch.resilience.errors.SolveFailure` carrying their
verdict trail.  Around that core: per-request deadlines
(:class:`DeadlineExceeded`), submit-time load shedding
(:class:`Backpressure`), a per-bucket circuit breaker
(:class:`CircuitOpen`), and dispatch-exception propagation into every
affected future — so every future terminates in a result or a typed
error, never a hang.  ``ServiceConfig.faults`` injects deterministic
faults (:class:`repro_torch.resilience.faultinject.ServiceFaults`) for
chaos testing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

import repro_torch.solver as _solver
import repro_torch.spectral as _spectral
from repro_torch.analysis import plan_audit as _audit
from repro_torch.resilience import escalate as _escalate
from repro_torch.resilience import health as _health
from repro_torch.resilience.errors import (Backpressure, CircuitOpen,
                                           DeadlineExceeded, FutureTimeout,
                                           SolveFailure)
from repro_torch.resilience.faultinject import ServiceFaults
from repro_torch.serve.bucketing import (
    BucketKey,
    BucketPolicy,
    canonicalize,
    pad_to_bucket,
    pad_waste,
    torch_dtype,
    unpad_svd_entry,
    unpad_topk_entry,
)
from repro_torch.serve.scheduler import MicroBatchScheduler


def topk_mode_k(mode: str) -> Optional[int]:
    """Parse the partial-spectrum lane tag: "topk:<k>" -> k, else None.

    A topk mode is its own bucket dimension — BucketKey.mode carries the
    full tag, so requests at one padded rung but different k plan (and
    batch) separately: k is a shape parameter of the top-k plan.
    """
    if not str(mode).startswith("topk:"):
        return None
    try:
        k = int(str(mode).split(":", 1)[1])
    except ValueError:
        k = 0
    if k < 1:
        raise ValueError(f"topk mode must be 'topk:<k>' with k >= 1, "
                         f"got {mode!r}")
    return k


# accuracy mode -> plan-time condition-number hint: the knob that sets
# the Zolotarev order r and schedule depth of a bucket's plan.  A
# request whose true kappa exceeds its mode's hint still converges
# monotonically (the composed map is monotone on [0, 1]) but to reduced
# accuracy — that is the contract an accuracy mode buys.
DEFAULT_MODES: Dict[str, float] = {
    "fast": 1e2,
    "standard": 1e4,
    "tight": 1e8,
}


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Frozen serving configuration.

    batch_size   slots per dispatched micro-batch (per bucket); ALSO the
                 batch shape every dispatch of a bucket runs.
    base/growth  the :class:`BucketPolicy` geometric ladder.
    max_wait     seconds a partial batch's head request may age before
                 the scheduler force-dispatches it with padded slots.
    modes        accuracy-mode tag -> kappa hint (plan-time schedule
                 depth); requests name a tag, never a kappa.
    method       solver method for bucket plans ("auto": the cost model
                 picks per padded shape/dtype — on the card often
                 ``qdwh_static``, which runs no kernel; name
                 ``"zolo_cuda"`` for K1/K2).
    max_wait_overrides  per-mode (tag -> seconds) overrides of
                 ``max_wait``: a "topk:<k>" or interactive lane can
                 flush partial batches early while bulk lanes keep
                 batching.  Unlisted modes keep the global default.
    data_axis    optional tuple of torch devices to split the batch
                 slots over (``batch_size / len(data_axis)`` slots each,
                 one plan per device); None keeps every slot on
                 ``device``.
    device       where requests are solved: "cuda" (the current card,
                 the default; raises when there is none) or "cpu".
    audit_plans  audit every bucket plan at warmup
                 (:func:`repro_torch.analysis.plan_audit.audit_plan`): a
                 plan with a wrong collective structure, an f64 leak, or
                 a host sync on its static path fails *before* it serves
                 traffic.  ``stats()["plan_audits"]`` reports the
                 counters either way.
    verify       run every full-SVD batch through
                 ``svd_batched_verified`` and triage entries by their
                 health verdict (retry up the escalation ladder,
                 quarantine after ``max_retries``).  Off, the service
                 trusts every solve.  The topk lane is never verified
                 (its sketch path has its own residual check; see
                 ``topk_adaptive``).
    deadline     default per-request deadline in seconds from submit
                 (None: no deadline).  A request still queued — or
                 awaiting a retry — past its deadline fails with
                 ``DeadlineExceeded``; ``submit(deadline=)`` overrides
                 per request.
    max_retries  health-failure retries per request before quarantine
                 (each retry climbs one escalation-ladder rung).
    max_queue_depth  submit-time load shed: a submit that would push
                 the queued-request count past this raises
                 ``Backpressure`` (None: never shed).
    breaker_threshold / breaker_cooldown  per-bucket circuit breaker:
                 after ``breaker_threshold`` consecutive dispatch/plan
                 failures in a bucket, submits to it raise
                 ``CircuitOpen`` for ``breaker_cooldown`` seconds, then
                 the breaker closes and counts afresh.
    faults       deterministic fault-injection plan
                 (:class:`repro_torch.resilience.faultinject.
                 ServiceFaults`) for chaos tests; None in production.
    """

    batch_size: int = 4
    base: int = 32
    growth: float = 1.5
    max_wait: float = 0.005
    modes: Tuple[Tuple[str, float], ...] = tuple(
        sorted(DEFAULT_MODES.items()))
    method: str = "auto"
    data_axis: Optional[Tuple[Any, ...]] = None
    device: str = "cuda"
    max_wait_overrides: Tuple[Tuple[str, float], ...] = ()
    audit_plans: bool = False
    verify: bool = True
    deadline: Optional[float] = None
    max_retries: int = 2
    max_queue_depth: Optional[int] = None
    breaker_threshold: int = 3
    breaker_cooldown: float = 1.0
    faults: Optional[ServiceFaults] = None

    def mode_kappa(self, mode: str) -> float:
        # the partial-spectrum lane rides the "standard" accuracy hint:
        # its k is a shape parameter, not an accuracy tag
        if topk_mode_k(mode) is not None:
            mode = "standard"
        for tag, kappa in self.modes:
            if tag == mode:
                return float(kappa)
        raise ValueError(f"unknown accuracy mode {mode!r} "
                         f"(one of {[t for t, _ in self.modes]})")


@dataclasses.dataclass
class _Request:
    seq: int
    shape: Tuple[int, int]          # original (m, n)
    transposed: bool
    padded: Any                     # canonical, bucket-shaped matrix
    future: "SvdFuture"
    t_submit: float
    deadline: Optional[float] = None  # absolute service-clock time
    rung: int = 0                     # escalation-ladder rung to run at
    retries: int = 0                  # health-failure retries consumed
    trail: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class _RetryLane:
    """Scheduler key of a bucket's rung-k retry queue (k >= 1).

    Retries batch among themselves — their plan differs from rung 0's,
    so sharing the primary queue would split batches — while the primary
    ``BucketKey`` lanes and every existing scheduler policy stay
    unchanged."""

    bucket: BucketKey
    rung: int


class SvdFuture:
    """Per-request handle: resolved by the service, waited on only by you.

    States: *queued* (in a bucket FIFO) -> *dispatched* (the batch was
    queued on the device) -> *resolved* (the sweep found its event ready
    and verified the entry healthy — or, with verification off, found it
    ready) or *failed* (a typed
    :class:`repro_torch.resilience.errors.ResilienceError`, or the
    captured dispatch exception).  ``result()`` is the response edge —
    the only place the service waits on the device; calling it early
    force-flushes the owning bucket so it can never deadlock on an
    un-filled batch, and a retried request re-dispatches from inside the
    same loop.  A failed future raises its exception from ``result()`` —
    every future terminates, none hang.
    """

    def __init__(self, service: "SvdService", seq: int):
        self._service = service
        self.seq = seq
        self._out = None
        self._exc: Optional[BaseException] = None
        self._resolved = False
        self._flight: Optional["_Inflight"] = None
        self.t_submit: Optional[float] = None
        self.t_done: Optional[float] = None

    @property
    def dispatched(self) -> bool:
        return self._out is not None

    def done(self) -> bool:
        """Non-blocking: resolved or failed?"""
        return self._resolved or self._exc is not None

    def exception(self) -> Optional[BaseException]:
        """The failure, if this future failed (None while live/ok)."""
        return self._exc

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-ready seconds, once done (the benchmark metric)."""
        if self.t_done is None or self.t_submit is None:
            return None
        return self.t_done - self.t_submit

    def result(self, timeout: Optional[float] = None):
        """(u, s, vh) of the request — waits until resolved.

        Raises the request's typed error if it failed
        (``SolveFailure`` / ``DeadlineExceeded`` / a captured dispatch
        exception), or :class:`FutureTimeout` after ``timeout`` seconds
        — the request itself stays live and ``result()`` can be called
        again.
        """
        give_up = (None if timeout is None
                   else self._service._now() + float(timeout))
        while not self.done():
            if self._flight is not None:
                # dispatched: wait for the device, then let the sweep
                # triage (resolve / retry / quarantine) this flight
                self._flight.wait()
            self._service.poll(force=True)
            if give_up is not None and not self.done() \
                    and self._service._now() >= give_up:
                raise FutureTimeout(
                    f"request {self.seq} not resolved within "
                    f"{timeout}s (still "
                    f"{'in flight' if self._flight else 'queued'})")
        if self._exc is not None:
            raise self._exc
        if self.t_done is None:
            self.t_done = self._service._now()
        return self._out

    # service-side transitions ------------------------------------------
    def _dispatch(self, out, flight: Optional["_Inflight"] = None) -> None:
        self._out = out
        self._flight = flight

    def _resolve(self, now: float) -> None:
        self._resolved = True
        self._flight = None
        if self.t_done is None:
            self.t_done = now

    def _retry(self) -> None:
        # back to *queued*: the unhealthy result must not be returned
        self._out = None
        self._flight = None

    def _fail(self, exc: BaseException, now: float) -> None:
        self._exc = exc
        self._out = None
        self._flight = None
        if self.t_done is None:
            self.t_done = now


@dataclasses.dataclass
class _Inflight:
    key: BucketKey
    events: List[Any]               # one CUDA event per card (none: CPU)
    reqs: List[_Request]
    health: Any = None              # batched SolveHealth when verifying
    plan: Any = None                # the plan that ran (for judging)
    reason: str = "as planned"      # ladder rung that actually planned

    def is_ready(self) -> bool:
        return all(e.query() for e in self.events)

    def wait(self) -> None:
        for e in self.events:
            e.synchronize()


@dataclasses.dataclass
class _Breaker:
    """Per-bucket failure counter with a cooldown latch."""

    failures: int = 0
    open_until: Optional[float] = None


def _cat_health(parts):
    """One host-side SolveHealth from per-device batched ones."""
    return _health.SolveHealth(*(torch.cat([t.reshape(-1).cpu()
                                            for t in leaves])
                                 for leaves in zip(*parts)))


class SvdService:
    """The serving engine: submit -> (bucket, schedule, batch) -> future."""

    def __init__(self, config: ServiceConfig = ServiceConfig(),
                 clock=time.monotonic):
        self.config = config
        self.policy = BucketPolicy(base=config.base, growth=config.growth)
        self._clock = clock
        self._skew = (config.faults.clock_skew
                      if config.faults is not None else 0.0)
        self._sched = MicroBatchScheduler(config.batch_size,
                                          max_wait=config.max_wait,
                                          clock=self._now)
        self._inflight: List[_Inflight] = []
        self._seq = 0
        if config.data_axis is not None:
            ndev = len(config.data_axis)
            if ndev < 1 or config.batch_size % ndev != 0:
                raise ValueError(
                    f"data_axis has {ndev} devices but batch_size="
                    f"{config.batch_size} does not divide over them")
            self.devices = tuple(_solver.resolve_device(d)
                                 for d in config.data_axis)
        else:
            self.devices = (_solver.resolve_device(config.device),)
        self.device = self.devices[0]
        # serving counters (cache stats are deltas vs these baselines,
        # re-snapshotted by warmup so the steady-state metric is clean)
        self._stats = {"solves": 0, "batches": 0, "slots": 0,
                       "slots_filled": 0, "useful_elems": 0,
                       "padded_elems": 0, "health_failures": 0,
                       "retries": 0, "quarantined": 0, "shed": 0,
                       "deadline_expired": 0, "dispatch_errors": 0,
                       "circuit_opens": 0, "circuit_rejects": 0}
        self._breakers: Dict[BucketKey, _Breaker] = {}
        self._ladders: Dict[Tuple[BucketKey, Any], List[Tuple[Any, str]]] \
            = {}
        self._dispatch_count = 0
        self._cache_base = _solver.cache_stats()
        self._trace_base = _solver.trace_count()
        self._topk_trace_base = _spectral.trace_count()
        # audit counters are NOT re-baselined by warmup: warmup is where
        # the audits run, and stats() should report them
        self._audit_base = _audit.audit_stats()
        self._wait_overrides = {str(t): float(w)
                                for t, w in config.max_wait_overrides}
        self._warm: List[BucketKey] = []

    def _now(self) -> float:
        """Service time: the injected clock plus any injected skew —
        every deadline, age, and timestamp reads through here."""
        return self._clock() + self._skew

    # --- plan pool -----------------------------------------------------

    def _bucket_config(self, key: BucketKey) -> _solver.SvdConfig:
        # sub-f32 request dtypes factorize in f32 (there is no stable
        # low-precision Cholesky path) and cast back at the plan edge
        compute = ("float32"
                   if torch_dtype(key.dtype).itemsize < 4 else None)
        return _solver.SvdConfig(method=self.config.method,
                                 kappa=self.config.mode_kappa(key.mode),
                                 l0_policy="estimate_at_plan",
                                 compute_dtype=compute)

    def _bucket_plan(self, key: BucketKey, rung: int = 0, device=None):
        """Plan (or LRU-hit) the bucket's plan for an escalation rung on
        ``device`` (default: the service's); returns ``(plan, reason)``
        where ``reason`` names the ladder rung that actually planned —
        rungs are skipped when their config cannot plan for this bucket,
        so the requested index alone would mislabel failure trails."""
        device = self.device if device is None else device
        shape, dtype = (key.m_pad, key.n_pad), torch_dtype(key.dtype)
        k = topk_mode_k(key.mode)
        if k is not None:
            inner = self._bucket_config(key)
            cfg = _spectral.TopKConfig(k=k, kappa=inner.kappa, svd=inner)
            return (_spectral.plan_topk(cfg, shape, dtype, device=device),
                    "as planned")
        if rung == 0:
            return (_solver.plan(self._bucket_config(key), shape, dtype,
                                 device=device), "as planned")
        # retry rung: the bucket's escalation ladder, planned through
        # the same LRU cache.  A rung whose config cannot plan here is
        # skipped upward; past the last rung the ladder's final (most
        # conservative) rung serves every further retry.
        ladder = self._ladder(key, device)
        err = None
        for cfg, reason in ladder[min(rung, len(ladder) - 1):]:
            try:
                return (_solver.plan(cfg, shape, dtype, device=device),
                        reason)
            except (ValueError, TypeError) as e:
                err = e
        raise ValueError(f"no escalation rung of bucket {key} plans: "
                         f"{err}")

    def _ladder(self, key: BucketKey, device):
        ladder = self._ladders.get((key, device))
        if ladder is None:
            plan0 = _solver.plan(self._bucket_config(key),
                                 (key.m_pad, key.n_pad),
                                 torch_dtype(key.dtype), device=device)
            ladder = _escalate.escalation_ladder(plan0)
            self._ladders[(key, device)] = ladder
        return ladder

    def _sync(self, device) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def warmup(self, shapes: Sequence[Tuple[int, int]],
               modes: Sequence[str] = ("standard",),
               dtypes: Sequence[Any] = ("float64",)) -> List[BucketKey]:
        """Populate and pin the plan pool for an expected workload.

        For every (shape, mode, dtype) combination: resolve the bucket,
        build (or cache-hit) its plan on every serving device, ``pin`` it
        against LRU eviction, audit it (``audit_plans``), and run one
        zero-filled batch through it so the first request pays no
        one-time cost (the kernels' build, the libraries' handles).
        Returns the warmed keys; cache/trace baselines are
        re-snapshotted, so ``stats()`` afterwards reports steady-state
        hit rate and plan constructions (the zero-retrace contract).
        """
        keys: List[BucketKey] = []
        per = self.config.batch_size // len(self.devices)
        for dtype in dtypes:
            for mode in modes:
                for shape in shapes:
                    key = self.policy.key_for(shape, dtype, mode)
                    if key in keys:
                        continue
                    keys.append(key)
                    for dev in self.devices:
                        self._warm_plan(key, dev, per)
        self._warm.extend(keys)
        self._cache_base = _solver.cache_stats()
        self._trace_base = _solver.trace_count()
        self._topk_trace_base = _spectral.trace_count()
        return keys

    def _warm_plan(self, key: BucketKey, dev, slots: int) -> None:
        plan, _ = self._bucket_plan(key, device=dev)
        if self.config.audit_plans:
            # fail loud at warmup, not under traffic: the run-time
            # invariants (collective structure, dtype discipline, no host
            # syncs on a static path) are checked on the exact plan the
            # bucket will serve
            plan.audit()
        zeros = torch.zeros((slots, key.m_pad, key.n_pad),
                            dtype=torch_dtype(key.dtype), device=dev)
        if topk_mode_k(key.mode) is None:
            _solver.pin(plan)
            # run the exact path dispatch will run (verified solves
            # carry the health reduction)
            if self.config.verify:
                plan.svd_batched_verified(zeros)
            else:
                plan.svd_batched(zeros)
        else:
            # a TopKPlan holds inner SvdPlans: pin them against LRU
            # pressure
            for inner in plan._inner.values():
                _solver.pin(inner)
            plan.topk_batched(zeros)
        self._sync(dev)

    # --- request path --------------------------------------------------

    def submit(self, a, mode: str = "standard",
               deadline: Optional[float] = None) -> SvdFuture:
        """Enqueue one (m, n) SVD request; returns its future.

        Accepts any 2-D matrix (tall, wide, square; a tensor or anything
        ``torch.as_tensor`` takes) of any dtype the solver takes; it is
        moved to the service's device.  The call is non-blocking:
        padding is a cheap device op and dispatch happens at the next
        ``poll``.

        ``deadline`` (seconds from now; default ``config.deadline``)
        bounds how long the request may wait — in the queue or between
        retries — before it fails with ``DeadlineExceeded``.  Raises
        :class:`Backpressure` when the queue is at
        ``config.max_queue_depth`` and :class:`CircuitOpen` while the
        request's bucket breaker is cooling down: both *before*
        enqueueing, so a shed request costs the client one exception
        and the service nothing.
        """
        a = torch.as_tensor(a)
        if a.ndim != 2:
            raise ValueError(f"SVD requests are one (m, n) matrix; got "
                             f"shape {tuple(a.shape)}")
        a = a.to(self.device)
        self.config.mode_kappa(mode)  # fail fast on unknown tags
        k = topk_mode_k(mode)
        if k is not None and k > min(a.shape):
            raise ValueError(
                f"mode {mode!r} asks for {k} triplets but the request "
                f"is {tuple(a.shape)} (rank at most {min(a.shape)})")
        now = self._now()
        depth = self.config.max_queue_depth
        if depth is not None and self._sched.pending() >= depth:
            self._stats["shed"] += 1
            raise Backpressure(
                f"queue depth {self._sched.pending()} at its limit "
                f"{depth}; back off and resubmit")
        key = self.policy.key_for(a.shape, a.dtype, mode)
        self._check_breaker(key, now)
        wait = self._wait_overrides.get(str(mode))
        if wait is not None:
            self._sched.set_max_wait(key, wait)
        a_c, transposed = canonicalize(a)
        fut = SvdFuture(self, self._seq)
        fut.t_submit = now
        if deadline is None:
            deadline = self.config.deadline
        req = _Request(seq=self._seq, shape=tuple(a.shape),
                       transposed=transposed,
                       padded=pad_to_bucket(a_c, key.m_pad, key.n_pad),
                       future=fut, t_submit=now,
                       deadline=(None if deadline is None
                                 else now + float(deadline)))
        self._seq += 1
        self._sched.enqueue(key, req, now=now)
        return fut

    # --- circuit breaker ----------------------------------------------

    def _check_breaker(self, key: BucketKey, now: float) -> None:
        br = self._breakers.get(key)
        if br is None or br.open_until is None:
            return
        if now < br.open_until:
            self._stats["circuit_rejects"] += 1
            raise CircuitOpen(
                f"bucket {key} breaker open for another "
                f"{br.open_until - now:.3g}s after {br.failures} "
                f"consecutive failures")
        # cooldown over: close and count afresh
        self._breakers[key] = _Breaker()

    def _breaker_failure(self, key: BucketKey, now: float) -> None:
        br = self._breakers.setdefault(key, _Breaker())
        br.failures += 1
        if br.failures >= self.config.breaker_threshold \
                and br.open_until is None:
            br.open_until = now + self.config.breaker_cooldown
            self._stats["circuit_opens"] += 1

    def _breaker_success(self, key: BucketKey) -> None:
        br = self._breakers.get(key)
        if br is not None and br.open_until is None:
            br.failures = 0

    def poll(self, force: bool = False) -> int:
        """Reap deadlines, dispatch ready micro-batches, sweep and
        triage completions.

        Returns the number of batches dispatched.  ``force=True``
        flushes partial batches regardless of age (the shutdown /
        explicit-flush path).
        """
        now = self._now()
        expired = self._sched.drop(
            lambda r: r.deadline is not None and now >= r.deadline)
        for r in expired:
            self._stats["deadline_expired"] += 1
            r.future._fail(DeadlineExceeded(
                f"request {r.seq} expired after "
                f"{now - r.t_submit:.3g}s in queue"), now)
        dispatched = 0
        for key, reqs in self._sched.ready(now=now, force=force):
            self._dispatch(key, reqs)
            dispatched += 1
        self._sweep()
        return dispatched

    def flush(self) -> None:
        """Dispatch everything pending — retries included — and wait
        until every future is terminal (the only batch-level wait in the
        service)."""
        while self._sched.pending() or self._inflight:
            self.poll(force=True)
            for flight in self._inflight:
                flight.wait()
            self._sweep()

    def _run_batch(self, key: BucketKey, rung: int, batch, k):
        """Run one batch over the serving devices (``batch_size / ndev``
        slots each); returns the per-device outputs, their health, the
        device-0 plan and the rung's reason."""
        per = batch.shape[0] // len(self.devices)
        outs, healths = [], []
        plan = reason = None
        for j, dev in enumerate(self.devices):
            p, why = self._bucket_plan(key, rung, device=dev)
            if plan is None:
                plan, reason = p, why
            part = batch[j * per:(j + 1) * per].to(dev)
            if k is not None:
                outs.append(p.topk_batched(part))
            elif self.config.verify:
                u_b, s_b, vh_b, health = p.svd_batched_verified(part)
                outs.append((u_b, s_b, vh_b))
                healths.append(health)
            else:
                outs.append(p.svd_batched(part))
        return outs, healths, plan, reason

    def _dispatch(self, lane, reqs: List[_Request]) -> None:
        if isinstance(lane, _RetryLane):
            key, rung = lane.bucket, lane.rung
        else:
            key, rung = lane, 0
        now = self._now()
        idx = self._dispatch_count
        self._dispatch_count += 1
        faults = self.config.faults
        k = topk_mode_k(key.mode)
        slots = self.config.batch_size
        try:
            if faults is not None and idx in faults.dispatch_error_batches:
                raise RuntimeError(faults.dispatch_error)
            mats = [r.padded for r in reqs]
            if faults is not None and faults.nan_request_seqs:
                for i, r in enumerate(reqs):
                    if r.seq in faults.nan_request_seqs \
                            and r.rung < faults.nan_below_rung:
                        # corrupt the dispatched copy only: the request
                        # keeps its clean input for retries
                        mats[i] = torch.full_like(r.padded, float("nan"))
            if len(mats) < slots:
                # fixed batch shape = one plan per bucket; a zero matrix
                # is solver-exact (every factor is zero) and cheap
                mats += [torch.zeros((key.m_pad, key.n_pad),
                                     dtype=torch_dtype(key.dtype),
                                     device=self.device)] * \
                    (slots - len(mats))
            outs, healths, plan, reason = self._run_batch(
                key, rung, torch.stack(mats), k)
            per = slots // len(self.devices)
            results = []
            for i, r in enumerate(reqs):
                u_b, s_b, vh_b = outs[i // per]
                m, n = r.shape
                mc, nc = (n, m) if r.transposed else (m, n)
                if k is None:
                    results.append(unpad_svd_entry(
                        u_b, s_b, vh_b, i % per, mc, nc, r.transposed))
                else:
                    results.append(unpad_topk_entry(
                        u_b, s_b, vh_b, i % per, mc, nc, k, r.transposed))
            # one event per card marks the batch (factors, health and
            # unpadded results) complete on its stream
            events = []
            for dev in self.devices:
                if dev.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(dev))
                    events.append(ev)
        except Exception as e:  # noqa: BLE001 — every dispatch failure,
            # whatever its type (a kernel's included), must reach the
            # batch's futures: an exception escaping here would leave
            # them pending forever
            self._stats["dispatch_errors"] += 1
            self._breaker_failure(key, now)
            for r in reqs:
                r.future._fail(e, now)
            return
        flight = _Inflight(key, events, list(reqs),
                           health=healths or None, plan=plan,
                           reason=reason)
        for r, out in zip(reqs, results):
            r.future._dispatch(out, flight)
        self._inflight.append(flight)
        self._stats["solves"] += len(reqs)
        self._stats["batches"] += 1
        self._stats["slots"] += slots
        self._stats["slots_filled"] += len(reqs)
        self._stats["useful_elems"] += sum(m * n for m, n in
                                           (r.shape for r in reqs))
        self._stats["padded_elems"] += slots * key.m_pad * key.n_pad

    def _sweep(self) -> None:
        """Pop ready in-flight batches (dispatch order = completion
        order on a single stream) and triage each entry by its health
        verdict: resolve, retry on the next escalation rung, or
        quarantine.  Unverified flights (topk lane, ``verify=False``)
        resolve wholesale.  An error the device reports for a batch (an
        asynchronous kernel fault) fails its futures."""
        now = self._now()
        while self._inflight:
            flight = self._inflight[0]
            try:
                if not flight.is_ready():
                    break
                h = None if flight.health is None else \
                    _cat_health(flight.health)
            except RuntimeError as e:
                self._inflight.pop(0)
                self._stats["dispatch_errors"] += 1
                self._breaker_failure(flight.key, now)
                for r in flight.reqs:
                    r.future._fail(e, now)
                continue
            self._inflight.pop(0)
            if h is None:
                for r in flight.reqs:
                    r.future._resolve(now)
                self._breaker_success(flight.key)
                continue
            all_ok = True
            for i, r in enumerate(flight.reqs):
                entry = _health.SolveHealth(*(t[i] for t in h))
                verdict = _health.judge_plan(flight.plan, entry)
                if verdict.ok:
                    r.future._resolve(now)
                    continue
                all_ok = False
                self._stats["health_failures"] += 1
                r.trail.append(_escalate.RungAttempt(
                    rung=r.rung, reason=flight.reason,
                    config=flight.plan.config, outcome="failed",
                    verdict=verdict))
                if r.deadline is not None and now >= r.deadline:
                    self._stats["deadline_expired"] += 1
                    r.future._fail(DeadlineExceeded(
                        f"request {r.seq} expired after failing its "
                        f"health check (no time left to retry)"), now)
                elif r.retries >= self.config.max_retries:
                    self._stats["quarantined"] += 1
                    r.future._fail(SolveFailure(tuple(r.trail)), now)
                else:
                    r.retries += 1
                    r.rung += 1
                    self._stats["retries"] += 1
                    r.future._retry()
                    self._sched.enqueue(_RetryLane(flight.key, r.rung),
                                        r, now=now)
            if all_ok:
                self._breaker_success(flight.key)
            else:
                self._breaker_failure(flight.key, now)

    # --- observability -------------------------------------------------

    def pending(self) -> int:
        return self._sched.pending()

    def stats(self) -> Dict[str, Any]:
        """Serving counters + the plan-pool metrics the scheduler reads.

        ``plan_cache_hit_rate`` is hits/(hits+misses) of
        ``repro_torch.solver.cache_stats()`` since the last ``warmup`` —
        1.0 in steady state over a warmed bucket set.  ``retraces``
        counts plan constructions (solver and top-k) over the same window
        — 0 is the zero-retrace serving contract.  ``pad_waste`` is the
        fraction of dispatched batch elements spent on padding (shape
        padding + empty slots).
        """
        cache = _solver.cache_stats()
        hits = cache["hits"] - self._cache_base["hits"]
        misses = cache["misses"] - self._cache_base["misses"]
        looked = hits + misses
        padded = self._stats["padded_elems"]
        audits = _audit.audit_stats()
        return {
            **self._stats,
            "pad_waste": (1.0 - self._stats["useful_elems"] / padded
                          if padded else 0.0),
            "slot_fill": (self._stats["slots_filled"] / self._stats["slots"]
                          if self._stats["slots"] else 1.0),
            "plan_cache_hit_rate": hits / looked if looked else 1.0,
            "plan_cache": cache,
            "retraces": (_solver.trace_count() - self._trace_base
                         + _spectral.trace_count()
                         - self._topk_trace_base),
            "plan_audits": {
                k: audits[k] - self._audit_base[k]
                for k in ("audited", "passed", "failed")},
            "warm_buckets": list(self._warm),
            "inflight": len(self._inflight),
            "pending": self._sched.pending(),
        }


def batch_pad_waste(shapes, key: BucketKey, slots: int) -> float:
    """:func:`repro_torch.serve.bucketing.pad_waste` keyed by a
    :class:`BucketKey` (benchmark/report helper)."""
    return pad_waste(shapes, key.m_pad, key.n_pad, slots)
