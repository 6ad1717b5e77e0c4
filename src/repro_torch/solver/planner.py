"""plan/execute engine: ``plan(SvdConfig, shape, dtype, device, mesh)``.

Port of ``repro/solver/planner.py``.
``plan`` resolves the method through the registry's capability flags and
``flops_fn`` cost models, precomputes the coefficient schedule through
the spec's ``plan_fn`` and returns a cached :class:`SvdPlan` whose
``svd``/``polar``/``svd_batched``/``polar_batched`` run it.

Execution is eager: PyTorch has no trace to cache, so nothing is ever
retraced.  What carries over is the plan cache — resolution and the
schedule are built once per (config, shape, dtype, device) — and its
counters: ``cache_stats()`` reports hits, misses and evictions of the
LRU (128 entries by default, :func:`set_plan_cache_capacity`; pinned
plans are exempt), and :func:`trace_count` counts plan constructions,
the one thing a repeated solve could still redo; a service's
zero-retrace contract reads "no plan is built after warmup".

Modes "static", "dynamic" and "grouped" resolve as in the reference (the
mode, r/sep and capability rules of ``repro/solver/planner.py``); a
``mesh=`` (:func:`repro_torch.dist.zolo_group_mesh`) implies grouped
mode, its "zolo" size is the plan's r, and a grouped plan runs on every
rank of the mesh, each calling it with the full input: the polar stage
is Algorithm 3 over the ranks, ``form_h`` and the eigensolve run
replicated, and every rank returns the same factors.  Dynamic backends
scale themselves, so the plan's prescale is skipped for them.
``compute_dtype`` factorizes in another dtype than the input's (a bf16
compute plan over f32 input): the canonical input is cast before the
prescale, the results come back in the plan dtype, and the method is
priced and envelope-capped in the compute dtype.  Plans run on the CUDA
card unless ``device="cpu"`` is passed; the one-call wrappers
(``polar_decompose``/``polar_svd``) plan on their input's device through
:func:`plan_for_call`.  ``svd_verified``/``svd_batched_verified``
append the solve's health (:mod:`repro_torch.resilience.health`).
``audit()`` runs the plan under the plan auditor
(:mod:`repro_torch.analysis.plan_audit`).  A solve opens the spans of
:mod:`repro_torch.obs` (``svd.solve`` and its stages), which cost a flag
test each while they are off.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

import repro_torch.core.svd  # noqa: F401  (populates the registry)
from repro_torch import obs
from repro_torch.core import coeffs as _coeffs
from repro_torch.core import norms as _norms
from repro_torch.core import registry as _registry
from repro_torch.core import zolo as _zolo
from repro_torch.solver.config import COMPUTE_DTYPES, SvdConfig

_UNSET = object()  # want_h not given: the backend's own default
_PLANS_MAX = 128
_PLANS: "collections.OrderedDict[tuple, SvdPlan]" = collections.OrderedDict()
_PINNED: set = set()  # plan keys exempt from LRU eviction
_STATS = {"traces": 0, "plan_hits": 0, "plan_misses": 0, "evictions": 0}


def trace_count() -> int:
    """Plan constructions so far (monotonic): the cache misses that ran
    the resolution and built a schedule.

    The reference counts backend traces; execution here is eager and
    never retraces, so the counter that stands for it is the work a warm
    solve must not redo — building its plan.  A repeated ``plan(...)``
    at a fixed (config, shape, dtype, device) does not move it."""
    return _STATS["traces"]


def plan_cache_stats() -> dict:
    return dict(_STATS, plans=len(_PLANS))


def cache_stats() -> dict:
    """Plan-cache counters: monotonic ``hits``/``misses``/``evictions``,
    live ``size``, ``pinned`` count and LRU ``capacity``."""
    return {"hits": _STATS["plan_hits"], "misses": _STATS["plan_misses"],
            "evictions": _STATS["evictions"], "size": len(_PLANS),
            "pinned": len(_PINNED), "capacity": _PLANS_MAX}


def _plan_key(p: "SvdPlan") -> tuple:
    return (p.config, p.shape, p.dtype, p.device, p.mesh)


def pin(p: "SvdPlan") -> None:
    """Exempt a plan from LRU eviction.  Idempotent; the plan re-enters
    the cache if it was already evicted."""
    key = _plan_key(p)
    _PLANS.setdefault(key, p)
    _PINNED.add(key)


def unpin(p: "SvdPlan") -> None:
    """Return a pinned plan to normal LRU lifetime.  Idempotent."""
    _PINNED.discard(_plan_key(p))


def set_plan_cache_capacity(n: int) -> int:
    """Set the LRU bound (returns the previous one), evicting now if the
    cache is over it.  Pinned plans never count toward eviction order
    but do occupy ``size`` — capacity below the pinned count keeps every
    pin and nothing else."""
    global _PLANS_MAX
    if n < 1:
        raise ValueError(f"plan cache capacity must be >= 1, got {n}")
    prev, _PLANS_MAX = _PLANS_MAX, int(n)
    _evict()
    return prev


def _evict() -> None:
    over = len(_PLANS) - _PLANS_MAX
    for key in list(_PLANS):  # least-recently-used first
        if over <= 0:
            break
        if key in _PINNED:
            continue
        del _PLANS[key]
        _STATS["evictions"] += 1
        over -= 1


def clear_plan_cache() -> None:
    """Drop all cached plans, pins included.  Does not reset counters —
    they are monotonic."""
    _PLANS.clear()
    _PINNED.clear()


def resolve_device(device=None) -> torch.device:
    """The plan device: ``None`` means the current CUDA card, and raises
    when there is none — the CPU is used only when asked for."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA card by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class PlanResolution:
    """Everything a spec's ``plan_fn`` may bind static kwargs from."""

    method: str
    mode: str
    eig_method: str
    m: int
    n: int
    dtype: torch.dtype
    device: torch.device
    r: Optional[int]
    l0: Optional[float]
    kappa: Optional[float]  # resolved hint (config.kappa, 1/l0, or None)
    max_iters: Optional[int]
    qr_mode: Optional[str]
    qr_iters: Optional[int]
    nb: int
    # grouped (Alg. 3) mesh factorization ranks = r * sep: the intra-group
    # distribution degree (1 for a plan without a mesh)
    sep: int = 1
    # the config's compute_dtype as a torch.dtype (None: compute in the
    # plan dtype).  plan_fns that gate on precision (the kernels' envelope
    # check) key on this, not ``dtype``: it is what the kernels see.
    compute_dtype: Optional[torch.dtype] = None

    @property
    def score_dtype(self) -> torch.dtype:
        """The dtype the backend computes in, which prices and caps it."""
        return self.compute_dtype if self.compute_dtype is not None \
            else self.dtype


# config knobs routed through plan_fn, and the output keys that count as
# consuming them
_KNOB_CONSUMED_AS = {
    "r": ("r", "schedule"),
    "l0": ("l0", "l", "schedule"),
    "max_iters": ("max_iters", "schedule"),
    "qr_mode": ("qr_mode", "first_mode"),
    "qr_iters": ("qr_iters",),
}


def _capability_ok(spec, mode: str, runtime_l0: bool = False) -> bool:
    # auto never picks reference oracles or comparison baselines — they
    # stay reachable by explicit method= only
    if spec.is_oracle or spec.baseline:
        return False
    if runtime_l0 and not spec.dynamic:
        # the run-time bound needs a run-time-conditioning backend, in
        # every mode
        return False
    if mode == "grouped":
        return spec.supports_grouped
    if spec.requires_mesh:
        return False
    return spec.dynamic if mode == "dynamic" else not spec.dynamic


def _dynamic_methods(mesh_bound: bool = False) -> list:
    """Registered dynamic backends: the grouped-capable ones for a plan
    with a mesh, the ones that run without a mesh otherwise."""
    names = [n for n in _registry.list_polar()
             if _registry.get_polar(n).dynamic]
    if mesh_bound:
        return [n for n in names if _registry.get_polar(n).supports_grouped]
    return [n for n in names if not _registry.get_polar(n).requires_mesh]


def _select_method(mode, m, n, r_hint, kappa, dtype, device,
                   runtime_l0=False, sep=1):
    """method="auto": capability filter, then cheapest by ``flops_fn``
    (ties broken by name).  A grouped plan scores the per-group critical
    path: the model's total over r, each group's work split over sep."""
    cands = [_registry.get_polar(name) for name in _registry.list_polar()]
    cands = [s for s in cands if _capability_ok(s, mode, runtime_l0)]
    if not cands:
        raise ValueError(f"no registered polar backend supports "
                         f"mode={mode!r}" +
                         (" with l0_policy='runtime'" if runtime_l0
                          else ""))
    grouped = mode == "grouped"

    def score(spec):
        if spec.flops_fn is None:
            return (1, 0.0, spec.name)
        flops = float(spec.flops_fn(m, n, r=r_hint, kappa=kappa,
                                    grouped=grouped, dtype=dtype, sep=sep,
                                    device=device))
        if grouped:
            flops /= max(r_hint, 1)
        return (0, flops, spec.name)

    return min(cands, key=score)


def _validate_capability(spec, mode: str, config: SvdConfig,
                         mesh_bound: bool = False) -> None:
    if mode == "grouped":
        if not spec.supports_grouped:
            grouped = [n for n in _registry.list_polar()
                       if _registry.get_polar(n).supports_grouped]
            raise ValueError(
                f"polar method {spec.name!r} does not support grouped "
                f"(mesh=) execution; grouped-capable methods: {grouped}")
        if config.l0_policy == "runtime" and not spec.dynamic:
            raise ValueError(
                f"l0_policy='runtime' estimates the bound on the device, "
                f"which needs a run-time-conditioning backend; "
                f"{spec.name!r} binds a precomputed schedule "
                f"(grouped-capable dynamic methods: "
                f"{_dynamic_methods(mesh_bound=True)})")
        return
    if spec.requires_mesh:
        raise ValueError(f"polar method {spec.name!r} runs grouped only; "
                         f"pass mesh=zolo_group_mesh(r)")
    if mode == "dynamic" and not spec.dynamic and not spec.is_oracle:
        raise ValueError(
            f"polar method {spec.name!r} has a precomputed schedule; "
            f"mode='dynamic' needs a run-time-conditioning backend "
            f"(registered dynamic methods: {_dynamic_methods()})")
    if mode == "static" and spec.dynamic and config.mode != "auto":
        raise ValueError(
            f"polar method {spec.name!r} is a dynamic (run-time "
            f"conditioning) backend; mode='static' needs a precomputed "
            f"schedule — use mode='dynamic' or 'auto'")
    if config.l0_policy == "runtime" and not spec.dynamic:
        raise ValueError(
            f"l0_policy='runtime' estimates the bound on the device, "
            f"which needs a dynamic backend; {spec.name!r} is static "
            f"(registered dynamic methods: {_dynamic_methods()})")


def _resolve(config: SvdConfig, shape, dtype, device, mesh=None):
    m, n = shape
    explicit = (None if config.method == "auto"
                else _registry.get_polar(config.method))
    eig_spec = _registry.get_eig(config.eig_method)  # fail fast on typos
    mode = config.mode
    if mode == "auto":
        if mesh is not None:
            mode = "grouped"
        elif explicit is not None:
            mode = "dynamic" if explicit.dynamic else "static"
        elif config.l0_policy == "runtime":
            mode = "dynamic"
        else:
            mode = "static"
    if mode == "grouped" and mesh is None:
        raise ValueError("mode='grouped' needs mesh=zolo_group_mesh(r)")
    if mode != "grouped" and mesh is not None:
        raise ValueError(f"mesh= implies grouped execution but "
                         f"mode={mode!r}; use mode='grouped' or 'auto'")

    l0 = config.l0
    if l0 is None and config.l0_policy == "estimate_at_plan":
        if config.kappa is None:
            raise ValueError("l0_policy='estimate_at_plan' derives l0 "
                             "from the conditioning; set SvdConfig.kappa")
        l0 = 0.9 / float(config.kappa)
    kappa = config.kappa
    if kappa is None and l0 is not None:
        kappa = 1.0 / float(l0)
    kappa_eff = kappa if kappa is not None else 1e6  # scoring default

    # r from paper Table 1 (choose_r), or the mesh's (r, sep) grid
    r = config.r
    sep = 1
    if mode == "grouped":
        sep = int(mesh.sep)
        if r is None:
            r = int(mesh.r)
        elif r != mesh.r:
            raise ValueError(f"config.r={r} but the mesh 'zolo' axis has "
                             f"size {mesh.r}")
        if sep > 1 and config.qr_mode == "householder" and \
                (config.qr_iters is None or config.qr_iters > 0):
            # fail at plan time: the structured Householder first
            # iteration needs the full iterate on every rank
            raise ValueError(
                f"qr_mode='householder' is not row-distributable over "
                f"the sep={sep} intra-group axis; use a sep=1 mesh "
                f"(r == ranks) or qr_mode='cholqr2'")
    elif r is None and kappa is not None:
        r = _coeffs.choose_r(kappa_eff)

    # a bf16 compute plan over f32 inputs is priced (and envelope-capped)
    # as bf16: the dtype the backend computes in
    compute_dtype = (None if config.compute_dtype is None
                     else COMPUTE_DTYPES[config.compute_dtype])
    score_dtype = compute_dtype if compute_dtype is not None else dtype
    if explicit is not None:
        spec = explicit
    else:
        spec = _select_method(mode, m, n, r or _coeffs.choose_r(kappa_eff),
                              kappa_eff, score_dtype, device,
                              runtime_l0=(config.l0_policy == "runtime"),
                              sep=sep)
    _validate_capability(spec, mode, config, mesh_bound=mesh is not None)

    res = PlanResolution(method=spec.name, mode=mode,
                         eig_method=eig_spec.name, m=m, n=n, dtype=dtype,
                         device=device, r=r, l0=l0, kappa=kappa,
                         max_iters=config.max_iters,
                         qr_mode=config.qr_mode, qr_iters=config.qr_iters,
                         nb=config.nb, sep=sep, compute_dtype=compute_dtype)

    # extras pass through verbatim; config knobs flow through plan_fn,
    # and an explicitly-set knob it does not consume is an error
    backend_kwargs = dict(config.extra)
    if spec.plan_fn:
        emitted = dict(spec.plan_fn(res))
        for knob, aliases in _KNOB_CONSUMED_AS.items():
            if getattr(config, knob) is not None and \
                    not any(a in emitted for a in aliases):
                raise ValueError(
                    f"polar method {spec.name!r} does not use {knob}=; "
                    f"its plan binds {sorted(emitted)}")
        backend_kwargs.update(emitted)
    else:
        for knob in _KNOB_CONSUMED_AS:
            value = getattr(config, knob)
            if value is not None:
                backend_kwargs.setdefault(knob, value)
    eig_kwargs = {"nb": res.nb}
    if eig_spec.plan_fn:
        eig_kwargs.update(eig_spec.plan_fn(res))
    return spec, eig_spec, res, backend_kwargs, eig_kwargs


def _stack_tree(outs, lead):
    """Stack per-matrix results (tensors, None, tuples, NamedTuples)."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        parts = [_stack_tree(list(p), lead) for p in zip(*outs)]
        return type(first)(*parts) if hasattr(first, "_fields") \
            else tuple(parts)
    t = torch.stack([torch.as_tensor(o) for o in outs])
    return t.reshape(tuple(lead) + tuple(t.shape[1:]))


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class SvdPlan:
    """A bound solver: resolved config + precomputed schedule for one
    (shape, dtype, config, device).

    ``start_vector`` is the prescale's power-iteration start vector
    (length min(m, n)); None draws one from a generator seeded with 0 on
    the plan device.  :func:`repro_torch.interop.with_state` binds the
    reference's vector (and schedule) to an uncached copy of a plan.
    """

    config: SvdConfig
    shape: Tuple[int, int]
    dtype: torch.dtype
    device: torch.device
    resolution: PlanResolution
    _spec: Any
    _eig_spec: Any
    _backend_kwargs: Dict[str, Any]
    _eig_kwargs: Dict[str, Any]
    start_vector: Optional[torch.Tensor] = None
    mesh: Any = None

    # --- introspection ------------------------------------------------

    @property
    def method(self) -> str:
        return self.resolution.method

    @property
    def mode(self) -> str:
        return self.resolution.mode

    @property
    def r(self) -> Optional[int]:
        return self.resolution.r

    @property
    def sep(self) -> int:
        """Intra-group distribution degree of the grouped mesh (1 for a
        plan without one): ranks = plan.r * plan.sep."""
        return self.resolution.sep

    @property
    def l0(self) -> Optional[float]:
        return self.resolution.l0

    @property
    def eig_method(self) -> str:
        return self.resolution.eig_method

    @property
    def schedule(self):
        """The precomputed schedule bound by the spec's ``plan_fn``."""
        return self._backend_kwargs.get("schedule")

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the backend factorizes in (the plan dtype unless the
        config sets ``compute_dtype``)."""
        return self.resolution.score_dtype

    def flops_estimate(self) -> Optional[float]:
        """Flop estimate from the spec's ``flops_fn``, on the basis
        ``method="auto"`` scores with (the compute dtype): total flops,
        or for a grouped plan the per-rank critical path (the total over
        r, each group's work split over sep).  None when the backend
        registers no cost model."""
        if self._spec.flops_fn is None:
            return None
        res = self.resolution
        kappa = res.kappa if res.kappa is not None else 1e6
        r = res.r if res.r is not None else _coeffs.choose_r(kappa)
        grouped = self.mode == "grouped"
        flops = float(self._spec.flops_fn(res.m, res.n, r=r, kappa=kappa,
                                          grouped=grouped,
                                          dtype=res.score_dtype,
                                          sep=res.sep, device=res.device))
        return flops / max(r, 1) if grouped else flops

    def audit(self, a=None, *, raise_on_fail: bool = True):
        """Run the plan's full SVD path once on ``a`` (None: a
        deterministic matrix from a generator seeded with 0 on the plan
        device, at the plan's shape, dtype and kappa hint) under the plan
        auditor and check it: the collectives per grouped axis against
        the (r, sep) budget, no f64 compute in an f32-compute plan, no
        host syncs on a static path.  Raises
        :class:`repro_torch.analysis.AuditError` on a violation unless
        ``raise_on_fail=False``; returns the
        :class:`~repro_torch.analysis.AuditReport`.  A grouped plan's
        audit is collective: every rank of its mesh calls it together.
        See :func:`repro_torch.analysis.plan_audit.audit_plan`."""
        from repro_torch.analysis import plan_audit as _audit

        return _audit.audit_plan(self, a, raise_on_fail=raise_on_fail)

    def __repr__(self):
        compute = "" if self.resolution.compute_dtype is None else \
            f"compute_dtype={_registry.dtype_name(self.compute_dtype)}, "
        sep = f"sep={self.sep}, " if self.mode == "grouped" else ""
        return (f"SvdPlan(method={self.method!r}, mode={self.mode!r}, "
                f"r={self.r}, {sep}l0={self.l0}, shape={self.shape}, "
                f"dtype={_registry.dtype_name(self.dtype)}, {compute}"
                f"device={self.device}, eig={self.eig_method!r})")

    def _is_current(self) -> bool:
        """Cached plans go stale if their backend was re-registered."""
        try:
            return (_registry.get_polar(self.method) is self._spec
                    and _registry.get_eig(self.eig_method)
                    is self._eig_spec)
        except ValueError:
            return False

    # --- implementations ----------------------------------------------

    def _prescale(self, x, reduce=None):
        if self.config.scale == "power":
            # sharp 1.05x power-iteration bound (the ZoloMuon setting)
            alpha = 1.05 * _norms.sigma_max_power(
                x, iters=8, v0=self.start_vector, reduce=reduce) + 1e-12
        else:  # "bound": guaranteed upper bound
            alpha = _norms.sigma_max_upper(x)
        return (x / alpha.to(x.dtype)).to(x.dtype), alpha

    def _polar_canonical(self, a, want_h=_UNSET, extra=None,
                         transposed=None, reduce=None):
        """Run the backend on the canonical (m >= n) orientation.

        ``extra``: per-call backend kwargs (:func:`plan_for_call`'s
        runtime ones); ``want_h`` left unset keeps the backend's default.
        ``transposed`` (None: from ``a``'s shape) fixes the orientation
        and ``reduce`` sums the prescale's row contractions over ranks,
        for a block of a matrix split over ranks
        (:meth:`_polar_rows_batched`).
        Returns (q, h, info, transposed, alpha, out_dtype) with q/h still
        canonical and h of the *scaled* input when ``alpha`` is not None.
        """
        kw = dict(self._backend_kwargs)
        if extra:
            kw.update(extra)
        if want_h is not _UNSET:
            kw["want_h"] = want_h
        if transposed is None:
            a_work, transposed = _zolo.polar_canonical(a)
        else:
            a_work = a.mT.contiguous() if transposed else a
        out_dtype = a_work.dtype
        if self.resolution.compute_dtype is not None:
            a_work = a_work.to(self.resolution.compute_dtype)
        alpha = None
        if (self.config.scale != "none" and not self._spec.dynamic
                and not self._spec.is_oracle):
            # precomputed-schedule backends assume sigma_max <= 1; dynamic
            # backends estimate their own alpha on the device
            with obs.span("svd.prescale"):
                a_work, alpha = self._prescale(a_work, reduce)
        with obs.span("svd.polar"):
            if self.mode == "grouped":
                q, h, info = self._spec.grouped_fn(a_work, mesh=self.mesh,
                                                   **kw)
            else:
                q, h, info = self._spec.fn(a_work, **kw)
        return q, h, info, transposed, alpha, out_dtype

    def _polar_impl(self, a, want_h=_UNSET, extra=None, transposed=None,
                    reduce=None):
        q, h, info, transposed, alpha, out_dtype = \
            self._polar_canonical(a, want_h, extra, transposed, reduce)
        if h is not None and alpha is not None:
            h = h * alpha.to(h.dtype)
        if transposed:
            if h is not None:
                # A = (Q_w H_w)^T = H_w Q_w^T; right factor
                # H = Q_w H_w Q_w^T satisfies A = Q_w^T H, H (n, n) PSD.
                h = q @ h @ q.mT
            q = q.mT
        q = q.to(out_dtype)
        if h is not None:
            h = h.to(out_dtype)
        return q, h, info

    def _svd_impl_info(self, a, extra=None):
        q, h, info, transposed, alpha, out_dtype = \
            self._polar_canonical(a, True, extra)
        with obs.span("svd.eigh", n=h.shape[-1]):
            # no sub-f32 eigensolver: a bf16 H goes to eigh in f32
            h = h.to(torch.promote_types(h.dtype, torch.float32))
            w, v = self._eig_spec.fn(h, **self._eig_kwargs)
        with obs.span("svd.lift"):
            u = q.to(v.dtype) @ v
            # ascending -> descending; fold any tiny negative eigenvalue's
            # sign into U so that s >= 0
            sign = torch.where(w < 0, -1.0, 1.0).to(u.dtype)
            s = torch.abs(w)
            if alpha is not None:
                s = s * alpha.to(s.dtype)
            u = u * sign[..., None, :]
            order = torch.argsort(-s, dim=-1, stable=True)  # as jnp.argsort
            s = torch.take_along_dim(s, order, dim=-1)
            u = torch.take_along_dim(u, order[..., None, :], dim=-1)
            v = torch.take_along_dim(v, order[..., None, :], dim=-1)
            vh = v.mT
            u, s, vh = u.to(out_dtype), s.to(out_dtype), vh.to(out_dtype)
        if transposed:
            # a = (u s vh)^T = v s u^T
            return vh.mT, s, u.mT, info
        return u, s, vh, info

    def _svd_impl(self, a, extra=None):
        u, s, vh, _ = self._svd_impl_info(a, extra)
        return u, s, vh

    def _svd_verified_impl(self, a, extra=None):
        # lazy: repro_torch.resilience layers on repro_torch.solver, not
        # the reverse
        from repro_torch.resilience import health as _rhealth

        u, s, vh, info = self._svd_impl_info(a, extra)
        return u, s, vh, _rhealth.solve_health(u, s, vh, info)

    # --- entry points ---------------------------------------------------

    def _check(self, a, batched=False):
        shape = tuple(a.shape)
        if batched:
            ok = len(shape) >= 3 and shape[-2:] == self.shape
            expect = f"(..., {self.shape[0]}, {self.shape[1]})"
        else:
            ok = shape == self.shape
            expect = str(self.shape)
        if not ok:
            raise ValueError(
                f"plan built for shape {expect} got {shape}; plans are "
                f"per-shape — build another with plan(config, shape, "
                f"dtype)")
        if a.dtype != self.dtype:
            raise ValueError(f"plan built for dtype {self.dtype} got "
                             f"{a.dtype}")
        if a.device != self.device:
            raise ValueError(f"plan built for device {self.device} got a "
                             f"tensor on {a.device}")

    def _batched(self, impl, a):
        if self.mode == "grouped":
            raise ValueError(
                "grouped (Algorithm 3) plans lay one matrix out over the "
                "('zolo', 'sep') ranks; batching is not supported — build "
                "a static/dynamic plan for batched inputs")
        lead = a.shape[:-2]
        flat = a.reshape((-1,) + self.shape)
        return _stack_tree([impl(flat[i]) for i in range(flat.shape[0])],
                           lead)

    def svd(self, a):
        """A = U diag(s) V^H (paper Alg. 2), s descending."""
        u, s, vh, _ = self.svd_info(a)
        return u, s, vh

    def svd_info(self, a):
        """``svd`` plus the polar backend's PolarInfo: (u, s, vh, info)."""
        self._check(a)
        with obs.span("svd.solve"):
            return self._svd_impl_info(a)

    def svd_verified(self, a):
        """``svd`` plus its health: ``(u, s, vh, health)``.

        ``health`` is a :class:`repro_torch.resilience.health.SolveHealth`
        of device scalars (all-finite flag, ``||UᵀU - I||_F / n`` over the
        rank-revealing columns, the driver's converged flag and the
        run-time conditioning estimate), queued behind the solve with no
        read back to the host — one extra Gram product.  Judge it with
        :func:`repro_torch.resilience.health.judge_plan`.
        """
        self._check(a)
        with obs.span("svd.solve"):
            return self._svd_verified_impl(a)

    def polar(self, a, want_h: bool = True):
        """(q, h, info) with A ~= Q H."""
        self._check(a)
        return self._polar_impl(a, want_h=bool(want_h))

    def svd_batched(self, a):
        """``svd`` over the leading axes of (..., m, n), one matrix at a
        time."""
        self._check(a, batched=True)
        return self._batched(self._svd_impl, a)

    def svd_batched_verified(self, a):
        """``svd_verified`` over the leading axes of (..., m, n).

        Health leaves carry the leading batch axes, so a caller triages
        entries individually (``SolveHealth(*(t[i] for t in health))``)
        instead of failing a whole batch for one bad entry.
        """
        self._check(a, batched=True)
        return self._batched(self._svd_verified_impl, a)

    def polar_batched(self, a, want_h: bool = True):
        """``polar`` over the leading axes of (..., m, n)."""
        self._check(a, batched=True)
        want_h = bool(want_h)
        return self._batched(lambda x: self._polar_impl(x, want_h=want_h),
                             a)

    def _polar_rows_batched(self, a, *, group, index: int):
        """Internal: Q of a stack (s, ., .) of blocks of the long
        dimension, split over the ranks of ``group``: rows of an (m >= n)
        plan, columns of an (m < n) one; Q comes back in the same blocks.
        Every rank of ``group`` calls it with the same stack length, at
        its ``index`` in the group.  ZoloMuon's sharded update runs it.

        The port's stand-in for what GSPMD does to the reference's
        row-sharded Muon solve (``repro/optim/muon.py:125-140``): the
        prescale's power iteration and every Gram of the engine reduce
        over ``group`` (:func:`repro_torch.dist.sep_reduce_ops`: K1 on the
        block, one all-reduce of the (n, n) Gram, the shift one-hot on
        ``index`` 0), the Cholesky factors replicate and the solves and
        the combine (K2) stay row-local.  A static Zolo plan only."""
        import torch.distributed as dist

        from repro_torch.core import zolo_cuda as _zolo_cuda
        from repro_torch.dist import grouped_ops as _gops

        if self.method not in ("zolo_static", "zolo_cuda"):
            raise ValueError(f"a row-split polar solve takes a static Zolo "
                             f"plan (zolo_static, zolo_cuda), not "
                             f"{self.method!r}")
        m, n = self.shape
        if a.ndim != 3 or (a.shape[-1] != n if m >= n else a.shape[-2] != m):
            raise ValueError(f"plan built for shape {self.shape} got a "
                             f"block stack {tuple(a.shape)}")
        if a.shape[0] == 0:
            return a.clone()
        kernels = self.method == "zolo_cuda" and a.device.type == "cuda"
        base = _zolo_cuda.cuda_zolo_ops() if kernels else _zolo.DEFAULT_OPS
        extra = (("ops", _gops.sep_reduce_ops(base, group=group,
                                               sep_index=index)),)

        def reduce(t):
            dist.all_reduce(t, group=group)
            return t

        return torch.stack([
            self._polar_impl(a[i], want_h=False, extra=extra,
                             transposed=m < n, reduce=reduce)[0]
            for i in range(a.shape[0])])


def plan(config: SvdConfig, shape, dtype, device=None,
         mesh=None) -> SvdPlan:
    """Resolve ``config`` for (shape, dtype, device[, mesh]) into a cached
    plan.

    ``device=None`` is the mesh's device, or without a mesh the CUDA card
    (raises when there is none); pass ``device="cpu"`` to run on the CPU.
    ``mesh`` (:func:`repro_torch.dist.zolo_group_mesh`) makes a grouped
    plan.  Identical (config, shape, dtype, device, mesh) return the same
    plan object."""
    if not isinstance(config, SvdConfig):
        raise TypeError(f"plan() takes an SvdConfig, got {type(config)}")
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"plan() takes a torch.dtype, got {dtype!r}")
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2:
        raise ValueError(f"plan() takes the 2-D problem shape (m, n), "
                         f"got {shape}; batched inputs go through "
                         f"svd_batched/polar_batched on a 2-D plan")
    if mesh is not None and device is None:
        device = mesh.device
    dev = resolve_device(device)
    if mesh is not None and torch.device(mesh.device) != dev:
        raise ValueError(f"plan device {dev} is not the mesh's device "
                         f"{mesh.device}")
    key = (config, shape, dtype, dev, mesh)
    cached = _PLANS.get(key)
    if cached is not None and cached._is_current():
        _STATS["plan_hits"] += 1
        _PLANS.move_to_end(key)
        return cached
    _STATS["plan_misses"] += 1
    spec, eig_spec, res, backend_kwargs, eig_kwargs = _resolve(
        config, shape, dtype, dev, mesh)
    _STATS["traces"] += 1
    built = SvdPlan(config=config, shape=shape, dtype=dtype, device=dev,
                    resolution=res, _spec=spec, _eig_spec=eig_spec,
                    _backend_kwargs=backend_kwargs, _eig_kwargs=eig_kwargs,
                    mesh=mesh)
    _PLANS[key] = built
    _PLANS.move_to_end(key)
    _evict()
    return built


def flops_estimate(config: SvdConfig, shape, dtype, device=None,
                   mesh=None) -> Optional[float]:
    """Cost-model score of ``config`` at (shape, dtype, device) without
    executing.

    Resolves (and caches) the plan and returns its ``flops_estimate`` —
    the same per-backend ``flops_fn`` basis ``method="auto"`` ranks with.
    :func:`repro_torch.spectral.plan_topk` prices its "dense" strategy
    with exactly this call, so a top-k plan's sketch-vs-dense decision
    and the solver's own backend selection share one cost model.  None
    when the resolved backend registers no cost model.
    """
    return plan(config, shape, dtype, device=device,
                mesh=mesh).flops_estimate()


_CONFIG_CALL_FIELDS = (("r", int), ("l0", float), ("max_iters", int),
                       ("qr_iters", int), ("qr_mode", str))


def plan_for_call(shape, dtype, *, method: str, eig_method: str = "eigh",
                  nb: int = 32, device=None, mesh=None, kw=None):
    """The bridge for :func:`repro_torch.core.svd.polar_decompose` and
    ``polar_svd``: a call's keyword arguments onto (cached plan, runtime
    kwargs).

    The schedule-shaping kwargs (r, l0, max_iters, qr_iters, qr_mode)
    move into the config, so a wrapper call and a ``plan()`` call with
    the same knobs share one cached plan; other hashable kwargs ride in
    ``config.extra`` verbatim; unhashable (tensor-valued) kwargs and
    ``want_h`` (per call, not configuration) come back for the caller to
    pass at execution, outside the cache key.  ``scale="none"`` is
    pinned: wrapper callers pre-scale a static backend's input, as with
    the reference's wrappers."""
    kw = dict(kw or {})
    cfg_kw = {}
    for name, cast in _CONFIG_CALL_FIELDS:
        if kw.get(name) is not None:
            cfg_kw[name] = cast(kw.pop(name))
    runtime = {}
    if "want_h" in kw:
        runtime["want_h"] = kw.pop("want_h")
    static = {}
    for k, v in kw.items():
        try:
            hash(v)
        except TypeError:
            runtime[k] = v
        else:
            static[k] = v
    cfg = SvdConfig(method=method, eig_method=eig_method, nb=nb,
                    scale="none", extra=tuple(sorted(static.items())),
                    **cfg_kw)
    return plan(cfg, shape, dtype, device=device, mesh=mesh), runtime
