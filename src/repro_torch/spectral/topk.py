"""Top-k as a first-class workload: ``TopKConfig -> plan_topk -> TopKPlan``.

Port of ``repro/spectral/topk.py``.  Same plan/execute discipline as
:mod:`repro_torch.solver.planner`, one level up: a :class:`TopKConfig` is
frozen and hashable, ``plan_topk`` resolves it once per (config, shape,
dtype, device) — strategy selection, sketch width, power-iteration count
and the *inner* :class:`repro_torch.solver.SvdPlan` objects, all bound at
plan time — and caches the returned :class:`TopKPlan`.

Strategy resolution ("auto") is a cost-model argmin over the candidates
whose *accuracy is checkable at plan time*:

* "dense"  — full factorization through the solver, sliced to k
  triplets.  Always exact; priced by
  :func:`repro_torch.solver.flops_estimate`, the same per-backend
  ``flops_fn`` basis ``SvdConfig(method="auto")`` ranks with.
* "sketch" — randomized range finder + O(k)-width panel solve
  (:mod:`repro_torch.spectral.sketch`), admitted only when
  :func:`~repro_torch.spectral.sketch.needed_power_iters` says the
  configured tolerance is reachable under the conditioning hint.

"dnc" (:mod:`repro_torch.spectral.dnc`) is explicit-selection only: its
window bisection is a data-dependent decision whose success cannot be
certified at plan time.

The inner solves reuse the registry stack end to end: the sketch's panel
SVD, the d&c's sign probes (a dynamic ``l0_policy="runtime"`` polar plan)
and its Rayleigh-Ritz panel are cached ``SvdPlan`` objects on the plan's
device, so a CUDA plan runs them on the Hopper kernels where its inner
config names a kernel backend.

Differences from the reference: execution is eager and never retraces,
so :func:`trace_count` counts :class:`TopKPlan` constructions, as
:func:`repro_torch.solver.trace_count` counts ``SvdPlan`` ones; the
serving zero-retrace contract reads "no plan is built after warmup".
``TopKPlan.audit`` runs the plan under the plan auditor.  The random draws come from a
``torch.Generator`` seeded with ``TopKConfig.seed`` on the plan's device
(:meth:`TopKPlan.draw`); :func:`repro_torch.interop.with_draws` binds
given draws (the reference's) to an uncached copy of a plan.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core import registry as _registry
from repro_torch.solver import planner as _planner
from repro_torch.solver.config import SvdConfig
from repro_torch.spectral import dnc as _dnc
from repro_torch.spectral import sketch as _sketch

STRATEGIES = ("auto", "dnc", "sketch", "dense")

_TOPK_MAX = 128
_TOPK_PLANS: "collections.OrderedDict[tuple, TopKPlan]" = \
    collections.OrderedDict()
_STATS = {"traces": 0, "plan_hits": 0, "plan_misses": 0}


def trace_count() -> int:
    """Monotonic count of :class:`TopKPlan` constructions (cache misses
    that resolved a plan): the top-k no-retrace contract mirrors
    :func:`repro_torch.solver.trace_count`."""
    return _STATS["traces"]


def topk_cache_stats() -> dict:
    """Top-k plan-cache counters: ``plan_hits``, ``plan_misses`` and the
    live number of ``plans``."""
    return dict(_STATS, plans=len(_TOPK_PLANS))


@dataclasses.dataclass(frozen=True)
class TopKConfig:
    """Frozen description of one top-k workload; hashable plan-cache key.

    k            triplets wanted (1 <= k <= min(shape) at plan time).
    oversample   sketch/window width beyond k: l = k + oversample.  None
                 picks max(8, k, nmin // 16) at plan time — the decay
                 window (l + 1 - k indices) must scale with the problem
                 so per-index decay kappa^(1/nmin) keeps tight
                 tolerances reachable at large nmin.
    power_iters  sketch power iterations; None lets the plan-time
                 accuracy model (:func:`repro_torch.spectral.sketch.
                 needed_power_iters`) choose from (kappa, tol).
    strategy     "auto" | "dnc" | "sketch" | "dense" (see module doc).
    tol          relative accuracy target the plan must certify
                 (drives the sketch feasibility gate and
                 :meth:`TopKPlan.topk_adaptive` escalation).
    kappa        conditioning hint for the accuracy/cost models (falls
                 back to ``svd.kappa``, then 1e6 — same scoring default
                 as the solver planner).
    sketch_kind  "gauss" | "srht" test matrix.
    seed         generator seed for the sketch / probe draws (part of the
                 plan key: one plan, one reproducible draw).
    max_power_iters  feasibility ceiling for the accuracy model.
    dnc_rounds   bisection probe budget for strategy="dnc".
    svd          inner :class:`SvdConfig` for every full/panel solve.
    """

    k: int = 8
    oversample: Optional[int] = None
    power_iters: Optional[int] = None
    strategy: str = "auto"
    tol: float = 1e-10
    kappa: Optional[float] = None
    sketch_kind: str = "gauss"
    seed: int = 0
    max_power_iters: int = 12
    dnc_rounds: int = 12
    svd: SvdConfig = SvdConfig()

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"strategy={self.strategy!r} not in {STRATEGIES}")
        if self.sketch_kind not in _sketch.SKETCH_KINDS:
            raise ValueError(f"sketch_kind={self.sketch_kind!r} not in "
                             f"{_sketch.SKETCH_KINDS}")
        if not isinstance(self.svd, SvdConfig):
            raise TypeError(f"svd must be an SvdConfig, "
                            f"got {type(self.svd)}")

    def replace(self, **changes) -> "TopKConfig":
        return dataclasses.replace(self, **changes)


def _dynamic_sign_config(svd: SvdConfig) -> SvdConfig:
    """Inner config for the d&c sign probes: the shifted Gram's
    conditioning is only known at execution time (it depends on the
    probe shift), so the sign solve must be a dynamic
    ``l0_policy="runtime"`` plan.  A static explicitly-chosen inner
    method falls back to method="auto" (the runtime capability filter
    then picks among dynamic backends)."""
    method = svd.method
    if method != "auto" and not _registry.get_polar(method).dynamic:
        method = "auto"
    return svd.replace(method=method, l0_policy="runtime", l0=None,
                       r=None)


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class TopKPlan:
    """A bound top-k solver for one (config, shape, dtype, device).

    ``topk(a)`` returns (u (m, k), s (k,) descending, vh (k, n));
    ``topk_with_info`` adds the strategy telemetry dict (d&c bisection
    convergence); ``topk_batched`` runs over leading axes.  ``decision``
    records why the strategy was chosen — the cost/feasibility numbers
    auto ranked with.  ``draws`` holds bound random draws (None: drawn
    from ``config.seed`` at each call, see :meth:`draw`).
    """

    config: TopKConfig
    shape: Tuple[int, int]
    dtype: torch.dtype
    device: torch.device
    strategy: str          # resolved ("auto" never survives planning)
    l: int                 # sketch/window width (k + oversample, capped)
    q_iters: int           # resolved sketch power iterations
    decision: Dict[str, Any]
    _transposed: bool
    _inner: Dict[str, Any]      # name -> inner SvdPlan
    draws: Optional[Dict[str, torch.Tensor]] = None

    @property
    def k(self) -> int:
        return self.config.k

    def __repr__(self):
        return (f"TopKPlan(k={self.k}, strategy={self.strategy!r}, "
                f"l={self.l}, q_iters={self.q_iters}, "
                f"shape={self.shape}, "
                f"dtype={_registry.dtype_name(self.dtype)}, "
                f"device={self.device})")

    @property
    def flops_estimate(self) -> Optional[float]:
        return self.decision.get(f"{self.strategy}_flops")

    def audit(self, a=None, *, raise_on_fail: bool = True):
        """Run the whole top-k path (strategy + inner solver plans) once
        on ``a`` (None: the deterministic audit matrix at the plan's
        shape, dtype, device and kappa) under the plan auditor: no
        collectives, no f64 compute under an f32 plan, no host syncs
        unless the strategy or an inner plan loops on the host.  See
        :func:`repro_torch.analysis.plan_audit.audit_plan`."""
        from repro_torch.analysis import plan_audit as _audit

        return _audit.audit_plan(self, a, raise_on_fail=raise_on_fail)

    def draw(self) -> Dict[str, torch.Tensor]:
        """The random draws one solve uses: the bound ``draws``, else a
        fresh ``torch.Generator`` seeded with ``config.seed`` on the plan
        device (so every call of one plan draws the same)."""
        if self.draws is not None:
            return self.draws
        if self.strategy == "dense":
            return {}
        gen = torch.Generator(device=self.device).manual_seed(
            self.config.seed)
        n = min(self.shape)
        if self.strategy == "sketch":
            return _sketch.sketch_draw(self.config.sketch_kind, n, self.l,
                                       generator=gen, dtype=self.dtype,
                                       device=self.device)
        return {"probe": torch.randn((n, self.l), generator=gen,
                                     dtype=self.dtype, device=self.device)}

    # --- implementation -------------------------------------------------

    def _impl_canonical(self, a, draw):
        """(u, s, vh, info) of canonical-tall ``a`` per the strategy."""
        cfg = self.config
        if self.strategy == "dense":
            u, s, vh = self._inner["dense"]._svd_impl(a)
            return (u[..., :, :self.k], s[..., :self.k],
                    vh[..., :self.k, :], {})
        if self.strategy == "sketch":
            u, s, vh = _sketch.sketch_topk(
                a, k=self.k, q_iters=self.q_iters, draw=draw,
                small_svd=self._inner["panel"]._svd_impl,
                kind=cfg.sketch_kind)
            return u, s, vh, {}
        sign_plan = self._inner["sign"]

        def sign_fn(x):
            return sign_plan._polar_impl(x, want_h=False)[0]

        return _dnc.dnc_topk(
            a, k=self.k, l=self.l, probe=draw["probe"], sign_fn=sign_fn,
            small_svd=self._inner["panel"]._svd_impl,
            max_rounds=cfg.dnc_rounds)

    def _impl(self, a, draw):
        if self._transposed:
            u, s, vh, info = self._impl_canonical(a.mT, draw)
            # a = (u s vh)^T = vh^T s u^T
            return vh.mT, s, u.mT, info
        return self._impl_canonical(a, draw)

    # --- entry points ---------------------------------------------------

    def _check(self, a, batched=False):
        shape = tuple(a.shape)
        ok = (len(shape) >= 3 and shape[-2:] == self.shape if batched
              else shape == self.shape)
        if not ok:
            expect = (f"(..., {self.shape[0]}, {self.shape[1]})"
                      if batched else str(self.shape))
            raise ValueError(
                f"top-k plan built for shape {expect} got {shape}; "
                f"plans are per-shape — build another with "
                f"plan_topk(config, shape, dtype)")
        if a.dtype != self.dtype:
            raise ValueError(f"top-k plan built for dtype "
                             f"{_registry.dtype_name(self.dtype)} got "
                             f"{_registry.dtype_name(a.dtype)}")
        if a.device != self.device:
            raise ValueError(f"top-k plan built for device {self.device} "
                             f"got a tensor on {a.device}")

    def topk_with_info(self, a):
        """(u, s, vh, info); info is the strategy telemetry (d&c:
        converged/count/shift/rounds; else empty)."""
        self._check(a)
        with obs.span("topk.request"):
            return self._impl(a, self.draw())

    def topk(self, a):
        """Leading-k triplets (u, s, vh), s descending."""
        u, s, vh, _ = self.topk_with_info(a)
        return u, s, vh

    def topk_batched(self, a):
        """``topk`` over the leading axes of (..., m, n), one matrix at a
        time with the same draw (as the reference's vmap over one key)."""
        self._check(a, batched=True)
        draw = self.draw()
        lead = a.shape[:-2]
        flat = a.reshape((-1,) + self.shape)
        outs = [self._impl(flat[i], draw)[:3] for i in range(flat.shape[0])]
        return tuple(torch.stack(t).reshape(lead + t[0].shape)
                     for t in zip(*outs))

    def residual(self, a, u, s, vh):
        """A-posteriori relative residual of a computed triplet set
        (:func:`repro_torch.spectral.sketch.topk_residual`)."""
        self._check(a)
        return _sketch.topk_residual(a, u, s, vh)

    def topk_adaptive(self, a, tol: Optional[float] = None):
        """Solve, measure the a-posteriori residual, escalate to the
        exact dense strategy if it misses ``tol``.  Returns
        (u, s, vh, info) with info["escalated"] and info["residual"]
        recording what happened.  Dense solves skip the check — they
        are already exact.

        The dense fallback runs through the resilience escalation
        ladder (:func:`repro_torch.resilience.solve_with_escalation`):
        the first rung is the plan's own dense solve with its health
        verdict, and an unhealthy dense solve climbs the same
        registry-derived rungs.  The rung trail is recorded under
        ``info["trail"]``.

        ``tol`` gates the *residual* (a backward error): by the
        quadratic convergence of Ritz values, residual <= sqrt(tol_val)
        certifies value error <= tol_val, so the default gate is
        sqrt(config.tol)."""
        tol = float(self.config.tol ** 0.5 if tol is None else tol)
        u, s, vh, info = self.topk_with_info(a)
        info = dict(info)
        if self.strategy == "dense":
            info.update(escalated=False, residual=None)
            return u, s, vh, info
        res = float(self.residual(a, u, s, vh))
        info.update(escalated=False, residual=res)
        if not (res <= tol):  # NaN-propagating: a NaN residual (the
            # sketch panel broke down) must escalate, not sail through
            # a False `res > tol` comparison
            # lazy: repro_torch.resilience layers on the solver, not the
            # reverse
            from repro_torch.resilience import escalate as _escalate

            x = a.mT if self._transposed else a
            u_f, s_f, vh_f, trail = _escalate.solve_with_escalation(
                x, self._inner["dense"].config)
            uk, sk, vhk = (u_f[..., :, :self.k], s_f[..., :self.k],
                           vh_f[..., :self.k, :])
            if self._transposed:
                u, s, vh = vhk.mT, sk, uk.mT
            else:
                u, s, vh = uk, sk, vhk
            info.update(escalated=True, trail=trail)
        return u, s, vh, info


def _resolve_topk(config: TopKConfig, shape, dtype, device):
    m, n = shape
    nmin, nmax = min(m, n), max(m, n)
    transposed = m < n
    can_shape = (nmax, nmin)  # canonical tall orientation
    if config.k > nmin:
        raise ValueError(f"k={config.k} exceeds min(shape)={nmin}; a "
                         f"rank-{nmin} matrix has no more triplets")
    oversample = (max(8, config.k, nmin // 16)
                  if config.oversample is None
                  else int(config.oversample))
    l = min(config.k + oversample, nmin)
    kappa = config.kappa
    if kappa is None:
        kappa = config.svd.kappa
    kappa_eff = float(kappa) if kappa is not None else 1e6

    # Thread the top-k conditioning hint into the inner solver when the
    # caller left it unconfigured: a bare SvdConfig() resolves to a
    # static-schedule backend, which needs the hint to bind l0.
    svd_cfg = config.svd
    if (svd_cfg.kappa is None and svd_cfg.l0 is None
            and svd_cfg.l0_policy == "given"):
        svd_cfg = svd_cfg.replace(kappa=kappa_eff,
                                  l0_policy="estimate_at_plan")

    # --- accuracy gate: can the sketch certify tol at this spectrum? --
    if config.power_iters is not None:
        q_iters: Optional[int] = int(config.power_iters)
        feasible = True  # explicit q: the caller owns the accuracy call
    else:
        q_iters = _sketch.needed_power_iters(nmin, config.k, l,
                                             kappa_eff, config.tol)
        feasible = (q_iters is not None
                    and q_iters <= config.max_power_iters
                    # l = nmin is no sketch at all (no width reduction —
                    # the k ~ n regime); auto hands that to dense even
                    # when the flop count flatters the degenerate sketch
                    and l < nmin)
        if q_iters is None:
            q_iters = config.max_power_iters

    # --- cost models, on the solver's own flops_fn basis --------------
    dense_flops = _planner.flops_estimate(svd_cfg, can_shape, dtype,
                                          device=device)
    panel_flops = _planner.flops_estimate(svd_cfg, (l, nmin), dtype,
                                          device=device)
    sketch_flops = _sketch.sketch_flops(
        nmax, nmin, config.k, l, q_iters,
        small_flops=panel_flops or 0.0)

    strategy = config.strategy
    if strategy == "auto":
        if (feasible and dense_flops is not None
                and sketch_flops < dense_flops):
            strategy = "sketch"
        else:
            strategy = "dense"

    decision = {"strategy": strategy, "requested": config.strategy,
                "l": l, "q_iters": q_iters,
                "sketch_feasible": feasible, "kappa": kappa_eff,
                "sketch_flops": sketch_flops,
                "dense_flops": dense_flops}

    # --- bind the inner plans -----------------------------------------
    inner: Dict[str, Any] = {}
    # the dense plan always resolves: it is the adaptive-escalation
    # target and the cost-model baseline (already cached by the
    # flops_estimate call above)
    inner["dense"] = _planner.plan(svd_cfg, can_shape, dtype, device=device)
    if strategy == "sketch":
        inner["panel"] = _planner.plan(svd_cfg, (l, nmin), dtype,
                                       device=device)
    elif strategy == "dnc":
        inner["panel"] = _planner.plan(svd_cfg, (nmax, l), dtype,
                                       device=device)
        inner["sign"] = _planner.plan(_dynamic_sign_config(svd_cfg),
                                      (nmin, nmin), dtype, device=device)
        decision["dnc_flops"] = _dnc.dnc_flops(
            nmax, nmin, config.k, l, config.dnc_rounds,
            sign_flops=inner["sign"].flops_estimate() or 0.0,
            small_flops=inner["panel"].flops_estimate() or 0.0)
    return TopKPlan(config=config, shape=tuple(shape), dtype=dtype,
                    device=device, strategy=strategy, l=l,
                    q_iters=q_iters, decision=decision,
                    _transposed=transposed, _inner=inner)


def plan_topk(config: TopKConfig, shape, dtype=None,
              device=None) -> TopKPlan:
    """Resolve ``config`` at (shape, dtype, device) into a cached
    TopKPlan.

    Identical (config, shape, dtype, device) return the same plan
    object.  ``dtype`` defaults to ``torch.get_default_dtype()``;
    ``device=None`` is the CUDA card (raises when there is none), as
    for :func:`repro_torch.solver.plan` — pass ``device="cpu"`` to run on
    the CPU.
    """
    if not isinstance(config, TopKConfig):
        raise TypeError(
            f"plan_topk() takes a TopKConfig, got {type(config)}")
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2:
        raise ValueError(f"plan_topk() takes the 2-D problem shape "
                         f"(m, n), got {shape}")
    if dtype is None:
        dtype = torch.get_default_dtype()
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"plan_topk() takes a torch.dtype, got {dtype!r}")
    dev = _planner.resolve_device(device)
    key = (config, shape, dtype, dev)
    cached = _TOPK_PLANS.get(key)
    if cached is not None:
        _STATS["plan_hits"] += 1
        _TOPK_PLANS.move_to_end(key)
        return cached
    _STATS["plan_misses"] += 1
    built = _resolve_topk(config, shape, dtype, dev)
    _STATS["traces"] += 1
    _TOPK_PLANS[key] = built
    while len(_TOPK_PLANS) > _TOPK_MAX:
        _TOPK_PLANS.popitem(last=False)
    return built


def clear_topk_cache() -> None:
    _TOPK_PLANS.clear()
