"""plan/execute engine: ``plan(SvdConfig, shape, dtype, device) -> SvdPlan``.

Port of the dense single-device part of ``repro/solver/planner.py``.
``plan`` resolves the method through the registry's capability flags and
``flops_fn`` cost models, precomputes the coefficient schedule through
the spec's ``plan_fn`` and returns a cached :class:`SvdPlan` whose
``svd``/``polar``/``svd_batched``/``polar_batched`` run it.

Execution is eager: PyTorch has no trace to cache, so the reference's
"compile once, zero retraces" contract (``trace_count``) has no
counterpart.  What carries over is the plan cache — resolution and the
schedule are built once per (config, shape, dtype, device) — and its
counters: ``cache_stats()`` reports hits, misses and evictions of the
LRU (128 entries; pinned plans are exempt).

Plans run on the CUDA card unless ``device="cpu"`` is passed.  Not yet
ported: ``audit()``, ``svd_verified()``, grouped and dynamic modes and
``compute_dtype`` (each raises ``NotImplementedError``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

import repro_torch.core.svd  # noqa: F401  (populates the registry)
from repro_torch.core import coeffs as _coeffs
from repro_torch.core import norms as _norms
from repro_torch.core import registry as _registry
from repro_torch.core import zolo as _zolo
from repro_torch.solver.config import SvdConfig

_PLANS_MAX = 128
_PLANS: "collections.OrderedDict[tuple, SvdPlan]" = collections.OrderedDict()
_PINNED: set = set()  # plan keys exempt from LRU eviction
_STATS = {"plan_hits": 0, "plan_misses": 0, "evictions": 0}


def cache_stats() -> dict:
    """Plan-cache counters: monotonic ``hits``/``misses``/``evictions``,
    live ``size``, ``pinned`` count and LRU ``capacity``."""
    return {"hits": _STATS["plan_hits"], "misses": _STATS["plan_misses"],
            "evictions": _STATS["evictions"], "size": len(_PLANS),
            "pinned": len(_PINNED), "capacity": _PLANS_MAX}


def _plan_key(p: "SvdPlan") -> tuple:
    return (p.config, p.shape, p.dtype, p.device)


def pin(p: "SvdPlan") -> None:
    """Exempt a plan from LRU eviction.  Idempotent; the plan re-enters
    the cache if it was already evicted."""
    key = _plan_key(p)
    _PLANS.setdefault(key, p)
    _PINNED.add(key)


def unpin(p: "SvdPlan") -> None:
    """Return a pinned plan to normal LRU lifetime.  Idempotent."""
    _PINNED.discard(_plan_key(p))


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


# config knobs routed through plan_fn, and the output keys that count as
# consuming them
_KNOB_CONSUMED_AS = {
    "r": ("r", "schedule"),
    "l0": ("l0", "l", "schedule"),
    "max_iters": ("max_iters", "schedule"),
    "qr_mode": ("qr_mode", "first_mode"),
    "qr_iters": ("qr_iters",),
}


def _static_candidate(spec) -> bool:
    # auto never picks oracles or baselines; only static backends run here
    return not (spec.is_oracle or spec.baseline or spec.dynamic
                or spec.requires_mesh)


def _select_method(m, n, r_hint, kappa, dtype, device):
    """method="auto": capability filter, then cheapest by ``flops_fn``
    (ties broken by name)."""
    cands = [_registry.get_polar(name) for name in _registry.list_polar()]
    cands = [s for s in cands if _static_candidate(s)]

    def score(spec):
        if spec.flops_fn is None:
            return (1, 0.0, spec.name)
        return (0, float(spec.flops_fn(m, n, r=r_hint, kappa=kappa,
                                       dtype=dtype, device=device)),
                spec.name)

    return min(cands, key=score)


def _resolve(config: SvdConfig, shape, dtype, device):
    m, n = shape
    explicit = (None if config.method == "auto"
                else _registry.get_polar(config.method))
    eig_spec = _registry.get_eig(config.eig_method)  # fail fast on typos
    if explicit is not None and (explicit.dynamic or explicit.requires_mesh):
        raise NotImplementedError(
            f"polar method {explicit.name!r} needs a mode that is not yet "
            f"ported to repro_torch")
    mode = "static"

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

    r = config.r
    if r is None and kappa is not None:
        r = _coeffs.choose_r(kappa_eff)

    if explicit is not None:
        spec = explicit
    else:
        spec = _select_method(m, n, r or _coeffs.choose_r(kappa_eff),
                              kappa_eff, dtype, device)

    res = PlanResolution(method=spec.name, mode=mode,
                         eig_method=eig_spec.name, m=m, n=n, dtype=dtype,
                         device=device, r=r, l0=l0, kappa=kappa,
                         max_iters=config.max_iters,
                         qr_mode=config.qr_mode, qr_iters=config.qr_iters,
                         nb=config.nb)

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
    def l0(self) -> Optional[float]:
        return self.resolution.l0

    @property
    def eig_method(self) -> str:
        return self.resolution.eig_method

    @property
    def schedule(self):
        """The precomputed schedule bound by the spec's ``plan_fn``."""
        return self._backend_kwargs.get("schedule")

    def audit(self, *, raise_on_fail: bool = True):
        raise NotImplementedError("SvdPlan.audit() is not yet ported to "
                                  "repro_torch")

    def svd_verified(self, a):
        raise NotImplementedError("SvdPlan.svd_verified() is not yet "
                                  "ported to repro_torch")

    def __repr__(self):
        return (f"SvdPlan(method={self.method!r}, mode={self.mode!r}, "
                f"r={self.r}, l0={self.l0}, shape={self.shape}, "
                f"dtype={_registry.dtype_name(self.dtype)}, "
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

    def _prescale(self, x):
        if self.config.scale == "power":
            # sharp 1.05x power-iteration bound (the ZoloMuon setting)
            alpha = 1.05 * _norms.sigma_max_power(
                x, iters=8, v0=self.start_vector) + 1e-12
        else:  # "bound": guaranteed upper bound
            alpha = _norms.sigma_max_upper(x)
        return (x / alpha.to(x.dtype)).to(x.dtype), alpha

    def _polar_canonical(self, a, want_h):
        """Run the backend on the canonical (m >= n) orientation.

        Returns (q, h, info, transposed, alpha, out_dtype) with q/h still
        canonical and h of the *scaled* input when ``alpha`` is not None.
        """
        kw = dict(self._backend_kwargs, want_h=want_h)
        a_work, transposed = _zolo.polar_canonical(a)
        out_dtype = a_work.dtype
        alpha = None
        if self.config.scale != "none" and not self._spec.is_oracle:
            # precomputed-schedule backends assume sigma_max <= 1
            a_work, alpha = self._prescale(a_work)
        q, h, info = self._spec.fn(a_work, **kw)
        return q, h, info, transposed, alpha, out_dtype

    def _polar_impl(self, a, want_h):
        q, h, info, transposed, alpha, out_dtype = \
            self._polar_canonical(a, want_h)
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

    def _svd_impl_info(self, a):
        q, h, info, transposed, alpha, out_dtype = \
            self._polar_canonical(a, True)
        # no sub-f32 eigensolver: a bf16 H goes to eigh in f32
        h = h.to(torch.promote_types(h.dtype, torch.float32))
        w, v = self._eig_spec.fn(h, **self._eig_kwargs)
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

    def _svd_impl(self, a):
        u, s, vh, _ = self._svd_impl_info(a)
        return u, s, vh

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
        lead = a.shape[:-2]
        flat = a.reshape((-1,) + self.shape)
        return _stack_tree([impl(flat[i]) for i in range(flat.shape[0])],
                           lead)

    def svd(self, a):
        """A = U diag(s) V^H (paper Alg. 2), s descending."""
        self._check(a)
        return self._svd_impl(a)

    def polar(self, a, want_h: bool = True):
        """(q, h, info) with A ~= Q H."""
        self._check(a)
        return self._polar_impl(a, want_h=bool(want_h))

    def svd_batched(self, a):
        """``svd`` over the leading axes of (..., m, n), one matrix at a
        time."""
        self._check(a, batched=True)
        return self._batched(self._svd_impl, a)

    def polar_batched(self, a, want_h: bool = True):
        """``polar`` over the leading axes of (..., m, n)."""
        self._check(a, batched=True)
        want_h = bool(want_h)
        return self._batched(lambda x: self._polar_impl(x, want_h=want_h),
                             a)


def plan(config: SvdConfig, shape, dtype, device=None) -> SvdPlan:
    """Resolve ``config`` for (shape, dtype, device) into a cached plan.

    ``device=None`` is the CUDA card (raises when there is none); pass
    ``device="cpu"`` to run on the CPU.  Identical (config, shape, dtype,
    device) return the same plan object."""
    if not isinstance(config, SvdConfig):
        raise TypeError(f"plan() takes an SvdConfig, got {type(config)}")
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"plan() takes a torch.dtype, got {dtype!r}")
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2:
        raise ValueError(f"plan() takes the 2-D problem shape (m, n), "
                         f"got {shape}; batched inputs go through "
                         f"svd_batched/polar_batched on a 2-D plan")
    dev = resolve_device(device)
    key = (config, shape, dtype, dev)
    cached = _PLANS.get(key)
    if cached is not None and cached._is_current():
        _STATS["plan_hits"] += 1
        _PLANS.move_to_end(key)
        return cached
    _STATS["plan_misses"] += 1
    spec, eig_spec, res, backend_kwargs, eig_kwargs = _resolve(
        config, shape, dtype, dev)
    built = SvdPlan(config=config, shape=shape, dtype=dtype, device=dev,
                    resolution=res, _spec=spec, _eig_spec=eig_spec,
                    _backend_kwargs=backend_kwargs, _eig_kwargs=eig_kwargs)
    _PLANS[key] = built
    _PLANS.move_to_end(key)
    _evict()
    return built
