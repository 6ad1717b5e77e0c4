"""Solver registry: polar-decomposition and eigensolver backends.

Port of ``repro/core/registry.py``.  :mod:`repro_torch.solver` plans and
executes only through this table; a new backend plugs in with a
decorator instead of another ``elif``.  The Zolo family is one engine
(:mod:`repro_torch.core.zolo`) bound to a schedule source and a
:class:`~repro_torch.core.zolo.ZoloOps` bundle: ``zolo_static`` (plain
torch ops) and ``zolo_cuda`` (the hand-written kernels).

Backend contract: ``fn(a, **kw) -> (q, h | None, info)`` for an ``a``
already in canonical (m >= n) orientation.

Plan-time contract (consumed by :mod:`repro_torch.solver`):

* ``flops_fn(m, n, *, r, kappa, grouped=False, dtype=None, sep=1,
  device=None) -> float`` — flop estimate for an (m, n) problem of
  condition ``kappa`` at order ``r``; ``dtype`` is the plan's torch dtype
  and ``device`` its ``torch.device``, so a backend that only runs fast
  (or at all) on some devices or precisions prices itself out elsewhere
  (``zolo_cuda`` is +inf on a CPU plan).  ``method="auto"`` picks the
  cheapest capability-matching backend.
* ``plan_fn(res) -> dict`` — called once at plan time with the resolved
  :class:`repro_torch.solver.PlanResolution`; returns the static backend
  kwargs (e.g. the precomputed schedule).  Raises ``ValueError`` for
  unmet plan-time requirements.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class PolarSpec:
    """One registered polar-decomposition backend and its capabilities."""

    name: str
    fn: Callable
    # capability flags — the dispatcher consults these, never the name
    supports_grouped: bool = False
    requires_mesh: bool = False
    dynamic: bool = False
    is_oracle: bool = False   # reference/debug path, not a solver
    baseline: bool = False    # explicit use only, never picked by auto
    grouped_fn: Optional[Callable] = None
    flops_fn: Optional[Callable] = None
    plan_fn: Optional[Callable] = None
    fallback: Optional[str] = None        # next rung when a solve fails
    kappa_max_f32: Optional[float] = None
    # per-(input dtype name, accum dtype name) conditioning envelope,
    # resolved by envelope_kappa_max()
    kappa_envelope: Optional[Dict] = None
    description: str = ""


@dataclasses.dataclass(frozen=True)
class EigSpec:
    """One registered symmetric eigensolver backend."""

    name: str
    fn: Callable  # fn(h, **kw) -> (w ascending, v)
    flops_fn: Optional[Callable] = None
    plan_fn: Optional[Callable] = None
    description: str = ""


_POLAR: Dict[str, PolarSpec] = {}
_EIG: Dict[str, EigSpec] = {}


def _same_origin(old: Callable, new: Callable) -> bool:
    """True when ``new`` is the same function re-created (a module
    reload): re-registration is then a replacement, not a collision.
    Lambdas never count as same-origin."""
    qualname = getattr(new, "__qualname__", None)
    if qualname is None or "<lambda>" in qualname:
        return False
    return (getattr(old, "__module__", None) == getattr(new, "__module__", 0)
            and getattr(old, "__qualname__", None) == qualname)


def register_polar(name: str, *, supports_grouped: bool = False,
                   requires_mesh: bool = False, dynamic: bool = False,
                   is_oracle: bool = False, baseline: bool = False,
                   grouped_fn: Callable = None,
                   flops_fn: Callable = None, plan_fn: Callable = None,
                   fallback: Optional[str] = None,
                   kappa_max_f32: Optional[float] = None,
                   kappa_envelope: Optional[Dict] = None,
                   description: str = ""):
    """Decorator registering ``fn(a, **kw) -> (q, h, info)`` under ``name``."""

    def deco(fn):
        if name in _POLAR and not _same_origin(_POLAR[name].fn, fn):
            raise ValueError(f"polar solver {name!r} already registered")
        if supports_grouped and grouped_fn is None:
            raise ValueError(f"polar solver {name!r}: supports_grouped "
                             f"requires a grouped_fn")
        if requires_mesh and not supports_grouped:
            raise ValueError(f"polar solver {name!r}: requires_mesh without "
                             f"supports_grouped is unsatisfiable")
        if fallback == name:
            raise ValueError(f"polar solver {name!r}: fallback to itself "
                             f"would loop the escalation ladder")
        _POLAR[name] = PolarSpec(
            name=name, fn=fn, supports_grouped=supports_grouped,
            requires_mesh=requires_mesh, dynamic=dynamic,
            is_oracle=is_oracle, baseline=baseline, grouped_fn=grouped_fn,
            flops_fn=flops_fn, plan_fn=plan_fn, fallback=fallback,
            kappa_max_f32=kappa_max_f32, kappa_envelope=kappa_envelope,
            description=description)
        return fn

    return deco


def register_eig(name: str, *, flops_fn: Callable = None,
                 plan_fn: Callable = None, description: str = ""):
    """Decorator registering ``fn(h, **kw) -> (w, v)`` under ``name``."""

    def deco(fn):
        if name in _EIG and not _same_origin(_EIG[name].fn, fn):
            raise ValueError(f"eig solver {name!r} already registered")
        _EIG[name] = EigSpec(name=name, fn=fn, flops_fn=flops_fn,
                             plan_fn=plan_fn, description=description)
        return fn

    return deco


def dtype_name(dtype) -> str:
    """'float32' for ``torch.float32`` (or anything with ``.name``)."""
    name = getattr(dtype, "name", None)
    return name if isinstance(name, str) else str(dtype).split(".")[-1]


def envelope_kappa_max(spec: PolarSpec, dtype,
                       accum: str = "float32") -> Optional[float]:
    """Resolve a backend's conditioning envelope for a compute dtype.

    * itemsize >= 8 — no sub-f64 envelope applies: ``None``.
    * exact ``(input, accum)`` hit in ``spec.kappa_envelope``.
    * sub-f32 input with a table but no entry — fail closed to the
      table's minimum.
    * otherwise ``spec.kappa_max_f32``.
    """
    itemsize = int(getattr(dtype, "itemsize", 8))
    if itemsize >= 8:
        return None
    env = spec.kappa_envelope
    if env:
        key = (dtype_name(dtype), accum)
        if key in env:
            return env[key]
        if itemsize < 4:
            return min(env.values())
    return spec.kappa_max_f32


def get_polar(name: str) -> PolarSpec:
    try:
        return _POLAR[name]
    except KeyError:
        raise ValueError(f"unknown polar method: {name!r} "
                         f"(registered: {sorted(_POLAR)})") from None


def get_eig(name: str) -> EigSpec:
    try:
        return _EIG[name]
    except KeyError:
        raise ValueError(f"unknown eig method: {name!r} "
                         f"(registered: {sorted(_EIG)})") from None


def list_polar() -> list:
    return sorted(_POLAR)


def list_eig() -> list:
    return sorted(_EIG)


def unregister_polar(name: str) -> None:
    """Remove a registration (tests / interactive reload)."""
    _POLAR.pop(name, None)


def unregister_eig(name: str) -> None:
    _EIG.pop(name, None)
