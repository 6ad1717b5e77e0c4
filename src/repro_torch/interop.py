"""Carry the reference's solver state into the port.

An SVD solver has no weights: its state is the plan — the configuration,
the coefficient schedule and the power-iteration start vector of the
prescale.  These helpers take that state as plain Python values and
numpy arrays (what ``dataclasses.asdict`` of a reference ``SvdConfig`` and
``numpy.asarray`` of its arrays give), so the port and the JAX reference
compute the same thing on the same input.  Nothing of ``repro`` is
imported here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.coeffs import ZoloIteration
from repro_torch.solver.config import SvdConfig
from repro_torch.solver.planner import SvdPlan

# reference backend name -> its counterpart in the port
METHOD_NAMES = {"zolo_pallas": "zolo_cuda"}


def svd_config_from_dict(d: dict) -> SvdConfig:
    """An :class:`SvdConfig` from ``dataclasses.asdict`` of a reference
    ``SvdConfig``.  Reference-only method names map through
    :data:`METHOD_NAMES`; an unknown field raises."""
    fields = {f.name for f in dataclasses.fields(SvdConfig)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise ValueError(f"unknown SvdConfig fields {unknown}")
    kw = dict(d)
    kw["method"] = METHOD_NAMES.get(kw.get("method", "auto"),
                                    kw.get("method", "auto"))
    kw["extra"] = tuple(tuple(p) for p in kw.get("extra", ()))
    return SvdConfig(**kw)


def schedule_from_arrays(c, a, mhat, l_before, l_after) -> tuple:
    """A schedule (tuple of :class:`ZoloIteration`) from the reference's
    per-iteration arrays: ``c`` (iters, 2r), ``a`` (iters, r), ``mhat``,
    ``l_before``, ``l_after`` (iters,)."""
    c = np.asarray(c, np.float64)
    a = np.asarray(a, np.float64)
    mhat = np.asarray(mhat, np.float64).reshape(-1)
    l_before = np.asarray(l_before, np.float64).reshape(-1)
    l_after = np.asarray(l_after, np.float64).reshape(-1)
    iters = c.shape[0]
    if c.ndim != 2 or a.shape != (iters, c.shape[1] // 2) or \
            c.shape[1] % 2 or not (mhat.shape == l_before.shape
                                   == l_after.shape == (iters,)):
        raise ValueError(f"schedule arrays disagree: c {c.shape}, a "
                         f"{a.shape}, mhat {mhat.shape}, l_before "
                         f"{l_before.shape}, l_after {l_after.shape}")
    return tuple(ZoloIteration(tuple(float(v) for v in c[i]),
                               tuple(float(v) for v in a[i]),
                               float(mhat[i]), float(l_before[i]),
                               float(l_after[i]))
                 for i in range(iters))


def with_state(p: SvdPlan, *, schedule=None, start_vector=None) -> SvdPlan:
    """An uncached copy of plan ``p`` bound to the given state.

    ``schedule`` replaces the precomputed coefficient schedule (its order
    r must match the plan's); ``start_vector`` (numpy or tensor, length
    min(m, n)) becomes the prescale's power-iteration start vector."""
    kwargs = dict(p._backend_kwargs)
    if schedule is not None:
        schedule = tuple(schedule)
        if "schedule" not in kwargs:
            raise ValueError(f"{p.method!r} binds no schedule")
        if p.r is not None and any(it.r != p.r for it in schedule):
            raise ValueError(f"schedule order differs from the plan's "
                             f"r={p.r}")
        kwargs["schedule"] = schedule
    v0 = p.start_vector
    if start_vector is not None:
        v0 = torch.as_tensor(np.array(start_vector)).to(
            device=p.device, dtype=p.dtype)
        if v0.shape != (min(p.shape),):
            raise ValueError(f"start vector of shape {tuple(v0.shape)}; "
                             f"the plan needs ({min(p.shape)},)")
    return dataclasses.replace(p, _backend_kwargs=kwargs, start_vector=v0)
