"""The port's spans: named ranges of its host code, with the work each
covers, on the profiler's timeline.

``span(name, **work)`` opens one around a stage of a solve.  Off (the
default) it returns one shared context that does nothing: a flag test
and a call.  On (:func:`enable`), it enters a profiler range of its
name (a ``RecordFunction``, the scope ``torch.profiler.record_function``
opens), so the range sits on the same kineto/CUPTI timeline as the
device operations it launches (no second clock), and it appends
``(name, parent, work)`` to an in-memory list: ``parent`` is the list
index of the span open around it on the same thread (None at the top),
``work`` the shapes and counts its caller passed, from which a reader
derives operations.  :func:`take` returns
the records and clears them.  Nothing is written anywhere: an operator
runs ``torch.profiler`` with :func:`enable` and reads the profiler's
events and :func:`take`'s records together.

``SPANS`` names every span the port opens:

* ``svd.solve`` — a solve through ``SvdPlan.svd``/``svd_info``/
  ``svd_verified`` (not the plan's inner ``_svd_impl``, which a top-k
  panel calls);
* ``svd.prescale``, ``svd.polar``, ``svd.form_h``, ``svd.eigh`` (``n``),
  ``svd.lift`` — its stages: the plan's prescale, the polar backend,
  H = sym(QᵀA), the eigensolve of H, and U = Q·V with the sign fold and
  the sort;
* ``linalg.cholesky`` (``batch``, ``n``) and ``linalg.trsm`` (``batch``,
  ``n`` the triangle, ``k`` the right-hand columns) — the factorizations
  of :mod:`repro_torch.core.linalg`;
* ``topk.request`` — ``TopKPlan.topk``/``topk_with_info``;
* ``topk.sketch`` (``m``, ``n``, ``l``, ``products``: the m·n·l matrix
  products of the range finder and the projection) and ``topk.panel``
  (the panel's solve and the lift U = Q·U_B).

The range is the profiler's fast form (``_RecordFunctionFast``, about a
microsecond a span) where torch has it, ``record_function`` (about ten,
through the dispatcher) otherwise: under the profiler, a top-k request's
77 spans through ``record_function`` cost about a millisecond of host
time a request, which the card spent idle.  The fast form is recorded as
an operator, not a user annotation, so it leaves no copy on the device
timeline.

Records are kept per process; call :func:`take` between traced parts,
not while a span is open (a parent index refers to the list it was
recorded in).
"""

from __future__ import annotations

import contextlib
import threading

import torch

SPANS = ("svd.solve", "svd.prescale", "svd.polar", "svd.form_h", "svd.eigh",
         "svd.lift", "linalg.cholesky", "linalg.trsm", "topk.request",
         "topk.sketch", "topk.panel")

_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)
_OFF = contextlib.nullcontext()
_on = False
_records: list = []
_lock = threading.Lock()
_local = threading.local()


class _Span:
    __slots__ = ("name", "work", "rf")

    def __init__(self, name: str, work: dict):
        self.name, self.work = name, work

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            stack.append(len(_records))
            _records.append((self.name, stack[-2] if len(stack) > 1
                             else None, self.work))
        self.rf = _RANGE(self.name)
        self.rf.__enter__()

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        _local.stack.pop()
        return False


def span(name: str, **work):
    """A context around one stage: records ``(name, parent, work)`` and a
    profiler range while spans are on, nothing while they are off."""
    if not _on:
        return _OFF
    return _Span(name, work)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> list:
    """The records since the last call, in the order the spans opened;
    the list starts anew."""
    global _records
    with _lock:
        out, _records = _records, []
    return out
