"""Plan auditor: the torch counterpart of ``repro/analysis/jaxpr_audit.py``.

The reference lowers a plan's impl to a jaxpr and walks its equations.
Execution here is eager, so there is no graph to walk:
:func:`audit_callable` *runs* the callable once under a
:class:`torch.utils._python_dispatch.TorchDispatchMode` that sees every
aten and c10d operator it dispatches, with its outputs, and checks what
ran:

* **collective axes** (the counterpart of ``_collective_axes``) — every
  ``c10d`` collective carries its process group; a group is "sep" or
  "zolo" by the plan's :class:`~repro_torch.dist.grouped.ZoloGroupMesh`.
  All-reduces are counted per axis (``psum_counts``); gathers and
  broadcasts are axis-bound collectives too (``collectives``).  A
  collective on a group the plan's mesh does not bind, or any collective
  in a plan that is not grouped, is a violation.  A grouped plan's
  all-reduces per axis must equal its budget: the static solver's is
  :func:`expected_grouped_psums`, the dynamic solver's
  :func:`executed_dynamic_psums` over the branches that ran (the first
  iteration's one branch and the loop's iterations: eager execution runs
  one branch, where the reference's jaxpr holds all three).  A one-rank
  group issues no collective in the port, so a size-1 axis owes 0.
* **no f64 compute** — in a plan whose effective compute dtype is at
  most f32, an operator of :data:`WIDE_COMPUTE_OPS` with an f64/c128
  output is a violation, unless it runs inside a :class:`wide_ok` scope:
  a deliberate f64 computation, named.  The scopes (:data:`WIDE_OK_SCOPES`):

  - ``"block-jacobi rotations"`` — each round's rotations of
    :func:`repro_torch.core.eig.block_jacobi_eigh` (the ``jacobi`` eig
    backend), computed in f64 for every input dtype;
  - ``"jacobi-svd rotations"`` — the block rotations of
    :func:`repro_torch.core.svd.jacobi_svd`, likewise.

  Nothing else is marked: an f32 dynamic plan given a fixed ``l``
  computes its coefficients in f64 and is flagged, as the reference's
  audit flags the same plan.
* **host syncs** (the counterpart of "no host callbacks") — every
  ``aten._local_scalar_dense`` (a tensor value read on the host:
  ``float(t)``, ``bool(t)``, ``t.item()``) and every device-to-host copy.
  A plan whose polar backend has the registry flag ``dynamic=False`` and
  whose eig method is ``eigh`` owes none: a serving sweep only overlaps
  compute if the static path never stalls the host.  The dynamic, QDWH
  and Jacobi host loops are settled designs: their count is reported,
  not flagged.
* **kernel launches** — the Hopper kernels are bound through ``ctypes``
  (:mod:`repro_torch.kernels.build`), below the dispatcher, so the mode
  cannot see them; the deltas of the wrappers' launch counters are read
  into ``kernel_launches``.

What the mode cannot see: the inside of one operator.  A sync inside an
aten kernel's own implementation — the cuSOLVER info check of
``torch.linalg.eigh`` — and the stream synchronisation of a pageable
host-to-device copy (``torch.tensor(..., device="cuda")``) are not
dispatched operators.  On a CUDA plan the audit also runs under CUDA's
sync debug mode and reports the synchronising calls it warns about as
``device_syncs`` (None on the CPU), by the Python line that made each
(``device_sync_sites``); they are reported, not budgeted.

Counts are of one run on one input: ``SvdPlan.audit(a)`` /
``TopKPlan.audit(a)`` run the plan's impl on ``a``, or with ``a=None``
on :func:`audit_input`'s deterministic matrix.  A grouped plan's audit
runs its collectives, so every rank of its mesh must audit it together.
Module counters (:func:`audit_stats`) feed
``SvdService.stats()["plan_audits"]``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "AuditError",
    "AuditReport",
    "MODE_SEP_PSUMS",
    "WIDE_OK_SCOPES",
    "audit_all_plans",
    "audit_callable",
    "audit_input",
    "audit_plan",
    "audit_stats",
    "executed_dynamic_psums",
    "expected_grouped_psums",
    "reset_audit_stats",
    "wide_ok",
]

# the all-reduce spellings of c10d (every other c10d op is a collective
# too: gathers, broadcasts, reduce-scatters)
PSUM_OPS = {"allreduce_", "allreduce_coalesced_"}
# f64 outputs of these operators are *compute* in a wide dtype (the casts,
# copies and views framing an f32-compute plan's f64 I/O are fine); the
# aten names of the reference's WIDE_COMPUTE_PRIMS, in-place forms
# included
WIDE_COMPUTE_OPS = {
    "mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot",
    "linalg_cholesky_ex", "cholesky", "linalg_solve_triangular",
    "triangular_solve", "_linalg_eigh", "linalg_eig", "linalg_qr", "geqrf",
    "linalg_householder_product", "orgqr", "ormqr", "_linalg_svd",
    "linalg_lu_factor_ex", "linalg_inv_ex", "add", "sub", "rsub", "mul",
    "div", "sqrt", "rsqrt", "exp", "log", "pow", "reciprocal", "sum",
    "mean", "amax", "amin", "linalg_vector_norm", "addcmul", "addcdiv",
}
# one distributed-Gram "sep" psum per shared-Gram Cholesky term, two for
# the CholeskyQR2 term (X-Gram + Q1-Gram; the Q2-Gram is gram_local and
# owes NO reduction), none for structured Householder QR
MODE_SEP_PSUMS = {"chol": 1, "cholqr2": 2, "householder": 0}
# the deliberate f64 sites of f32 plans (module docstring)
WIDE_OK_SCOPES = ("block-jacobi rotations", "jacobi-svd rotations")
# the conditioning of the audit input of a plan with no kappa hint
AUDIT_KAPPA = 1e3

_STATS = {"audited": 0, "passed": 0, "failed": 0}
_WIDE_OK: List[str] = []  # the open wide_ok scopes, innermost last


def audit_stats() -> Dict[str, int]:
    """Monotonic audit counters (consumed by ``SvdService.stats()``)."""
    return dict(_STATS)


def reset_audit_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


class wide_ok:
    """A named no-op scope: f64 compute inside it is deliberate, and the
    audit counts it under the scope's name instead of flagging it.  Only
    the sites of :data:`WIDE_OK_SCOPES` take one."""

    __slots__ = ("reason",)

    def __init__(self, reason: str):
        if reason not in WIDE_OK_SCOPES:
            raise ValueError(f"unknown wide_ok scope {reason!r}; the "
                             f"deliberate f64 sites are {WIDE_OK_SCOPES}")
        self.reason = reason

    def __enter__(self):
        _WIDE_OK.append(self.reason)
        return self

    def __exit__(self, *exc):
        _WIDE_OK.pop()
        return False


class AuditError(RuntimeError):
    """A plan's run violates a structural invariant."""

    def __init__(self, report: "AuditReport"):
        self.report = report
        lines = "\n  ".join(report.violations)
        super().__init__(
            f"plan audit failed for {report.entry}:\n  {lines}")


@dataclasses.dataclass
class AuditReport:
    """What one audited run revealed."""

    entry: str
    psum_counts: Dict[str, int]        # all-reduces per axis
    axis_names: Tuple[str, ...]        # every collective axis seen
    wide_compute: int                  # flagged f64/c128 compute ops
    host_syncs: int
    checks: List[str]
    violations: List[str]
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    wide_ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    wide_ok: Dict[str, int] = dataclasses.field(default_factory=dict)
    host_sync_ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    device_syncs: Optional[int] = None
    device_sync_sites: Dict[str, int] = dataclasses.field(
        default_factory=dict)    # "module.py:line" -> synchronising calls
    expect_psums: Optional[Dict[str, int]] = None

    @property
    def ok(self) -> bool:
        return not self.violations


def _op_name(func) -> Tuple[str, str]:
    """("aten", "mm") for ``aten.mm.default``; an in-place name keeps its
    trailing underscore (c10d names carry one: "allreduce_")."""
    qual = func.name()
    ns, _, rest = qual.partition("::")
    return ns, rest.split(".", 1)[0]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for item in x:
            yield from _tensors(item)


def _process_group(args):
    """The process group a c10d op runs on (its one ScriptObject arg)."""
    import torch.distributed as dist

    for arg in args:
        if isinstance(arg, torch.ScriptObject):
            return dist.ProcessGroup.unbox(arg)
    return None


class _Recorder(TorchDispatchMode):
    """Counts what the audited run dispatches (see the module docstring)."""

    def __init__(self, axes: Dict[int, str]):
        super().__init__()
        self.axes = axes
        self.psums: Dict[str, int] = collections.Counter()
        self.collectives: Dict[str, int] = collections.Counter()
        self.seen_axes: List[str] = []
        self.wide_ops: Dict[str, int] = collections.Counter()
        self.wide_ok: Dict[str, int] = collections.Counter()
        self.syncs: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = _op_name(func)
        if ns == "c10d":
            group = _process_group(args)
            axis = self.axes.get(id(group), "unbound")
            if axis not in self.seen_axes:
                self.seen_axes.append(axis)
            self.collectives[f"{axis}:{name}"] += 1
            if name in PSUM_OPS:
                self.psums[axis] += 1
        elif name == "_local_scalar_dense":
            self.syncs[name] += 1
        elif name in ("_to_copy", "copy_") and self._device_to_host(
                name, args, kwargs, out):
            self.syncs[f"{name} (device to host)"] += 1
        elif name.rstrip("_") in WIDE_COMPUTE_OPS and any(
                t.dtype in (torch.float64, torch.complex128)
                for t in _tensors(out)):
            if _WIDE_OK:
                self.wide_ok[_WIDE_OK[-1]] += 1
            else:
                self.wide_ops[name] += 1
        return out

    @staticmethod
    def _device_to_host(name, args, kwargs, out) -> bool:
        if name == "copy_":
            dst, src = args[0], args[1]
        else:
            dst, src = out, args[0]
        return (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                and src.device.type != "cpu" and dst.device.type == "cpu")


def _launch_counts() -> Dict[str, int]:
    """{kernel: launches} and {"kernel/route": launches} of the wrappers."""
    from repro_torch.kernels import (flash_attention, gram, grouped_combine,
                                     matmul)

    counts = {}
    for mod in (gram, grouped_combine, matmul, flash_attention):
        name = mod.__name__.rsplit(".", 1)[-1]
        counts[name] = mod.launches
        for route, c in getattr(mod, "launches_by_route", {}).items():
            counts[f"{name}/{route}"] = c
    return counts


ExpectPsums = Union[None, Dict[str, int], Callable[[Any], Optional[Dict]]]


def audit_callable(
    fn,
    args: Sequence[Any],
    *,
    entry: str = "callable",
    axes: Optional[Dict[Any, str]] = None,
    expect_psums: ExpectPsums = None,
    allow_collectives: bool = True,
    forbid_wide_compute: bool = False,
    forbid_host_syncs: bool = False,
    raise_on_fail: bool = True,
) -> AuditReport:
    """Run ``fn(*args)`` once under the recording mode and check it.

    ``axes`` maps each process group the callable may use to its axis
    name ("sep", "zolo"); a collective on any other group is a violation.
    ``expect_psums`` is the exact per-axis all-reduce budget, or a
    callable taking ``fn``'s output and returning it (None skips the
    count check); ``allow_collectives=False`` asserts a collective-free
    run (the non-grouped contract); ``forbid_wide_compute`` rejects
    f64/c128 compute outside :class:`wide_ok` scopes (the
    compute_dtype <= f32 contract); ``forbid_host_syncs`` rejects host
    syncs (the static-path contract).
    """
    axes = {id(g): ax for g, ax in (axes or {}).items()}
    cuda = any(t.is_cuda for t in _tensors(list(args)))
    before = _launch_counts()
    rec = _Recorder(axes)
    with warnings.catch_warnings(record=True) as caught:
        if cuda:
            warnings.simplefilter("always")
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with rec:
                out = fn(*args)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(prev)
    after = _launch_counts()
    syncing = [w for w in caught if "synchroniz" in str(w.message)]
    device_syncs = len(syncing) if cuda else None
    sites = collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in syncing)
    if cuda:
        torch.cuda.synchronize()

    violations: List[str] = []
    checks = ["collective-axis-validity"]
    for key, n in rec.collectives.items():
        axis, op = key.split(":", 1)
        if not allow_collectives:
            violations.append(f"collective {op} in a non-grouped graph "
                              f"({n} call(s))")
        elif axis == "unbound":
            violations.append(
                f"{op} over a process group not bound by the plan's mesh "
                f"(axes: {sorted(set(axes.values()))})")

    wide = sum(rec.wide_ops.values())
    if forbid_wide_compute:
        checks.append("no-f64-compute")
        if wide:
            violations.append(
                f"{wide} f64/c128 compute op(s) in an f32-compute plan "
                f"({dict(rec.wide_ops)}; the compute_dtype cast is "
                f"leaking)")

    syncs = sum(rec.syncs.values())
    if forbid_host_syncs:
        checks.append("no-host-syncs")
        if syncs:
            violations.append(
                f"{syncs} host sync(s) in a static plan "
                f"({dict(rec.syncs)}; the solve stalls the host, which "
                f"breaks overlapped serving)")

    want = expect_psums(out) if callable(expect_psums) else expect_psums
    counts = {ax: n for ax, n in rec.psums.items()}
    if want is not None:
        checks.append("psum-count")
        for ax, n_want in want.items():
            got = counts.get(ax, 0)
            if got != n_want:
                hint = ("a Gram is reduced twice — the gram_local "
                        "double-psum class" if got > n_want
                        else "a reduction is missing — a partial Gram "
                        "or combine never left its shard")
                violations.append(
                    f"expected {n_want} {ax!r}-axis psum(s), found {got} "
                    f"({hint})")
        for ax in counts:
            if ax not in want:
                violations.append(
                    f"unbudgeted psum axis {ax!r} ({counts[ax]} call(s))")

    report = AuditReport(
        entry=entry, psum_counts=counts, axis_names=tuple(rec.seen_axes),
        wide_compute=wide, host_syncs=syncs, checks=checks,
        violations=violations, collectives=dict(rec.collectives),
        wide_ops=dict(rec.wide_ops), wide_ok=dict(rec.wide_ok),
        host_sync_ops=dict(rec.syncs),
        kernel_launches={k: after[k] - before[k] for k in after},
        device_syncs=device_syncs, device_sync_sites=dict(sites),
        expect_psums=want)
    _STATS["audited"] += 1
    _STATS["passed" if report.ok else "failed"] += 1
    if raise_on_fail and not report.ok:
        raise AuditError(report)
    return report


def expected_grouped_psums(
    method: str,
    backend_kwargs: Dict[str, Any],
    *,
    sep: int = 1,
) -> Optional[Dict[str, int]]:
    """Per-axis all-reduce budget of one grouped plan's whole graph, or
    None when ``method`` is not a modelled grouped backend (the reference's
    model, copied).

    Counts are *static over the lowered jaxpr* in the reference — every
    compiled branch of the dynamic solver's peeled first iteration
    contributes, whether or not it executes.  The port runs one branch:
    :func:`executed_dynamic_psums` is its dynamic budget.
    """
    if method == "zolo_grouped":
        sched = backend_kwargs.get("schedule") or ()
        iters = len(sched)
        if not iters:
            return None
        qr_mode = backend_kwargs.get("qr_mode", "cholqr2")
        qr_iters = min(int(backend_kwargs.get("qr_iters", 1)), iters)
        return {
            "sep": qr_iters * MODE_SEP_PSUMS[qr_mode]
            + (iters - qr_iters) * MODE_SEP_PSUMS["chol"],
            "zolo": iters,
        }
    if method == "zolo_grouped_dynamic":
        # in-graph sigma_min bound (skipped when the plan pinned l)
        est = 0 if "l" in backend_kwargs else 1
        first_mode = backend_kwargs.get("first_mode", "auto")
        if first_mode == "auto":
            # three compiled branches; structured Householder QR is only
            # row-distributable at sep == 1, else the extreme-regime
            # branch substitutes shifted CholeskyQR2
            hh = ("householder" if sep == 1 else "cholqr2")
            first_sep = (MODE_SEP_PSUMS[hh] + MODE_SEP_PSUMS["cholqr2"]
                         + MODE_SEP_PSUMS["chol"])
            first_zolo = 3
        else:
            first_sep = MODE_SEP_PSUMS[first_mode]
            first_zolo = 1
        # + 1 fused fnorm_pair psum for the peeled residual (the two
        # residual-rule norms ride one length-2 all-reduce; see
        # sep_reduce_ops.fnorm_pair), + (1 Gram + 1 fnorm_pair) per
        # while-loop body, + 1 "zolo" combine in the body
        return {
            "sep": est + first_sep + 1 + 2,
            "zolo": first_zolo + 1,
        }
    return None


def executed_dynamic_psums(first_mode: str, iters: int,
                           estimate: bool = True) -> Dict[str, int]:
    """The reference's dynamic budget (:func:`expected_grouped_psums`)
    over the branches a run executes: the sigma_min estimate's Gram (when
    the plan does not pin l), the first iteration's term and fused
    residual, then one Gram and one residual per Cholesky iteration; one
    "zolo" combine per iteration."""
    if first_mode not in MODE_SEP_PSUMS:
        raise ValueError(f"unknown first_mode {first_mode!r}; known: "
                         f"{sorted(MODE_SEP_PSUMS)}")
    return {"sep": int(estimate) + MODE_SEP_PSUMS[first_mode] + 1
            + (iters - 1) * 2,
            "zolo": iters}


def _first_branch(l_init: float, sep: int, eps: float) -> str:
    """The dynamic solver's "auto" first iteration for a bound l_init
    (``repro_torch.core.zolo.run_dynamic``'s regime rule)."""
    if l_init >= 0.05:
        return "chol"
    if l_init >= 10.0 * math.sqrt(eps):
        return "cholqr2"
    return "householder" if sep == 1 else "cholqr2"


def _grouped_budget(plan):
    """The per-axis all-reduce budget of a grouped plan's run, as a
    function of its ``_svd_impl_info`` output (the dynamic solver's
    iterations and bound decide what it executes)."""
    kw = plan._backend_kwargs
    sep, r = plan.sep, plan.r

    def budget(out):
        if plan.method == "zolo_grouped":
            want = expected_grouped_psums(plan.method, kw, sep=sep)
        elif plan.method == "zolo_grouped_dynamic":
            info = out[3]
            first = kw.get("first_mode", "auto")
            if first == "auto":
                eps = torch.finfo(torch.promote_types(
                    plan.compute_dtype, torch.float32)).eps
                first = _first_branch(float(info.l_init), sep, eps)
            want = executed_dynamic_psums(first, int(info.iterations),
                                          estimate="l" not in kw)
        else:
            return None
        if want is None:
            return None
        # a collective over a one-rank group is not issued
        return {"sep": want["sep"] if sep > 1 else 0,
                "zolo": want["zolo"] if r > 1 else 0}

    return budget


def _narrow(dtype) -> bool:
    """True when ``dtype`` is a floating dtype of at most 4 bytes — the
    regime where any f64 compute op is a leak."""
    return dtype.is_floating_point and dtype.itemsize <= 4


def audit_input(shape, dtype, device, kappa: Optional[float] = None):
    """The deterministic audit matrix: singular vectors from a generator
    seeded with 0 on ``device``, a geometric spectrum from 1 to 1/kappa
    (:data:`AUDIT_KAPPA` when None), built in f32-or-better and cast to
    ``dtype``."""
    m, n = (int(d) for d in shape)
    k = min(m, n)
    kappa = AUDIT_KAPPA if kappa is None else float(kappa)
    work = torch.promote_types(dtype, torch.float32)
    gen = torch.Generator(device=device).manual_seed(0)
    u, _ = torch.linalg.qr(torch.randn((m, k), generator=gen, dtype=work,
                                       device=device))
    v, _ = torch.linalg.qr(torch.randn((n, k), generator=gen, dtype=work,
                                       device=device))
    s = torch.logspace(0.0, -math.log10(kappa), k, dtype=work,
                       device=device)
    return ((u * s) @ v.mT).to(dtype)


def audit_plan(plan, a=None, *, raise_on_fail: bool = True) -> AuditReport:
    """Audit a live ``SvdPlan`` or ``TopKPlan`` by running its impl on
    ``a`` (None: :func:`audit_input` at the plan's shape, dtype, device
    and kappa hint).  Duck-typed: an SvdPlan exposes ``_svd_impl`` (the
    richest path: backend + H + eig stage), a TopKPlan ``_impl``."""
    if not hasattr(plan, "_svd_impl") and not hasattr(plan, "_impl"):
        raise TypeError(
            f"audit_plan: {type(plan).__name__} exposes neither _svd_impl "
            f"nor _impl — not a plan object")
    from repro_torch.core import registry as _registry

    shape = tuple(plan.shape)
    dtype_name = _registry.dtype_name(plan.dtype)
    if hasattr(plan, "_svd_impl"):
        if a is None:
            a = audit_input(shape, plan.dtype, plan.device,
                            plan.resolution.kappa)
        plan._check(a)
        grouped = plan.mode == "grouped"
        axes = {}
        if grouped:
            axes = {plan.mesh.sep_group: "sep", plan.mesh.zolo_group: "zolo"}
        return audit_callable(
            plan._svd_impl_info, (a,),
            entry=f"SvdPlan[{plan.method}, {shape}, {dtype_name}]",
            axes=axes,
            expect_psums=_grouped_budget(plan) if grouped else None,
            allow_collectives=grouped,
            forbid_wide_compute=_narrow(plan.compute_dtype),
            forbid_host_syncs=(not plan._spec.dynamic
                               and plan.eig_method == "eigh"),
            raise_on_fail=raise_on_fail)
    if a is None:
        a = audit_input(shape, plan.dtype, plan.device,
                        plan.decision.get("kappa"))
    plan._check(a)
    draw = plan.draw()
    compute = plan.config.svd.compute_dtype
    compute = plan.dtype if compute is None else getattr(torch, compute)
    inner_static = all(not p._spec.dynamic and p.eig_method == "eigh"
                       for p in plan._inner.values())
    return audit_callable(
        lambda x: plan._impl(x, draw), (a,),
        entry=f"TopKPlan[{plan.strategy}, {shape}, k={plan.config.k}]",
        allow_collectives=False,
        forbid_wide_compute=_narrow(compute),
        forbid_host_syncs=plan.strategy != "dnc" and inner_static,
        raise_on_fail=raise_on_fail)


def audit_all_plans(raise_on_fail: bool = False):
    """Audit every plan currently held by the solver and spectral plan
    caches, each on its :func:`audit_input`.  Returns ``[(entry,
    violations)]`` for the failures.  A grouped plan's audit is
    collective: in a multi-rank program every rank calls this with the
    same caches."""
    from repro_torch.solver import planner as _planner
    from repro_torch.spectral import topk as _topk

    failures: List[Tuple[str, List[str]]] = []
    plans = (list(_planner._PLANS.values())
             + list(_topk._TOPK_PLANS.values()))
    for plan in plans:
        try:
            report = audit_plan(plan, raise_on_fail=False)
        except Exception as e:  # noqa: BLE001 — a plan that cannot run
            # (its mesh's process groups are gone) is a failure to report
            failures.append((repr(plan), [f"audit could not run: {e}"]))
            continue
        if not report.ok:
            failures.append((report.entry, report.violations))
    if raise_on_fail and failures:
        raise RuntimeError(f"plan audits failed: {failures}")
    return failures
