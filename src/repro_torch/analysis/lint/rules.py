"""Built-in lint rules of the port — the reference's seven, in torch form.

Each rule encodes a bug this codebase already hit.  Three are free of any
framework idiom and keep the reference's logic unchanged; four are bound
to an idiom (JAX's axis names, ``preferred_element_type``, tracers,
Pallas ``*_ref`` bodies), so the port gets the torch form of each: the
same historical bug, written the way it would be written in PyTorch.

=====================  ==================================================
rule (reference rule)  historical bug it encodes
=====================  ==================================================
collective-axis        A c10d collective with no ``group=`` reduces over
(collective-axis)      WORLD: right on one rank, a double reduction on a
                       (2, 2) mesh (the ``gram_local`` double-psum class);
                       a literal mesh-dimension name the module never
                       declares; ``implicit_replication()`` without a
                       written reason (the counterpart of
                       ``check_rep=False``).
accum-dtype            A product (``mm``/``matmul``/``bmm``/``einsum``/
(accum-dtype)          ``@``) whose result reaches a Cholesky/QR/eigh/SVD
                       accumulates in its operands' dtype: bf16 operands
                       feed the factorization a Gram that is not
                       numerically PSD.  Pin ``out_dtype=`` or cast the
                       operands to f32 or wider first.
plan-key-hygiene       Plan caches key on the config dataclass: a mutable
(plan-key-hygiene)     or unhashable config (a list, a dict, a tensor)
                       explodes at lookup or silently defeats the cache.
host-sync              A blocking host/device transfer (``.item()``,
(retrace-hazard)       ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()``
                       of a tensor, ``torch.tensor(host, device=)``, a
                       Python ``if`` on a tensor) inside a body that must
                       not synchronise: the static solve held the host
                       until the card caught up, 9-11 times a solve,
                       before its uploads became non-blocking.
bare-assert            Library ``assert`` vanishes under ``python -O`` and
(bare-assert)          names no operands.
keyerror-dispatch      ``TABLE[name]`` on an unguarded parameter raises a
(keyerror-dispatch)    bare ``KeyError`` naming no valid choice.
kernel-accum-envelope  A kernel wrapper module that binds its accumulator
(kernel-accum-         dtype but no envelope pointer leaves the planner's
envelope)              kappa gate undiscoverable next to the kernel; an
                       f32 output allocated with a literal dtype drifts
                       from the accumulator the envelope was measured at.
=====================  ==================================================

Heuristics are precision-first: what a rule cannot prove from the AST it
stays silent about (a group passed through a variable, a dtype chosen at
run time, a table built dynamically).  The plan audit
(:mod:`repro_torch.analysis.plan_audit`) covers the run-time side.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.lint.engine import (
    FileContext,
    Finding,
    register_rule,
)

# ---------------------------------------------------------------------------
# shared AST helpers


def _call_name(node: ast.Call) -> str:
    """Dotted name of a call target: ``dist.all_reduce`` ->
    ``dist.all_reduce``."""
    return _dotted(node.func)


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def _tail(node: ast.Call) -> str:
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _str_consts(node: ast.AST) -> List[str]:
    """All string literals in an expression (tuples/lists flattened)."""
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            out.append(sub.value)
    return out


def _kwarg(node: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _functions(tree: ast.AST) -> List[ast.FunctionDef]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _params(fn: ast.FunctionDef) -> List[ast.arg]:
    args = fn.args
    out = args.posonlyargs + args.args + args.kwonlyargs
    if args.vararg:
        out.append(args.vararg)
    if args.kwarg:
        out.append(args.kwarg)
    return out


def _launches_kernel(fn: ast.FunctionDef) -> bool:
    """Does ``fn`` load a hand-written kernel (``build.library(...)``)?"""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _tail(node) == "library" and \
                isinstance(node.func, ast.Attribute) and \
                "build" in _dotted(node.func.value):
            return True
    return False


def _import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local name -> the dotted module path it stands for, from the
    module's imports (``import torch.distributed as dist`` gives
    ``dist -> torch.distributed``)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    out[alias.asname] = alias.name
                else:
                    top = alias.name.split(".", 1)[0]
                    out[top] = top
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    return out


def _resolve(name: str, aliases: Dict[str, str]) -> str:
    head, _, rest = name.partition(".")
    if head in aliases:
        base = aliases[head]
        return f"{base}.{rest}" if rest else base
    return name


# ---------------------------------------------------------------------------
# collective-axis (torch form)


class CollectiveAxisRule:
    """c10d collectives must name their process group (a missing group is
    WORLD); literal mesh-dimension names must be declared in the module;
    ``implicit_replication()`` needs a justification comment that
    mentions ``implicit_replication``."""

    name = "collective-axis"
    doc = ("c10d collectives must pass group= (a missing group is WORLD); "
           "literal mesh dim names must be declared in the module; "
           "implicit_replication() requires an 'implicit_replication' "
           "justification comment")

    # the position of ``group`` among the positional parameters
    C10D = {"all_reduce": 2, "all_gather": 2, "all_gather_into_tensor": 2,
            "reduce_scatter": 3, "reduce_scatter_tensor": 3, "broadcast": 2,
            "all_to_all": 2, "all_to_all_single": 4, "reduce": 3}
    FUNCTIONAL = {"all_reduce": 2, "all_gather_tensor": 2,
                  "reduce_scatter_tensor": 3, "all_to_all_single": 3,
                  "broadcast": 2, "all_reduce_coalesced": 2,
                  "all_gather_into_tensor_coalesced": 1}
    C10D_MODULES = ("torch.distributed",
                    "torch.distributed.distributed_c10d")
    FUNCTIONAL_MODULE = "torch.distributed._functional_collectives"
    DIM_PARAMS = {"axis", "axis_name", "axis_names", "data_axis",
                  "mesh_dim", "mesh_dim_name", "dim_name", "data_dim",
                  "model_dim"}
    DIM_LOOKUPS = {"get_group", "get_local_rank", "size"}

    def _collective(self, node: ast.Call,
                    aliases: Dict[str, str]) -> Optional[Tuple[str, int]]:
        full = _resolve(_call_name(node), aliases)
        mod, _, tail = full.rpartition(".")
        if mod in self.C10D_MODULES and tail in self.C10D:
            return tail, self.C10D[tail]
        if mod == self.FUNCTIONAL_MODULE and tail in self.FUNCTIONAL:
            return tail, self.FUNCTIONAL[tail]
        return None

    def declared_dims(self, ctx: FileContext) -> Set[str]:
        dims: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                # init_device_mesh(..., mesh_dim_names=("data", "model"))
                kw = _kwarg(node, "mesh_dim_names")
                if kw is not None:
                    dims.update(_str_consts(kw))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                named = args.posonlyargs + args.args + args.kwonlyargs
                defaults = ([None] * (len(args.posonlyargs) + len(args.args)
                                      - len(args.defaults))
                            + list(args.defaults) + list(args.kw_defaults))
                for a, d in zip(named, defaults):
                    if a.arg in self.DIM_PARAMS and d is not None:
                        dims.update(_str_consts(d))
            elif isinstance(node, ast.Assign):
                # module/function constants naming dims:
                #   MESH_AXES = ("data", "model")
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and any(
                            k in tgt.id.lower()
                            for k in ("axis", "axes", "dim_names")):
                        dims.update(_str_consts(node.value))
        return dims

    def _dim_uses(self, ctx: FileContext):
        """(node, literal) for each literal mesh-dimension name looked up:
        ``mesh["data"]``, ``mesh.get_group("data")``,
        ``mesh.mesh_dim_names.index("data")``, ``"data" in
        mesh.mesh_dim_names``."""
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Subscript) and \
                    "mesh" in _dotted(node.value).rsplit(".", 1)[-1].lower():
                for lit in _str_consts(node.slice):
                    yield node, lit
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                recv = _dotted(node.func.value)
                if node.func.attr in self.DIM_LOOKUPS and \
                        "mesh" in recv.rsplit(".", 1)[-1].lower():
                    for arg in node.args[:1] + [
                            kw.value for kw in node.keywords
                            if kw.arg == "mesh_dim"]:
                        for lit in _str_consts(arg):
                            yield node, lit
                elif node.func.attr == "index" and \
                        recv.endswith("mesh_dim_names"):
                    for arg in node.args[:1]:
                        for lit in _str_consts(arg):
                            yield node, lit
            elif isinstance(node, ast.Compare) and any(
                    isinstance(op, (ast.In, ast.NotIn)) for op in node.ops) \
                    and any(_dotted(c).endswith("mesh_dim_names")
                            for c in node.comparators):
                for lit in _str_consts(node.left):
                    yield node, lit

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        aliases = _import_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            hit = self._collective(node, aliases)
            if hit is not None:
                tail, pos = hit
                group = _kwarg(node, "group")
                if group is None and len(node.args) > pos:
                    group = node.args[pos]
                if group is None or (isinstance(group, ast.Constant)
                                     and group.value is None):
                    yield ctx.finding(
                        node, self.name,
                        f"{tail}() without an explicit group= reduces over "
                        f"WORLD: right on one rank, a double reduction on "
                        f"a (2, 2) mesh")
            if _call_name(node).rsplit(".", 1)[-1] == "implicit_replication":
                near = ctx.comment_near(node.lineno)
                if "implicit_replication" not in near:
                    yield ctx.finding(
                        node, self.name,
                        "implicit_replication() without a justification "
                        "comment mentioning 'implicit_replication' (it "
                        "silences DTensor's placement checks, as "
                        "check_rep=False silenced the replication rules)")
        declared = self.declared_dims(ctx)
        for node, lit in self._dim_uses(ctx):
            if lit in declared:
                continue
            known = (f"known: {sorted(declared)}" if declared else
                     "no mesh dims are declared in this module at all")
            yield ctx.finding(
                node, self.name,
                f"mesh dim {lit!r} is not declared in this module ({known})")


# ---------------------------------------------------------------------------
# accum-dtype (torch form)


WIDE_DTYPES = {"float32", "float", "float64", "double", "complex64",
               "cfloat", "complex128", "cdouble"}
WIDE_CASTS = {"float", "double"}
# the port's f32-or-wider helper (kernels/ref.py): promote_types(d, f32)
WIDE_DTYPE_CALLS = {"accum_dtype"}


MOVE_KWARGS = {"device", "non_blocking", "copy", "memory_format"}


def _device_like(node: ast.AST) -> bool:
    """Is ``node`` a device (``"cuda"``, ``torch.device(...)``, a name
    such as ``dev`` or ``x.device``), not a dtype?"""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, ast.Call):
        return _tail(node) == "device"
    name = _dotted(node).rsplit(".", 1)[-1].lower()
    return "dev" in name and "dtype" not in name


def _wide_dtype(node: Optional[ast.AST], wide_names: Set[str]) -> bool:
    """Is ``node`` a dtype the AST proves is f32 or wider?"""
    if node is None:
        return False
    if isinstance(node, ast.Attribute):
        return (node.attr in WIDE_DTYPES
                and _dotted(node.value).rsplit(".", 1)[-1] == "torch")
    if isinstance(node, ast.Name):
        return node.id in wide_names
    if isinstance(node, ast.Call):
        tail = _tail(node)
        if tail in WIDE_DTYPE_CALLS:
            return True
        if tail == "promote_types":
            return any(_wide_dtype(a, wide_names) for a in node.args)
    return False


class AccumDtypeRule:
    """Products feeding a factorization must pin their accumulator:
    ``mm``/``matmul``/``bmm``/``einsum``/``addmm``/``@`` results that reach
    ``cholesky``/``cholesky_ex``/``qr``/``eigh``/``svd``/``cholesky_qr2``/
    ``structured_qr_factor`` need ``out_dtype=``, or operands this
    function cast to f32 or wider (``.float()``, ``.double()``,
    ``.to(torch.float32)``, ``.to(accum_dtype(...))``)."""

    name = "accum-dtype"
    doc = ("products feeding cholesky/qr/eigh/svd must pin out_dtype= or "
           "take operands cast to f32 or wider (bf16 accumulation feeds "
           "the factorization a Gram that is not PSD)")

    PRODUCTS = {"mm", "matmul", "bmm", "einsum", "addmm", "baddbmm",
                "tensordot"}
    SINKS = {"cholesky", "cholesky_ex", "qr", "eigh", "eig", "svd",
             "cholesky_qr2", "structured_qr_factor"}
    # views and copies that keep the dtype of what they are taken of
    KEEP_DTYPE = {"mT", "T", "mH", "H", "transpose", "conj", "contiguous",
                  "clone", "detach", "reshape", "view", "unsqueeze",
                  "squeeze", "narrow", "expand", "flatten", "permute",
                  "tril", "triu", "abs", "neg", "sqrt", "diag_embed",
                  "diagonal"}
    # calls whose result has one operand's dtype (torch type promotion
    # widens a mix towards the widest)
    PROMOTING = {"add", "sub", "mul", "div", "where", "cat", "stack"}

    def _assignments(self, fn: ast.FunctionDef):
        """Each name's assignments in ``fn``, in source order."""
        assigns: Dict[str, List[Tuple[int, ast.expr]]] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        assigns.setdefault(tgt.id, []).append(
                            (node.lineno, node.value))
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and isinstance(node.target, ast.Name):
                assigns.setdefault(node.target.id, []).append(
                    (node.lineno, node.value))
        for lst in assigns.values():
            lst.sort(key=lambda t: t[0])
        return assigns

    def _wide_names(self, assigns, known: Set[str]) -> Set[str]:
        """``known`` and the names every assignment binds to a wide
        dtype."""
        wide = set(known)
        for _ in range(3):
            for name, lst in assigns.items():
                if lst and all(_wide_dtype(v, wide) for _, v in lst):
                    wide.add(name)
        return wide

    def _is_wide(self, node: ast.AST, line: int, assigns, wide_dt: Set[str],
                 depth: int = 0) -> bool:
        """Does the AST prove ``node`` (an operand) is a tensor of f32 or
        wider dtype at ``line``?"""
        if depth > 8:
            return False
        if isinstance(node, ast.UnaryOp):
            return self._is_wide(node.operand, line, assigns, wide_dt,
                                 depth + 1)
        if isinstance(node, ast.Subscript):
            return self._is_wide(node.value, line, assigns, wide_dt,
                                 depth + 1)
        if isinstance(node, ast.Attribute):
            if node.attr in self.KEEP_DTYPE:
                return self._is_wide(node.value, line, assigns, wide_dt,
                                     depth + 1)
            return False
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.MatMult):
                return self._pinned_product(node, line, assigns, wide_dt,
                                            depth + 1)
            # type promotion: the result is at least as wide as either
            return (self._is_wide(node.left, line, assigns, wide_dt,
                                  depth + 1)
                    or self._is_wide(node.right, line, assigns, wide_dt,
                                     depth + 1))
        if isinstance(node, ast.Call):
            tail = _tail(node)
            func = node.func
            if tail in WIDE_CASTS and isinstance(func, ast.Attribute) \
                    and not node.args:
                return True
            dt = _kwarg(node, "dtype")
            if dt is not None and _wide_dtype(dt, wide_dt):
                return True  # x.to(dtype=...), torch.eye(..., dtype=...)
            if tail in ("to", "type") and isinstance(func, ast.Attribute):
                if any(_wide_dtype(a, wide_dt) for a in node.args):
                    return True
                # x.to(device, non_blocking=True) keeps x's dtype
                moves = tail == "to" and all(
                    _device_like(a) for a in node.args) and all(
                    kw.arg in MOVE_KWARGS for kw in node.keywords)
                return moves and self._is_wide(func.value, line, assigns,
                                               wide_dt, depth + 1)
            if isinstance(func, ast.Attribute) and tail in self.KEEP_DTYPE:
                return self._is_wide(func.value, line, assigns, wide_dt,
                                     depth + 1)
            if tail in self.PROMOTING:
                operands = list(node.args)
                if isinstance(func, ast.Attribute) and \
                        _dotted(func.value) != "torch":
                    operands.append(func.value)
                return any(self._is_wide(a, line, assigns, wide_dt,
                                         depth + 1) for a in operands
                           if not isinstance(a, (ast.List, ast.Tuple)))
            if tail in self.PRODUCTS:
                return self._pinned_product(node, line, assigns, wide_dt,
                                            depth + 1)
            return False
        if isinstance(node, ast.Name):
            prior = [v for ln, v in assigns.get(node.id, ()) if ln < line]
            if not prior:
                return False
            last_line = max(ln for ln, _ in assigns[node.id] if ln < line)
            return self._is_wide(prior[-1], last_line, assigns, wide_dt,
                                 depth + 1)
        return False

    def _operands(self, node: ast.AST) -> List[ast.AST]:
        if isinstance(node, ast.BinOp):
            return [node.left, node.right]
        call = node
        ops = [a for a in call.args
               if not (isinstance(a, ast.Constant)
                       and isinstance(a.value, str))]
        if isinstance(call.func, ast.Attribute) and \
                _dotted(call.func.value) not in ("torch", "torch.linalg"):
            ops.append(call.func.value)   # a.mm(b): a is an operand
        return ops

    def _pinned_product(self, node: ast.AST, line: int, assigns, wide_dt,
                        depth: int = 0) -> bool:
        """A product pins its accumulator with ``out_dtype=`` or when every
        operand is provably f32 or wider."""
        if isinstance(node, ast.Call) and \
                _kwarg(node, "out_dtype") is not None:
            return True
        ops = self._operands(node)
        return bool(ops) and all(self._is_wide(o, line, assigns, wide_dt,
                                               depth) for o in ops)

    def _product(self, node: ast.AST) -> bool:
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            return True
        return isinstance(node, ast.Call) and _tail(node) in self.PRODUCTS

    def _names_in(self, node: ast.AST) -> Set[str]:
        return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        module_wide: Set[str] = set()
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign) and \
                    _wide_dtype(node.value, module_wide):
                module_wide.update(t.id for t in node.targets
                                   if isinstance(t, ast.Name))
        # a nested def sees its enclosing functions' names (a closure);
        # nested defs are walked by their enclosing function too, so each
        # product is judged once (outermost function wins)
        enclosing: Dict[int, List[ast.FunctionDef]] = {}
        for fn in _functions(ctx.tree):
            for sub in ast.walk(fn):
                if sub is not fn and isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    enclosing.setdefault(id(sub), []).append(fn)
        judged: Set[int] = set()
        for fn in _functions(ctx.tree):
            yield from self._check_fn(ctx, fn, judged, module_wide,
                                      enclosing.get(id(fn), []))

    def _check_fn(self, ctx: FileContext, fn: ast.FunctionDef,
                  judged: Set[int], module_wide: Set[str],
                  outer: List[ast.FunctionDef]):
        sink_args: List[ast.expr] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _tail(node) in self.SINKS:
                sink_args.extend(node.args)
                sink_args.extend(kw.value for kw in node.keywords)
                if isinstance(node.func, ast.Attribute) and \
                        _dotted(node.func.value) not in (
                            "torch", "torch.linalg", "linalg"):
                    sink_args.append(node.func.value)  # x.cholesky()
        if not sink_args:
            return
        assigns: Dict[str, List[Tuple[int, ast.expr]]] = {}
        for scope in outer:
            assigns.update(self._assignments(scope))
        own = self._assignments(fn)
        wide_dt = self._wide_names(assigns, module_wide)
        assigns.update(own)
        wide_dt = self._wide_names(own, wide_dt)
        flat = [(n, ln, v) for n, lst in assigns.items() for ln, v in lst]
        # backward-reachable name set from the sink arguments
        reach: Set[str] = set()
        for arg in sink_args:
            reach |= self._names_in(arg)
        for _ in range(len(flat) + 1):
            grew = False
            for name, _ln, rhs in flat:
                if name in reach:
                    new = self._names_in(rhs) - reach
                    if new:
                        reach |= new
                        grew = True
            if not grew:
                break

        def scan(expr: ast.AST, line: int, how: str):
            for sub in ast.walk(expr):
                if not self._product(sub) or id(sub) in judged:
                    continue
                judged.add(id(sub))
                if self._pinned_product(sub, line, assigns, wide_dt):
                    continue
                op = "@" if isinstance(sub, ast.BinOp) else _tail(sub)
                yield ctx.finding(
                    sub, self.name,
                    f"{op} result {how} a factorization in {fn.name}() "
                    f"with its accumulator unpinned (pass out_dtype= or "
                    f"cast the operands to f32 or wider first)")

        for arg in sink_args:
            yield from scan(arg, getattr(arg, "lineno", fn.lineno) + 1,
                            "feeds")
        for name, ln, rhs in flat:
            if name in reach:
                yield from scan(rhs, ln + 1, f"(via {name!r}) reaches")


# ---------------------------------------------------------------------------
# plan-key-hygiene


class PlanKeyHygieneRule:
    """Config-style dataclasses feed plan-cache keys: they must be
    ``frozen=True`` and must not annotate fields with unhashable or
    array types."""

    name = "plan-key-hygiene"
    doc = ("*Config/*Policy/*Key dataclasses feed cache keys: frozen=True "
           "required, no list/dict/set/ndarray/Tensor-typed fields")

    SUFFIXES = ("Config", "Policy", "Key")
    UNHASHABLE = {"list", "List", "dict", "Dict", "set", "Set",
                  "bytearray", "ndarray", "Array", "Tensor"}

    def _dataclass_deco(self, cls: ast.ClassDef) -> Optional[ast.AST]:
        for deco in cls.decorator_list:
            target = deco.func if isinstance(deco, ast.Call) else deco
            if _dotted(target).rsplit(".", 1)[-1] == "dataclass":
                return deco
        return None

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not node.name.endswith(self.SUFFIXES) or node.name.startswith("_"):
                continue
            deco = self._dataclass_deco(node)
            if deco is None:
                continue
            frozen = False
            if isinstance(deco, ast.Call):
                kw = _kwarg(deco, "frozen")
                frozen = (isinstance(kw, ast.Constant) and kw.value is True)
            if not frozen:
                yield ctx.finding(
                    node, self.name,
                    f"dataclass {node.name} looks like a cache-key config "
                    f"but is not frozen=True (mutable keys defeat the plan "
                    f"cache)")
            for stmt in node.body:
                if not isinstance(stmt, ast.AnnAssign):
                    continue
                ann_names = {_dotted(sub).rsplit(".", 1)[-1]
                             for sub in ast.walk(stmt.annotation)
                             if isinstance(sub, (ast.Name, ast.Attribute))}
                bad = ann_names & self.UNHASHABLE
                if bad:
                    field = stmt.target.id if isinstance(
                        stmt.target, ast.Name) else "?"
                    yield ctx.finding(
                        stmt, self.name,
                        f"{node.name}.{field}: {sorted(bad)[0]}-typed field "
                        f"is unhashable/array-valued — cache keys must hold "
                        f"hashable scalars/tuples")


# ---------------------------------------------------------------------------
# host-sync (the torch form of retrace-hazard)


class HostSyncRule:
    """Inside the bodies that must not synchronise — the static solve
    (functions named ``*_static``), the decode step (``decode_*``,
    ``*_decode``), every kernel launch wrapper (a function that calls
    ``build.library(...)``), and every function of the same module they
    call by name — flag blocking host/device traffic: ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()``/``int()``/
    ``bool()`` of a tensor parameter, ``torch.tensor(..., device=)``
    (a blocking upload) and a Python ``if`` on a tensor parameter."""

    name = "host-sync"
    doc = ("blocking host<->device traffic (.item/.tolist/.cpu/.numpy, "
           "float()/int()/bool() or Python if on a tensor, "
           "torch.tensor(host, device=)) inside a static-solve, decode or "
           "kernel-launch body stalls the host on the card")

    ROOT_NAME = re.compile(r"\w+_static|_?decode(_\w*)?|\w+_decode")
    READBACKS = {"item", "tolist", "cpu", "numpy"}
    COERCERS = {"float", "int", "bool"}
    STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                    "requires_grad", "is_complex", "is_floating_point",
                    "numel", "size", "dim", "data_ptr", "element_size",
                    "stride", "is_contiguous", "names"}
    # attributes only a tensor has (their receiver is a tensor)
    TENSOR_ATTRS = {"mT", "mH", "new_empty", "new_zeros", "new_full",
                    "new_ones", "new_tensor", "contiguous", "numel",
                    "data_ptr", "is_cuda", "detach", "clone", "index_copy_",
                    "copy_", "masked_fill", "unsqueeze", "squeeze",
                    "is_contiguous"}
    TENSOR_ANNOTATIONS = {"Tensor"}

    def _scope(self, ctx: FileContext) -> List[ast.FunctionDef]:
        fns = _functions(ctx.tree)
        by_name: Dict[str, List[ast.FunctionDef]] = {}
        for fn in ctx.tree.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(fn.name, []).append(fn)
        todo = [fn for fn in fns
                if self.ROOT_NAME.fullmatch(fn.name) or _launches_kernel(fn)]
        seen: Dict[int, ast.FunctionDef] = {}
        while todo:
            fn = todo.pop()
            if id(fn) in seen:
                continue
            seen[id(fn)] = fn
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Name):
                    todo.extend(by_name.get(node.func.id, ()))
        # nested functions are walked with their enclosing one
        inner: Set[int] = set()
        for fn in seen.values():
            for sub in ast.walk(fn):
                if sub is not fn and isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    inner.add(id(sub))
        return [fn for k, fn in seen.items() if k not in inner]

    def _tensor_params(self, fn: ast.FunctionDef) -> Set[str]:
        """Parameters the AST proves are tensors: annotated ``Tensor``, or
        the receiver of an attribute only a tensor has — unless the
        function tests its type (``isinstance``): a parameter that may be
        a number is not proven a tensor on every branch."""
        params = {a.arg: a for a in _params(fn)}
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _tail(node) == "isinstance" \
                    and node.args and isinstance(node.args[0], ast.Name):
                params.pop(node.args[0].id, None)
        out: Set[str] = set()
        for name, a in params.items():
            if a.annotation is not None and any(
                    _dotted(s).rsplit(".", 1)[-1] in self.TENSOR_ANNOTATIONS
                    for s in ast.walk(a.annotation)
                    if isinstance(s, (ast.Name, ast.Attribute))):
                out.add(name)
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) and \
                    node.attr in self.TENSOR_ATTRS and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in params:
                out.add(node.value.id)
        return out

    def _mentions(self, node: ast.AST, names: Set[str]) -> bool:
        """Does ``node`` use a name of ``names`` other than through a
        static attribute (``x.shape``, ``x.dtype``, ``x.size()``) or an
        ``is None`` test?"""
        hidden: Set[int] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and sub.attr in self.STATIC_ATTRS:
                hidden.update(id(s) for s in ast.walk(sub.value))
            if isinstance(sub, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in sub.ops):
                hidden.update(id(s) for s in ast.walk(sub))
            if isinstance(sub, ast.Call) and _tail(sub) in (
                    "isinstance", "len", "callable", "hasattr", "getattr",
                    "type"):
                hidden.update(id(s) for s in ast.walk(sub))
        return any(isinstance(sub, ast.Name) and sub.id in names
                   and id(sub) not in hidden for sub in ast.walk(node))

    def _branches_on(self, test: ast.AST, names: Set[str]) -> bool:
        """Does a Python branch test a bare tensor parameter: the name
        itself, a non-static method or attribute of it (``x.any()``), or
        either as an operand of ``not``/``and``/``or``/a comparison other
        than ``is``?"""
        if isinstance(test, ast.Name):
            return test.id in names
        if isinstance(test, ast.BoolOp):
            return any(self._branches_on(v, names) for v in test.values)
        if isinstance(test, ast.UnaryOp):
            return self._branches_on(test.operand, names)
        if isinstance(test, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
                return False
            return any(self._branches_on(v, names)
                       for v in [test.left, *test.comparators])
        if isinstance(test, ast.Call):
            test = test.func
        if isinstance(test, ast.Attribute) and \
                test.attr not in self.STATIC_ATTRS:
            return self._branches_on(test.value, names)
        return False

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for fn in self._scope(ctx):
            tensors = self._tensor_params(fn)
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    callee = _call_name(node)
                    tail = _tail(node)
                    if isinstance(node.func, ast.Attribute) and \
                            tail in self.READBACKS and not node.args:
                        yield ctx.finding(
                            node, self.name,
                            f".{tail}() inside {fn.name}() reads the device "
                            f"back to the host (a sync)")
                    elif callee in self.COERCERS and node.args and \
                            self._mentions(node.args[0], tensors):
                        yield ctx.finding(
                            node, self.name,
                            f"{callee}() of a tensor inside {fn.name}() "
                            f"reads it back to the host (a sync)")
                    elif callee.rsplit(".", 1)[-1] == "tensor" and \
                            _dotted(node.func).startswith("torch") and \
                            _kwarg(node, "device") is not None:
                        yield ctx.finding(
                            node, self.name,
                            f"torch.tensor(..., device=) inside {fn.name}() "
                            f"is a blocking upload: the host waits for the "
                            f"stream (stage it with .to(device, "
                            f"non_blocking=True) or fill on the device)")
                elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    if self._branches_on(node.test, tensors):
                        kind = "while" if isinstance(node, ast.While) \
                            else "if"
                        yield ctx.finding(
                            node, self.name,
                            f"Python `{kind}` on a tensor inside {fn.name}() "
                            f"reads it back to the host (a sync); use "
                            f"torch.where")


# ---------------------------------------------------------------------------
# bare-assert


class BareAssertRule:
    """No ``assert`` in library code: it disappears under ``python -O``
    and carries no operand context.  Raise a real exception."""

    name = "bare-assert"
    doc = ("library asserts vanish under -O and hide operands; raise "
           "ValueError/AssertionError explicitly")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assert):
                yield ctx.finding(
                    node, self.name,
                    "bare assert in library code (stripped by -O); "
                    "use `if ...: raise`")


# ---------------------------------------------------------------------------
# keyerror-dispatch


class KeyErrorDispatchRule:
    """Dict dispatch on user input must fail loud: ``TABLE[name]`` where
    ``name`` is a function parameter and the function never membership-
    checks it raises a bare ``KeyError`` that names no alternatives."""

    name = "keyerror-dispatch"
    doc = ("dict dispatch on a parameter without a membership check "
           "raises an unactionable bare KeyError")

    def _guarded_names(self, fn: ast.FunctionDef) -> Set[str]:
        """Parameters that are membership-tested or .get()-dispatched
        somewhere in the function."""
        guarded: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Compare):
                ops = node.ops
                if any(isinstance(op, (ast.In, ast.NotIn)) for op in ops):
                    for sub in ast.walk(node.left):
                        if isinstance(sub, ast.Name):
                            guarded.add(sub.id)
            if isinstance(node, ast.Call):
                tail = _call_name(node).rsplit(".", 1)[-1]
                if tail == "get" and node.args:
                    for sub in ast.walk(node.args[0]):
                        if isinstance(sub, ast.Name):
                            guarded.add(sub.id)
            if isinstance(node, ast.Try):
                for handler in node.handlers:
                    htype = handler.type
                    names = {_dotted(s) for s in ast.walk(htype)} if htype else set()
                    if "KeyError" in names or htype is None:
                        # anything subscripted inside the try is guarded
                        for sub in ast.walk(node):
                            if isinstance(sub, ast.Subscript):
                                for s2 in ast.walk(sub.slice):
                                    if isinstance(s2, ast.Name):
                                        guarded.add(s2.id)
        return guarded

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        # dict-literal module/class-level tables by name
        tables: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        tables.add(tgt.id)
        if not tables:
            return
        for fn in _functions(ctx.tree):
            params = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                                      + fn.args.kwonlyargs)}
            guarded = self._guarded_names(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Subscript):
                    continue
                if not (isinstance(node.value, ast.Name)
                        and node.value.id in tables):
                    continue
                idx = node.slice
                if (isinstance(idx, ast.Name) and idx.id in params
                        and idx.id not in guarded):
                    yield ctx.finding(
                        node, self.name,
                        f"{node.value.id}[{idx.id}] dispatches on a "
                        f"parameter without a membership check — a typo "
                        f"raises bare KeyError naming no valid choices")


# ---------------------------------------------------------------------------
# kernel-accum-envelope (torch form)


class KernelAccumEnvelopeRule:
    """Kernel wrapper modules must declare their accumulator and envelope.

    A kernel wrapper module is recognised structurally: it calls
    ``build.library(...)`` (it loads a hand-written kernel and launches
    it).  Such kernels take sub-f32 operands (the bf16 routes), so two
    contracts apply:

    * the module binds a module-level accumulator-dtype constant (a name
      containing ``ACCUM_DTYPE``) and an envelope registration pointer (a
      name containing ``ENVELOPE``), so the precision contract is
      discoverable next to the kernel it governs rather than only in the
      planner (``repro_torch.core.svd:CUDA_KAPPA_ENVELOPE``);
    * in a function that launches the kernel, an output allocated in f32
      (``torch.empty``/``new_empty``/``zeros``/... with a literal
      ``dtype=torch.float32``) must name that constant instead: the
      accumulator the envelope was measured at is stated once.
    """

    name = "kernel-accum-envelope"
    doc = ("kernel wrapper modules (calling build.library) must declare "
           "*_ACCUM_DTYPE and an *ENVELOPE pointer, and allocate f32 "
           "outputs with the *_ACCUM_DTYPE constant")

    ALLOCATORS = {"empty", "zeros", "ones", "full", "empty_strided",
                  "new_empty", "new_zeros", "new_ones", "new_full",
                  "new_empty_strided"}
    F32 = {"float32", "float"}

    def _module_binds(self, ctx: FileContext, fragment: str) -> bool:
        for node in ctx.tree.body:  # module top level only
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Name) and fragment in tgt.id:
                    return True
        return False

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        launchers = [fn for fn in _functions(ctx.tree)
                     if _launches_kernel(fn)]
        if not launchers:
            return
        for fn in launchers:
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and _tail(node) in self.ALLOCATORS):
                    continue
                dt = _kwarg(node, "dtype")
                if isinstance(dt, ast.Attribute) and dt.attr in self.F32 \
                        and _dotted(dt.value) == "torch":
                    yield ctx.finding(
                        node, self.name,
                        f"{_tail(node)}(..., dtype=torch.{dt.attr}) in "
                        f"kernel launcher {fn.name}(): allocate the "
                        f"kernel's f32 output with the module's "
                        f"*_ACCUM_DTYPE constant")
        if not self._module_binds(ctx, "ACCUM_DTYPE"):
            yield ctx.finding(
                launchers[0], self.name,
                "kernel module declares no *_ACCUM_DTYPE constant: the "
                "accumulator precision the envelope was measured under "
                "must be stated next to the kernel")
        if not self._module_binds(ctx, "ENVELOPE"):
            yield ctx.finding(
                launchers[0], self.name,
                "kernel module declares no *ENVELOPE registration "
                "pointer: the planner/health judge gate sub-f32 use on "
                "a recorded kappa envelope — name where it lives")


register_rule(CollectiveAxisRule())
register_rule(AccumDtypeRule())
register_rule(PlanKeyHygieneRule())
register_rule(HostSyncRule())
register_rule(BareAssertRule())
register_rule(KeyErrorDispatchRule())
register_rule(KernelAccumEnvelopeRule())
