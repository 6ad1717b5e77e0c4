"""Logical-axis sharding on ``DeviceMesh`` / DTensor placements.

Port of ``repro/dist/sharding.py``.  Model, optimizer and data code
annotate tensors with *logical* axis names ("batch", "embed", "experts",
"opt_rows", ...); how those names bind to the axes of a
:class:`~torch.distributed.device_mesh.DeviceMesh` ("pod", "data",
"model") is decided once, at launch, by a :class:`LogicalRules` table
(built by :func:`arch_rules`), so every call site stays mesh-agnostic.

Two consumption modes, as in the reference:

* **Placement** — :func:`logical_sharding` / :func:`tree_shardings` turn
  logical axes into :class:`MeshSharding` records (a mesh and its
  per-mesh-dimension ``Shard``/``Replicate`` list, in place of a
  ``NamedSharding``), which :func:`distribute_tree` applies.
* **Constraint** — :func:`hint` / :func:`hint_tree`.  They are the
  identity (the very object) unless an :func:`activation_hints` context
  is active; inside one they ``redistribute`` a DTensor, or
  ``distribute_tensor`` a plain one, to the rules' placements.  Eager
  torch has no compiler to hand a constraint to, so a hint moves the data
  where the reference's ``with_sharding_constraint`` asks GSPMD to.

Placements follow JAX's meaning of a ``PartitionSpec``: a tuple rule such
as ("pod", "data") shards one tensor dimension over both mesh dimensions,
pod-major; a mesh axis the mesh lacks is dropped; and a spec that names
one mesh axis on two dimensions has no placements (``ValueError``, as JAX
refuses such a ``NamedSharding``).  A mesh axis of size 1 is placed as
``Replicate()``: the same layout, and no collective over a one-rank
group.

The Zolo-PD process groups of Algorithm 3 have their own mesh
(:func:`repro_torch.dist.zolo_group_mesh`); rules tables never mix the
two.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, List, Mapping, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch import tree as _tree

AxisName = Optional[str]
Axes = Union[None, str, Tuple[AxisName, ...]]

REPLICATED = "REPLICATED"

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def mesh_axes(mesh) -> dict:
    """{mesh axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class MeshSharding(NamedTuple):
    """Where one tensor lies: the mesh, its per-mesh-dimension
    placements, and the per-tensor-dimension spec they came from (the
    tuple the reference's ``PartitionSpec`` holds)."""

    mesh: Any
    placements: Tuple[Any, ...]
    spec: Spec


class LogicalRules:
    """Immutable logical-name -> mesh-axis rule table.

    ``rules`` maps each logical axis name to a mesh axis name, a tuple of
    mesh axis names (the dimension is sharded over their product, e.g.
    ``("pod", "data")``), or None (replicated).  Unknown logical names
    resolve to None, so partial tables are safe.  The table may carry
    the mesh it was built against (``mesh=``); that is what lets
    :func:`hint` place tensors."""

    __slots__ = ("_table", "mesh")

    def __init__(self, rules: Mapping[str, Any], mesh=None):
        table = {}
        for name, ax in dict(rules).items():
            if ax is not None and not isinstance(ax, (str, tuple)):
                raise TypeError(f"rule for {name!r} must be a mesh axis "
                                f"name, tuple, or None; got {ax!r}")
            table[name] = tuple(ax) if isinstance(ax, tuple) else ax
        self._table = table
        self.mesh = mesh

    def axis(self, name: Optional[str]):
        """Mesh axis (or axes tuple, or None) for one logical name."""
        if name is None:
            return None
        return self._table.get(name)

    def spec(self, axes: Axes, mesh=None) -> Spec:
        """Resolve a per-dimension logical-axes annotation to the
        per-dimension mesh-axis tuple (the reference's ``PartitionSpec``
        entries), dropping mesh axes the target mesh doesn't have."""
        mesh = mesh if mesh is not None else self.mesh
        present = set(mesh.mesh_dim_names) if mesh is not None else None

        def resolve(name):
            ax = self.axis(name)
            if ax is None:
                return None
            if isinstance(ax, tuple):
                if present is not None:
                    ax = tuple(a for a in ax if a in present)
                if not ax:
                    return None
                return ax[0] if len(ax) == 1 else ax
            if present is not None and ax not in present:
                return None
            return ax

        if axes is None or axes == REPLICATED:
            return ()
        if isinstance(axes, str):  # single logical name for a 1-D tensor
            return (resolve(axes),)
        return tuple(resolve(name) for name in axes)

    def placements(self, axes: Axes, mesh=None) -> List[Any]:
        """The per-mesh-dimension ``Shard(d)`` / ``Replicate()`` list of
        ``axes`` on ``mesh`` (the bound mesh by default)."""
        from torch.distributed.tensor import Replicate, Shard

        mesh = mesh if mesh is not None else self.mesh
        if mesh is None:
            raise ValueError("LogicalRules has no mesh bound; pass mesh=")
        names = list(mesh.mesh_dim_names)
        sizes = mesh_axes(mesh)
        spec = self.spec(axes, mesh)
        out: List[Any] = [Replicate() for _ in names]
        used = {}
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            group = entry if isinstance(entry, tuple) else (entry,)
            order = [names.index(a) for a in group]
            if order != sorted(order):
                raise ValueError(
                    f"spec {spec} shards dimension {dim} over {group}, not "
                    f"in the mesh's axis order {tuple(names)}")
            for a in group:
                if a in used:
                    raise ValueError(
                        f"spec {spec} names mesh axis {a!r} on dimensions "
                        f"{used[a]} and {dim}; a mesh axis shards at most "
                        f"one dimension")
                used[a] = dim
                if sizes[a] > 1:
                    out[names.index(a)] = Shard(dim)
        return out

    def sharding(self, axes: Axes, mesh=None) -> MeshSharding:
        mesh = mesh if mesh is not None else self.mesh
        if mesh is None:
            raise ValueError("LogicalRules has no mesh bound; pass mesh=")
        return MeshSharding(mesh, tuple(self.placements(axes, mesh)),
                            self.spec(axes, mesh))

    def items(self):
        return self._table.items()

    def __repr__(self):
        shape = None if self.mesh is None else mesh_axes(self.mesh)
        return f"LogicalRules({self._table!r}, mesh={shape})"


def logical_sharding(mesh, rules: LogicalRules, axes: Axes) -> MeshSharding:
    """The :class:`MeshSharding` of one tensor annotated with ``axes``."""
    return rules.sharding(axes, mesh=mesh)


def _is_axes_leaf(x) -> bool:
    """Leaves of an *axes tree*: None, "REPLICATED"/a logical name, or a
    per-dimension tuple of names.  Structural tuples (tuples of dicts /
    tuples) are containers, not leaves."""
    return (x is None or isinstance(x, str)
            or (isinstance(x, tuple)
                and all(e is None or isinstance(e, str) for e in x)))


def tree_shardings(mesh, rules: LogicalRules, axes_tree):
    """Map an axes tree (mirroring a param/state tree, with tuple-of-names
    leaves) to a matching tree of :class:`MeshSharding` records.

    ``None`` axes leaves stay ``None``, so the result zips against trees
    that hold ``None`` at the same spots (nonparam-LN norms)."""

    def one(ax):
        if ax is None:
            return None
        return logical_sharding(mesh, rules, ax)

    return _tree.map(one, axes_tree, is_leaf=_is_axes_leaf)


def _place(x, mesh, placements, src_data_rank: Optional[int] = 0):
    """``x`` as a DTensor on ``mesh`` with ``placements``: a DTensor is
    redistributed (no-op when already there), a plain tensor — the same
    full tensor on every rank — is distributed (from ``src_data_rank``;
    None: each rank keeps its own shard, no collective)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        if x.device_mesh == mesh and tuple(x.placements) == tuple(placements):
            return x
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements,
                             src_data_rank=src_data_rank)


def distribute_tree(tree, shardings, *, src_data_rank: Optional[int] = 0):
    """Place every tensor of ``tree`` by the matching record of a
    :func:`tree_shardings` tree (``None`` leaves and records skip).
    ``src_data_rank`` as ``distribute_tensor``'s: the rank whose full
    tensors are scattered, or None to cut each rank's shard from its own
    copy without a collective."""

    def one(x, sh):
        if x is None or sh is None:
            return x
        return _place(x, sh.mesh, sh.placements, src_data_rank)

    return _tree.map(one, tree, shardings)


# --- activation hints (constraint mode) ------------------------------------

# ContextVar rather than a module-global stack: concurrent callers (two
# threads) each see only their own rules.
_ACTIVE_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_dist_active_rules", default=())


def current_rules() -> Optional[LogicalRules]:
    """The innermost active :func:`activation_hints` rules, or None."""
    stack = _ACTIVE_RULES.get()
    return stack[-1] if stack else None


@contextlib.contextmanager
def activation_hints(rules: LogicalRules):
    """Enable :func:`hint` / :func:`hint_tree` under this block.

    The rules must carry a mesh (``arch_rules`` binds one).  Outside it
    hints are exact no-ops, so hint-annotated library code costs nothing
    in single-device runs."""
    if rules.mesh is None:
        raise ValueError("activation_hints requires mesh-bound rules "
                         "(build them with arch_rules(cfg, mesh, shape))")
    token = _ACTIVE_RULES.set(_ACTIVE_RULES.get() + (rules,))
    try:
        yield rules
    finally:
        _ACTIVE_RULES.reset(token)


def hint(x, *logical_axes: AxisName):
    """Place ``x`` by per-dimension logical axis names.

    Identity (returns ``x`` itself) when no :func:`activation_hints`
    context is active; a redistribute (or distribute) to the active
    rules' placements otherwise."""
    rules = current_rules()
    if rules is None:
        return x
    return _place(x, rules.mesh, rules.placements(tuple(logical_axes)))


def hint_tree(tree, axes_tree):
    """Tree version of :func:`hint`.

    ``axes_tree`` mirrors ``tree`` with axes leaves (tuples of logical
    names, "REPLICATED", or None) at tensor positions.  Identity outside
    an :func:`activation_hints` context."""
    rules = current_rules()
    if rules is None:
        return tree

    def one(x, ax):
        if ax is None:
            return x
        return _place(x, rules.mesh, rules.placements(ax))

    return _tree.map(one, tree, axes_tree)


def settle(x):
    """``x`` with a DTensor's pending partial sums reduced (replicated
    over those mesh dimensions); a plain tensor as it is.

    The port's layers settle what a tensor-parallel (row-parallel)
    product leaves partial before the residual add, so the residual
    stream stays replicated over "model" (Megatron's all-reduce).  Left
    partial, DTensor reduce-scatters it along the hidden dimension at the
    next norm and then gathers the next layer's weights over "model"."""
    return _Settle.apply(x) if _partial(x) else x


def _partial(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor) and any(p.is_partial()
                                          for p in x.placements)


def _reduced(x):
    from torch.distributed.tensor import Replicate

    if not _partial(x):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


class _Settle(torch.autograd.Function):
    """Reduce a DTensor's partial sums, forward and backward: the
    gradient arrives partial over "model" from the next layer's
    column-parallel products and is reduced here (Megatron's pair of
    all-reduces), so the products before it need not gather their
    weights.  A reduced gradient is a valid gradient of any partial
    placement, the masked partial of a vocabulary-parallel lookup
    included, which ``redistribute``'s own backward refuses."""

    @staticmethod
    def forward(ctx, x):
        return _reduced(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous on the way back."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_block(t, mesh, placements, grad_placements=None):
    """This rank's block of the DTensor ``t`` redistributed to
    ``placements`` on ``mesh``, for a computation that is independent
    over the sharded dimensions and runs on plain tensors (the gradient
    comes back contiguous: DTensor views the gradient of a block it
    wraps).  ``grad_placements`` (default ``placements``) is the
    gradient's: ``Partial()`` where ``t`` is replicated over a mesh
    dimension that the computation's other operands are split over, so
    each rank's gradient is its share.  Pair with
    :func:`from_local_block`."""
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(mesh, placements)
    return _ContiguousGrad.apply(t.to_local(grad_placements=grad_placements))


def from_local_block(block, mesh, placements, shape):
    """The DTensor of global ``shape`` whose local block on this rank is
    ``block`` (made contiguous) on ``mesh`` with ``placements``."""
    from torch.distributed.tensor import DTensor

    strides, acc = [], 1
    for n in reversed(tuple(shape)):
        strides.append(acc)
        acc *= n
    return DTensor.from_local(block.contiguous(), mesh, placements,
                              run_check=False, shape=tuple(shape),
                              stride=tuple(reversed(strides)))


# --- rules construction -----------------------------------------------------


def _batch_axes(mesh, global_batch: Optional[int]):
    """Mesh axes the batch dimension shards over: ('pod','data') when both
    exist, else 'data' — degraded to fewer axes (or None) when the batch
    doesn't divide."""
    sizes = mesh_axes(mesh)
    cand = tuple(a for a in ("pod", "data") if a in sizes)
    while cand:
        size = math.prod(sizes[a] for a in cand)
        if global_batch is None or global_batch % size == 0:
            return cand if len(cand) > 1 else cand[0]
        cand = cand[1:]
    return None


def arch_rules(cfg, mesh, shape=None) -> LogicalRules:
    """Logical -> mesh rules for one (architecture, mesh, shape) cell.

    The reference's single table shared by params, activations, caches,
    data and the optimizer:

    * "batch" / "cache_batch": DP over ("pod","data") when divisible.
    * tensor-parallel dims ("vocab", "qkv", "mlp", "state", "ssd_in",
      "cache_heads") and the expert axis: over "model".
    * "embed": FSDP over "data" when the model dim divides it — the
      train step re-pins casts and grads to this, which turns the
      gradient reduction into a reduce-scatter.
    * optimizer reshard ("opt_stack", "opt_rows"): stack over "model",
      long dim over "data" — the Zolo-PD Gram then contracts over
      sharded rows with one all-reduce.
    """
    sizes = mesh_axes(mesh)
    model = "model" if "model" in sizes else None
    data = "data" if "data" in sizes else None
    global_batch = getattr(shape, "global_batch", None)
    batch = _batch_axes(mesh, global_batch)

    d_model = getattr(cfg, "d_model", 0)
    embed = data if (data and d_model
                     and d_model % sizes["data"] == 0) else None

    table = {
        # data / activations
        "batch": batch,
        "seq": None,
        "cache_batch": batch,
        "cache_heads": model,
        # parameters
        "vocab": model,
        "embed": embed,
        "layers": None,
        "qkv": model,
        "mlp": model,
        "state": model,
        "ssd_in": model,
        "experts": model if getattr(cfg, "num_experts", 0) else None,
        "expert_mlp": None,
        # optimizer (ZoloMuon factorization reshard)
        "opt_stack": model,
        "opt_rows": data,
    }
    return LogicalRules(table, mesh=mesh)
