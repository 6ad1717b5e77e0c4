"""Dry-run: run every (arch x shape x mesh) cell once on the fake
process group, on meta tensors.

Port of ``repro/launch/dryrun.py``, whose cells lower and compile each
step for 256 or 512 host devices.  The torch form, in one process:

  1. initializes the **fake process group** (``backend="fake"``, 512
     ranks; this process is rank 0) and builds the production mesh on it
     (16x16 or 2x16x16) — collectives are recorded, none moves data;
  2. builds the state on the **meta device** (``MetaGenerator``: the
     counterpart of ``jax.eval_shape``; no parameter is ever drawn) and
     places it with ``tree_shardings(arch_rules(...))`` as DTensors;
  3. runs the train, prefill or decode step once, as the reference's
     ``lower_cell`` picks by ``shape.kind`` (``registry.cell_supported``
     skips cells exactly as there);
  4. records every collective the step dispatches, per kind, through a
     ``TorchDispatchMode`` over the ``c10d`` and ``_c10d_functional`` ops
     (as :mod:`repro_torch.analysis.plan_audit` counts all-reduces), and
     the flops of the local ops it sees, per rank.

Deliberate divergences from the reference: no ``memory_analysis`` temp
size (per-rank argument bytes come from the local shard shapes of the
placed arguments); no scan extrapolation (the port's stages are a Python
loop, so every layer runs and is counted); collective counts come from
the dispatched ops, not from HLO text.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict, List, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as CFG
from repro_torch import tree as _tree
from repro_torch.dist.sharding import (activation_hints, arch_rules,
                                       distribute_tree, tree_shardings)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES
from repro_torch.models.layers import MetaGenerator
from repro_torch.optim.muon import MuonConfig
from repro_torch.train.step import make_train_step, state_axes_for_params

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# the c10d and functional-collective spellings of each kind
_OP_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
        "reduce-scatter", "reduce_scatter_tensor_coalesced_":
        "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

FAKE_WORLD = 512


class CollectiveRecord(NamedTuple):
    """One dispatched collective: its kind, its operand bytes on this
    rank, its group's size and the mesh axis it ran over."""

    kind: str
    nbytes: int
    group_size: int
    axis: str


def _wire_factor(kind: str, gs: int) -> float:
    """Ring-algorithm wire bytes per participating device, as a multiple
    of the (per-device) operand bytes."""
    if gs <= 1:
        return 0.0
    if kind == "all-gather":
        return gs - 1.0
    if kind == "all-reduce":
        return 2.0 * (gs - 1.0) / gs
    if kind in ("reduce-scatter", "all-to-all"):
        return (gs - 1.0) / gs
    return 1.0  # collective-permute


def collective_bytes(records) -> dict:
    """Per-kind operand bytes and estimated ring wire-bytes of the
    collectives a run dispatched (the reference's schema)."""
    out = {k: {"count": 0, "bytes": 0, "wire_bytes": 0.0}
           for k in _COLLECTIVES}
    for rec in records:
        out[rec.kind]["count"] += 1
        out[rec.kind]["bytes"] += rec.nbytes
        out[rec.kind]["wire_bytes"] += rec.nbytes * _wire_factor(
            rec.kind, rec.group_size)
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    out["total_wire_bytes"] = sum(v["wire_bytes"] for v in out.values()
                                  if isinstance(v, dict))
    return out


def collectives_by_axis(records) -> Dict[str, Dict[str, int]]:
    """{mesh axis: {kind: count}} of the records."""
    out: Dict[str, Dict[str, int]] = {}
    for rec in records:
        out.setdefault(rec.axis, collections.Counter())[rec.kind] += 1
    return {a: dict(c) for a, c in out.items()}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for item in x:
            yield from _tensors(item)


class CollectiveRecorder(TorchDispatchMode):
    """Records the collectives and counts the flops a run dispatches on
    this rank.  A DTensor op is let through first (``NotImplemented``),
    so the mode sees what it desugars to: the local ops and the
    collectives of its redistributes."""

    def __init__(self, axes: Dict[str, str]):
        super().__init__()
        self.axes = axes  # process-group name -> mesh axis name
        self.records: List[CollectiveRecord] = []
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = _OP_KIND.get(packet.__name__)
            if kind is not None:
                self._record(kind, func.namespace == "c10d", args)
        elif packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        return out

    def _record(self, kind, c10d: bool, args):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        if c10d:  # the process group is the op's one ScriptObject
            group = next(dist.ProcessGroup.unbox(a) for a in args
                         if isinstance(a, torch.ScriptObject))
        else:  # a functional collective names its group last
            group = _resolve_process_group(
                [a for a in args if isinstance(a, str)][-1])
        # the operand: a c10d gather, scatter or all-to-all takes its
        # outputs first and its inputs second; every other op (and every
        # functional one) takes its input first
        operand = args[1] if c10d and kind in (
            "all-gather", "reduce-scatter", "all-to-all") else args[0]
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(operand))
        axis = self.axes.get(group.group_name, "other")
        self.records.append(CollectiveRecord(kind, nbytes, group.size(),
                                             axis))


def mesh_group_axes(mesh) -> Dict[str, str]:
    """{process-group name: mesh axis name} of every mesh dimension."""
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}


def init_fake_process_group(world_size: int = FAKE_WORLD) -> None:
    """The fake process group at ``world_size`` ranks in this process
    (rank 0), unless a default group already exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=world_size,
                                store=FakeStore())


def _meta(shape_dtype):
    shape, dtype = shape_dtype
    return torch.empty(shape, dtype=dtype, device="meta")


def _local_bytes(tree) -> int:
    """Bytes this rank holds of the tensors of ``tree`` (a DTensor's
    local shard)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for x in _tree.leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def _input_axes(batch):
    axes = {"tokens": ("batch", None)}
    if "embeds" in batch:
        axes["embeds"] = ("batch", None, None)
    return axes


def build_cell(cfg, shape, mesh, *, optimized: bool = False):
    """(step_fn, args) of one cell on ``mesh``, every argument a meta
    DTensor placed by the arch's rules; ``step_fn(*args)`` runs it."""
    rules = arch_rules(cfg, mesh, shape)

    def place(tree, axes):
        return distribute_tree(tree, tree_shardings(mesh, rules, axes),
                               src_data_rank=None)

    batch = _tree.map(_meta, CFG.input_specs(cfg, shape, abstract=True),
                      is_leaf=lambda x: isinstance(x, tuple)
                      and len(x) == 2 and isinstance(x[1], torch.dtype))
    if shape.kind == "train":
        muon = MuonConfig(polar_dtype="bfloat16" if optimized
                          else "float32")
        init_fn, train_step = make_train_step(cfg, muon)
        state = init_fn(MetaGenerator())
        state = place(state, state_axes_for_params(cfg, state.params))
        return train_step, (state, place(batch, _input_axes(batch)))
    params = place(M.init_params(cfg, MetaGenerator()), M.params_axes(cfg))
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return M.prefill(params, batch, cfg, max_len=shape.seq_len)

        return prefill_step, (params, place(batch, _input_axes(batch)))
    caches = place(M.init_caches(cfg, shape.global_batch, shape.seq_len,
                                 device="meta"), M.caches_axes(cfg))
    tokens = place({"t": _meta(((shape.global_batch, 1), torch.int32))},
                   {"t": ("batch", None)})["t"]

    def serve_step(params, tokens, caches):
        return M.decode_step(params, tokens, caches, cfg)

    return serve_step, (params, tokens, caches)


def run_step(step_fn, args, mesh, rules=None):
    """Run ``step_fn(*args)`` once under the recorder (and the rules'
    activation hints when given).  Returns (records, flops, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication

    hints = activation_hints(rules) if rules is not None else \
        contextlib.nullcontext()
    rec = CollectiveRecorder(mesh_group_axes(mesh))
    t0 = time.perf_counter()
    # implicit_replication: as in the train step, the step's plain-tensor
    # constants are the same on every rank; the recorder counts the
    # collectives the placements make
    with hints, implicit_replication(), rec:
        step_fn(*args)
    return rec.records, rec.flops, time.perf_counter() - t0


def _cell_name(arch, shape_name, mesh_label, optimized):
    return (f"{arch}__{shape_name}__{mesh_label.replace('x', '_')}"
            f"{'__opt' if optimized else ''}.json")


def run_cell(arch: str, shape_name, multi_pod: bool, out_dir: str,
             optimized: bool = False, *, mesh=None, cfg=None) -> dict:
    """Run one cell and write its record as JSON under ``out_dir``.

    ``shape_name`` names one of ``SHAPES`` or is a ``ShapeConfig``;
    ``mesh``/``cfg`` replace the production mesh and the arch's config
    (a debug mesh, a smoke config)."""
    t0 = time.time()
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    rec: Dict[str, Any] = {"arch": arch, "shape": shape.name,
                           "optimized": optimized,
                           "mesh": "2x16x16" if multi_pod else "16x16"}
    try:
        cfg = cfg if cfg is not None else CFG.get_config(arch)
        skip = CFG.registry.cell_supported(cfg, shape)
        if skip:
            rec.update(status="skip", skip=skip)
        else:
            if mesh is None:
                init_fake_process_group()
                mesh = make_production_mesh(multi_pod=multi_pod,
                                            device_type="cpu")
            rec["mesh"] = "x".join(str(s) for s in mesh.shape)
            rec["devices"] = mesh.size()
            step_fn, args = build_cell(cfg, shape, mesh,
                                       optimized=optimized)
            rules = arch_rules(cfg, mesh, shape) if optimized else None
            records, flops, seconds = run_step(step_fn, args, mesh, rules)
            rec["status"] = "ok"
            rec["run_s"] = round(seconds, 1)
            rec["memory"] = {"argument_size_in_bytes": _local_bytes(args)}
            rec["cost"] = {"flops": float(flops)}
            rec["collectives"] = collective_bytes(records)
            rec["collectives_by_axis"] = collectives_by_axis(records)
    except Exception as e:
        rec["status"] = "fail"
        rec["error"] = "".join(
            traceback.format_exception_only(type(e), e))[-2000:]
        rec["trace"] = traceback.format_exc()[-4000:]
    finally:
        rec["total_s"] = round(time.time() - t0, 1)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, _cell_name(arch, shape.name, rec["mesh"],
                                               optimized)), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="run under activation-sharding hints, with the "
                         "Muon momentum moved in bfloat16")
    args = ap.parse_args(argv)

    archs = CFG.list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                fn = os.path.join(args.out, _cell_name(
                    arch, shape, "2x16x16" if mp else "16x16",
                    args.optimized))
                if args.skip_existing and os.path.exists(fn):
                    with open(fn) as f:
                        if json.load(f).get("status") in ("ok", "skip"):
                            print(f"[dryrun] cached {fn}")
                            continue
                rec = run_cell(arch, shape, mp, args.out,
                               optimized=args.optimized)
                summary = {k: rec.get(k) for k in
                           ("arch", "shape", "mesh", "status", "run_s")}
                if rec.get("status") == "fail":
                    summary["error"] = rec.get("error", "")[:300]
                print(f"[dryrun] {summary}", flush=True)
                records.append(rec)
    return records


if __name__ == "__main__":
    main()
