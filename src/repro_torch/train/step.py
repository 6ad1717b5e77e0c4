"""Train step: loss -> grads -> clip -> ZoloMuon update.

Port of ``repro/train/step.py``, run eagerly.  The cross-entropy is
computed in sequence chunks against the vocabulary projection so full
(b, s, vocab) logits are never built.  Parameters are f32 masters, cast
to ``cfg.dtype`` for the forward; gradients come from autograd; the
global-norm clip stays on the device (no host read); every 2-D weight's
update is orthogonalized by Zolo-PD (:mod:`repro_torch.optim.muon`).

Sharded, the state is placed by ``tree_shardings(arch_rules(...),
state_axes_for_params(...))`` (DTensors on a ``DeviceMesh``) and the step
runs under :func:`repro_torch.dist.activation_hints`: the bf16 casts and
the gradients are pinned to the parameters' placements, as the
reference's hints pin them, so the data-parallel gradient reduction is a
reduce-scatter.  The model builds plain-tensor constants (positions,
RoPE tables, masks, zero accumulators); a step on DTensors runs under
``implicit_replication()``, which treats them as replicated — they are
the same on every rank.  The metrics come back as plain tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as _tree
from repro_torch.dist.sharding import hint_tree, settle
from repro_torch.models import model as M
from repro_torch.optim.muon import MuonConfig, ZoloMuon, muon_labels
from repro_torch.optim.schedule import warmup_cosine

F32 = torch.float32


@dataclasses.dataclass
class TrainState:
    """(step, params, opt): its leaves are named "0", "1/...", "2/..."
    as the reference's registered pytree names them."""

    step: Any
    params: Any
    opt: Any


def train_state_axes(cfg):
    """Logical axes for the full train state (params + optimizer mirrors).

    ``nu`` mirrors params structurally, but Muon-labelled leaves hold
    scalar placeholders — :func:`state_axes_for_params` fixes their axes
    to "REPLICATED"."""
    pax = M.params_axes(cfg)
    rep = "REPLICATED"
    return TrainState(step=rep, params=pax,
                      opt={"mu": pax, "nu": pax, "count": rep})


def state_axes_for_params(cfg, params):
    """:func:`train_state_axes` with ``nu``'s axes matching the leaves'
    ranks (scalar placeholders on Muon leaves get "REPLICATED")."""
    axes = train_state_axes(cfg)
    labels = muon_labels(params)
    axes.opt["nu"] = _tree.map(
        lambda is_muon, ax: "REPLICATED" if is_muon else ax,
        labels, axes.opt["mu"])
    return axes


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _replication(tree):
    """``implicit_replication()`` when ``tree`` holds DTensors (plain
    constants then mix with them as replicated), else a null context."""
    if any(_is_dtensor(x) for x in _tree.leaves(tree)):
        from torch.distributed.tensor.experimental import \
            implicit_replication

        # implicit_replication: the model's plain-tensor constants
        # (positions, RoPE tables, masks, zero accumulators) are the same
        # on every rank, so reading them as replicated is exact; the
        # collectives of the step come from the parameters' placements
        return implicit_replication()
    return contextlib.nullcontext()


def _fsdp_gather(p):
    """A DTensor parameter gathered over the "data" mesh dimension for
    its use (FSDP), its other placements kept; in the backward its
    gradient's partial sum over "data" reduce-scatters back onto the
    shard."""
    if not _is_dtensor(p):
        return p
    names = p.device_mesh.mesh_dim_names
    if "data" not in names:
        return p
    from torch.distributed.tensor import Replicate

    i = names.index("data")
    if not p.placements[i].is_shard():
        return p
    placements = list(p.placements)
    placements[i] = Replicate()
    return p.redistribute(p.device_mesh, placements)


def _plain(x):
    """A metric as a plain tensor (a replicated DTensor's value)."""
    return x.full_tensor() if _is_dtensor(x) else x


def chunked_ce_loss(x, w, labels, *, chunk: int = 512,
                    softcap: float = 0.0, z_loss: float = 1e-4):
    """Cross entropy over seq chunks.  x: (b, s, d); w: (d, v);
    labels: (b, s) integer (-1 = masked)."""
    s = x.shape[1]
    # sliced chunks, the last one short where chunk does not divide s
    # (no padding: a DTensor's pad of a batch-sharded tensor fails)
    chunks = [(x[:, i:i + chunk], labels[:, i:i + chunk])
              for i in range(0, max(s, 1), chunk)]

    tot = torch.zeros((), dtype=F32, device=x.device)
    cnt = torch.zeros((), dtype=F32, device=x.device)
    for xs, ls in chunks:
        logits = (xs @ w).to(F32)
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        logz = torch.logsumexp(logits, dim=-1)
        gold = settle(torch.take_along_dim(
            logits, torch.clamp(ls, min=0).long()[..., None], dim=-1))[..., 0]
        mask = (ls >= 0).to(F32)
        nll = (logz - gold + z_loss * logz * logz) * mask
        tot = tot + nll.sum()
        cnt = cnt + mask.sum()
    return tot / torch.clamp(cnt, min=1.0)


def make_train_step(cfg, muon_cfg: MuonConfig, *,
                    total_steps: int = 10_000, warmup: int = 100,
                    grad_clip: float = 1.0, aux_weight: float = 0.01,
                    schedule: Optional[Callable] = None):
    """Returns (init_state(gen), train_step(state, batch) -> (state,
    metrics)).  ``init_state`` draws the parameters from the
    ``torch.Generator`` on their device; the metrics are device
    scalars."""
    sched = schedule or functools.partial(
        warmup_cosine, warmup=warmup, total=total_steps)
    compute_dtype = getattr(torch, cfg.dtype)

    def init_state(gen: torch.Generator):
        params = M.init_params(cfg, gen)
        params = _tree.map(
            lambda p: p.to(F32) if p.dtype == torch.bfloat16 else p,
            params)  # f32 masters
        opt = ZoloMuon(muon_cfg, muon_labels(params))
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=gen.device),
            params=params, opt=opt.init(params))

    def loss_fn(params, batch):
        cast = _tree.map(
            lambda p: p.to(compute_dtype)
            if p.dtype == F32 and p.ndim >= 2 else p, params)
        # pin the bf16 copies to the master placements: FSDP gathers then
        # move half the bytes (bf16, not f32)
        cast = hint_tree(cast, M.params_axes(cfg))
        cast = _tree.map(_fsdp_gather, cast)
        x, aux = M.hidden_states(cast, batch, cfg)
        w = cast["embed"].mT if cfg.tie_embeddings else cast["lm_head"]
        p = cfg.num_prefix_embeds
        toks = batch["tokens"]
        x_pred = x[:, p:p + toks.shape[1] - 1]
        labels = toks[:, 1:]
        loss = chunked_ce_loss(x_pred, w, labels,
                               softcap=cfg.logits_softcap)
        return loss + aux_weight * aux, loss, aux

    def train_step(state, batch):
        with _replication(state.params):
            return _train_step(state, batch)

    def _train_step(state, batch):
        p_leaves, tdef = _tree.flatten(state.params)
        leaves = [p.detach().requires_grad_() for p in p_leaves]
        with torch.enable_grad():
            total, loss, aux = loss_fn(_tree.unflatten(tdef, leaves), batch)
        g_leaves = torch.autograd.grad(total, leaves)
        del leaves, total
        with torch.no_grad():
            # under activation hints: pin grads to the param placements, so
            # the data-parallel reduction is a reduce-scatter (ZeRO-2
            # shape) instead of an all-reduce and a local slice
            g_leaves = _tree.leaves(hint_tree(
                _tree.unflatten(tdef, list(g_leaves)), M.params_axes(cfg)))
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                                   for g in g_leaves))
            clip = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                               max=1.0)
            grads = _tree.unflatten(tdef, [g * clip.to(g.dtype)
                                           for g in g_leaves])
            del g_leaves
            opt = ZoloMuon(muon_cfg, muon_labels(state.params))
            lr_scale = sched(state.step)
            params, opt_state = opt.update(grads, state.opt, state.params,
                                           lr_scale=lr_scale)
        new_state = TrainState(step=state.step + 1, params=params,
                               opt=opt_state)
        metrics = {"loss": _plain(loss.detach()),
                   "aux_loss": _plain(aux.detach()),
                   "grad_norm": _plain(gnorm), "lr_scale": _plain(lr_scale)}
        return new_state, metrics

    return init_state, train_step
