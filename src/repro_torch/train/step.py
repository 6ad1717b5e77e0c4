"""Train step: loss -> grads -> clip -> ZoloMuon update.

Port of ``repro/train/step.py``, run eagerly.  The cross-entropy is
computed in sequence chunks against the vocabulary projection so full
(b, s, vocab) logits are never built.  Parameters are f32 masters, cast
to ``cfg.dtype`` for the forward; gradients come from autograd; the
global-norm clip stays on the device (no host read); every 2-D weight's
update is orthogonalized by Zolo-PD (:mod:`repro_torch.optim.muon`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch import tree as _tree
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


def chunked_ce_loss(x, w, labels, *, chunk: int = 512,
                    softcap: float = 0.0, z_loss: float = 1e-4):
    """Cross entropy over seq chunks.  x: (b, s, d); w: (d, v);
    labels: (b, s) integer (-1 = masked)."""
    b, s, d = x.shape
    nc = max(1, -(-s // chunk))
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    xc = x.reshape(b, nc, -1, d)
    lc = labels.reshape(b, nc, -1)

    tot = torch.zeros((), dtype=F32, device=x.device)
    cnt = torch.zeros((), dtype=F32, device=x.device)
    for i in range(nc):
        xs = xc[:, i]
        ls = lc[:, i]
        logits = (xs @ w).to(F32)
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(
            logits, torch.clamp(ls, min=0).long()[..., None], dim=-1)[..., 0]
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
        p_leaves, tdef = _tree.flatten(state.params)
        leaves = [p.detach().requires_grad_() for p in p_leaves]
        with torch.enable_grad():
            total, loss, aux = loss_fn(_tree.unflatten(tdef, leaves), batch)
        g_leaves = torch.autograd.grad(total, leaves)
        del leaves, total
        with torch.no_grad():
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
        metrics = {"loss": loss.detach(), "aux_loss": aux.detach(),
                   "grad_norm": gnorm, "lr_scale": lr_scale}
        return new_state, metrics

    return init_state, train_step
