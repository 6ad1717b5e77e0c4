"""Public model API: init / forward over the full stack.

Port of ``repro/models/model.py`` (the training half).  Params layout, as
in the reference (``model.py:26-45``)::

    {"embed":      (vocab_padded, d),
     "stages":     stage tree stacked over num_stages (leading axis),
     "rem":        tuple of unstacked remainder layers (may be empty),
     "final_norm": scale or None,
     "lm_head":    (d, vocab_padded)}         (absent if tie_embeddings)

a nested dict of tensors whose key paths are the reference's tree paths
(:mod:`repro_torch.tree`), so ZoloMuon batches over the stacked leading
axis and checkpoints carry across.  Stages run in a Python loop; with
``cfg.remat`` each stage runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` with ``nothing_saveable``): only the stage
inputs are kept and the stage is recomputed in the backward pass.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import tree as _tree
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

F32 = torch.float32


def check_supported(cfg) -> None:
    """Raise :class:`NotImplementedError` unless every block of ``cfg``
    is an attention block with a dense MLP."""
    for kind in cfg.block_pattern:
        T.check_supported(cfg, kind)


def init_params(cfg, gen: torch.Generator):
    """Random parameters in ``cfg.dtype`` (norm scales f32) on ``gen``'s
    device."""
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_model
    params = {
        "embed": L.truncated_normal_init(gen, (cfg.vocab_padded, d), 1.0,
                                         dtype),
        "final_norm": L.norm_param(d, cfg.norm_type, gen.device),
    }
    stages = [T.stage_init(gen, cfg, dtype) for _ in range(cfg.num_stages)]
    params["stages"] = _tree.map(lambda *xs: torch.stack(xs), *stages)
    params["rem"] = tuple(T.layer_init(gen, kind, cfg, dtype)
                          for kind in cfg.remainder_blocks)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.truncated_normal_init(
            gen, (d, cfg.vocab_padded), 1.0, dtype)
    return params


def _embed_inputs(params, batch, cfg):
    """tokens (b, s_tok) [+ prefix embeds (b, n_prefix, d)] -> (b, s, d)."""
    x = params["embed"][batch["tokens"].long()]
    if cfg.num_prefix_embeds:
        prefix = batch["embeds"].to(x.dtype)
        x = torch.cat([prefix, x], dim=1)
    return x


def backbone(params, x, positions, cfg):
    """Run stages (+ remainder) over a full sequence.

    Returns (hidden (b, s, d), per-stage mixer caches, aux loss)."""

    def stage_fn(x, stage_params):
        return T.stage_forward(stage_params, x, positions, cfg)

    aux = torch.zeros((), dtype=F32, device=x.device)
    caches = []
    for i in range(cfg.num_stages):
        sp = _tree.map(lambda p: p[i], params["stages"])
        if cfg.remat and torch.is_grad_enabled():
            x, c, a = _ckpt.checkpoint(stage_fn, x, sp, use_reentrant=False)
        else:
            x, c, a = stage_fn(x, sp)
        caches.append(c)
        aux = aux + a
    caches = _tree.map(lambda *xs: torch.stack(xs), *caches) \
        if caches else None

    rem_caches = []
    for lp, kind in zip(params["rem"], cfg.remainder_blocks):
        x, cache, a = T.layer_forward(lp, kind, x, positions, cfg)
        rem_caches.append(cache)
        aux = aux + a
    x = L.norm(x, params["final_norm"], cfg.norm_type)
    return x, (caches, tuple(rem_caches)), aux


def lm_head(params, x, cfg):
    w = params["embed"].mT if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w
    if cfg.logits_softcap:
        cap = cfg.logits_softcap
        logits = cap * torch.tanh(logits.to(F32) / cap)
    return logits


def _positions(x):
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def forward(params, batch, cfg):
    """Training forward.  Returns (logits (b, s, vocab_padded), aux)."""
    x = _embed_inputs(params, batch, cfg)
    x, _, aux = backbone(params, x, _positions(x), cfg)
    return lm_head(params, x, cfg), aux


def hidden_states(params, batch, cfg):
    """Training forward up to the final hidden states (the loss is
    computed chunked in train/step.py, never from full logits)."""
    x = _embed_inputs(params, batch, cfg)
    x, _, aux = backbone(params, x, _positions(x), cfg)
    return x, aux


def param_count(params) -> int:
    return sum(x.numel() for x in _tree.leaves(params))
