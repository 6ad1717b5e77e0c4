"""Public model API: init / forward / prefill / decode over the full stack.

Port of ``repro/models/model.py``.  Params layout, as
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

Serving (:func:`init_caches`, :func:`prefill`, :func:`decode_step`)
keeps the reference's cache tree — ``{"stages": per-layer caches stacked
over num_stages, "rem": tuple, "pos": int32}`` — with ``pos`` a 0-d
tensor on the device; the reference's ``vmap`` and ``scan`` over stages
are loops over the stacked leading axis.  :func:`decode_step` is
functional, as the reference's; :func:`decode_step_`, which the serving
engine runs, writes the new ring slot and states into the caches in
place, so a step copies no cache.  Neither reads anything back to the
host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch import tree as _tree
from repro_torch.dist.sharding import settle
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

F32 = torch.float32


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


def params_axes(cfg):
    """Logical axes of :func:`init_params`'s tree (pure data)."""
    ax = {
        "embed": ("vocab", "embed"),
        "final_norm": None if cfg.norm_type == "nonparam_ln" else (None,),
        "stages": T.stage_axes(cfg, stacked=True),
        "rem": tuple(T.layer_axes(kind, cfg, stacked=False)
                     for kind in cfg.remainder_blocks),
    }
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("embed", "vocab")
    return ax


def _embed_inputs(params, batch, cfg):
    """tokens (b, s_tok) [+ prefix embeds (b, n_prefix, d)] -> (b, s, d)."""
    # an embedding lookup (not indexing), which DTensor runs
    # vocabulary-parallel on a vocab-sharded table
    x = settle(F.embedding(batch["tokens"].long(), params["embed"]))
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


# --- serving ---------------------------------------------------------------


def _stage(tree_, i):
    return _tree.map(lambda t: t[i], tree_)


def init_caches(cfg, batch: int, max_len: int, device=None):
    """Zeroed decode caches (the reference's tree) on ``device`` (the
    card when None); ``pos`` a 0-d int32 tensor."""
    from repro_torch.solver import resolve_device

    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    one_stage = tuple(T.init_layer_cache(kind, cfg, batch, max_len, dtype,
                                         dev)
                      for kind in cfg.block_pattern)
    rem = tuple(T.init_layer_cache(kind, cfg, batch, max_len, dtype, dev)
                for kind in cfg.remainder_blocks)
    return {"stages": _tree.map(
                lambda t: t.new_zeros((cfg.num_stages,) + t.shape),
                one_stage),
            "rem": rem,
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def _caches_like(caches, x, cfg):
    """``caches`` on ``x``'s mesh when ``x`` is a DTensor: placed by
    :func:`caches_axes` under the active sharding rules, replicated
    without any (zeros, the same on every rank: no collective)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return caches
    from repro_torch.dist import sharding as S

    mesh = x.device_mesh
    rules = S.current_rules() or S.LogicalRules({}, mesh=mesh)
    return S.distribute_tree(
        caches, S.tree_shardings(mesh, rules, caches_axes(cfg)),
        src_data_rank=None)


def _copy_into(dst, src):
    _tree.map(lambda d, s: d.copy_(s), dst, src)


@torch.no_grad()
def prefill(params, batch, cfg, max_len: int):
    """Run the prompt through the backbone and build decode caches.

    The caches are allocated once, at their stacked size, and each
    layer's prompt cache is written into its stage's slice.  Returns
    (last_token_logits (b, vocab_padded), caches)."""
    dtype = getattr(torch, cfg.dtype)
    x = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    x, (stage_mixer_caches, rem_mixer), _ = backbone(
        params, x, _positions(x), cfg)
    caches = _caches_like(init_caches(cfg, b, max_len, x.device), x, cfg)
    for i in range(cfg.num_stages):
        for kind, mc, dst in zip(cfg.block_pattern,
                                 _stage(stage_mixer_caches, i),
                                 _stage(caches["stages"], i)):
            _copy_into(dst, T.prefill_layer_cache(kind, cfg, max_len, mc,
                                                  dtype))
    for kind, mc, dst in zip(cfg.remainder_blocks, rem_mixer,
                             caches["rem"]):
        _copy_into(dst, T.prefill_layer_cache(kind, cfg, max_len, mc, dtype))
    caches["pos"].fill_(s)
    return lm_head(params, x[:, -1:], cfg)[:, 0], caches


@torch.no_grad()
def decode_step(params, tokens, caches, cfg):
    """One decode step, functional as the reference's: ``caches`` stays
    as it was and the new caches are a copy.  tokens: (b, 1) integer.
    Returns (logits (b, vocab_padded), caches).  A loop that owns its
    caches calls :func:`decode_step_`, which copies nothing."""
    return decode_step_(params, tokens, _tree.map(torch.clone, caches), cfg)


@torch.no_grad()
def decode_step_(params, tokens, caches, cfg):
    """:func:`decode_step` in place: the new ring slot and recurrent
    states are written into ``caches``' stacked buffers and ``pos``
    advances (the reference's compiled step updates its carry in place
    too).  Returns (logits (b, vocab_padded), caches)."""
    pos = caches["pos"]
    x = params["embed"][tokens.long()]
    for i in range(cfg.num_stages):
        x, _ = T.stage_decode(_stage(params["stages"], i), x, pos,
                              _stage(caches["stages"], i), cfg)
    for lp, kind, cache in zip(params["rem"], cfg.remainder_blocks,
                               caches["rem"]):
        x, _ = T.layer_decode(lp, kind, x, pos, cache, cfg)
    x = L.norm(x, params["final_norm"], cfg.norm_type)
    logits = lm_head(params, x, cfg)[:, 0]
    pos.add_(1)
    return logits, caches


def param_count(params) -> int:
    return sum(x.numel() for x in _tree.leaves(params))


def caches_axes(cfg):
    """Logical axes for :func:`init_caches`' tree (pure data)."""

    def layer_axes(kind, stacked: bool):
        lead = ("layers",) if stacked else ()
        if kind == "attn":
            return {"k": lead + ("cache_batch", None, "cache_heads", None),
                    "v": lead + ("cache_batch", None, "cache_heads", None)}
        if kind == "rglru":
            return (lead + ("cache_batch", "state"),
                    lead + ("cache_batch", None, "state"))
        return (lead + ("cache_batch", "cache_heads", None, None),
                lead + ("cache_batch", None, "state"))

    return {
        "stages": tuple(layer_axes(kind, True)
                        for kind in cfg.block_pattern),
        "rem": tuple(layer_axes(kind, False)
                     for kind in cfg.remainder_blocks),
        "pos": "REPLICATED",
    }
