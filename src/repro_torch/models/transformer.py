"""Layer/stage assembly: pattern-scheduled blocks over stacked stages.

Port of ``repro/models/transformer.py``.  A *layer* = temporal mixer
(attn | rglru | ssd) + optional MLP (dense or MoE); a *stage* = one
repetition of ``cfg.block_pattern``.  The model loops over
``num_stages`` stacked stages (+ an unstacked remainder, e.g.
recurrentgemma's 26 = 8 x (R, R, A) + (R, R)).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.dist.sharding import settle
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RGL
from repro_torch.models import ssm as SSD

F32 = torch.float32

class _Mixer(NamedTuple):
    """One mixer kind: ``init(gen, cfg, dtype)``, ``forward(params, h,
    positions, cfg) -> (out, mixer_cache)``, ``decode(params, h, pos,
    cache, cfg) -> (out, cache)`` (the cache updated in place),
    ``cache(cfg, batch, max_len, dtype, device)`` and ``fill(cfg,
    max_len, mixer_cache, dtype)`` (a forward's mixer cache in the
    decode format)."""
    init: Callable
    forward: Callable
    decode: Callable
    cache: Callable
    fill: Callable


def _fill_attn(cfg, max_len, mixer_cache, dtype):
    k, v = mixer_cache
    empty = ATT.init_attn_cache(cfg, k.shape[0], max_len, dtype, k.device)
    return ATT.attn_fill_cache(empty, k, v, 0)


def _fill_state(cfg, max_len, mixer_cache, dtype):
    return mixer_cache  # (state, conv_tail) already decode-shaped


MIXERS = {
    "attn": _Mixer(ATT.attn_init, ATT.attn_forward, ATT.attn_decode,
                   ATT.init_attn_cache, _fill_attn),
    "rglru": _Mixer(
        RGL.rglru_init,
        lambda p, h, positions, cfg: RGL.rglru_forward(p, h, cfg),
        lambda p, h, pos, cache, cfg: RGL.rglru_decode(p, h, cache, cfg),
        lambda cfg, b, max_len, dtype, device: RGL.init_rglru_cache(
            cfg, b, dtype, device),
        _fill_state),
    "ssd": _Mixer(
        SSD.ssd_init,
        lambda p, h, positions, cfg: SSD.ssd_forward(p, h, cfg),
        lambda p, h, pos, cache, cfg: SSD.ssd_decode(p, h, cache, cfg),
        lambda cfg, b, max_len, dtype, device: SSD.init_ssd_cache(
            cfg, b, dtype, device),
        _fill_state),
}


# --- single layer -----------------------------------------------------------


def _mixer(kind: str) -> _Mixer:
    """The mixer of block ``kind``; an unknown kind raises ValueError
    naming the known ones."""
    if kind not in MIXERS:
        raise ValueError(f"unknown block kind {kind!r}; known: "
                         f"{sorted(MIXERS)}")
    return MIXERS[kind]


def layer_init(gen: torch.Generator, kind: str, cfg, dtype):
    mixer = _mixer(kind)
    p: Dict[str, Any] = {"norm1": L.norm_param(cfg.d_model, cfg.norm_type,
                                               gen.device)}
    p["mixer"] = mixer.init(gen, cfg, dtype)
    if cfg.mlp_type != "none":
        p["norm2"] = L.norm_param(cfg.d_model, cfg.norm_type, gen.device)
        if cfg.num_experts:
            p["mlp"] = MOE.moe_init(gen, cfg, dtype)
        else:
            p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                                  dtype)
    return p


_MIXER_AXES = {"attn": ATT.attn_axes, "rglru": RGL.rglru_axes,
               "ssd": SSD.ssd_axes}


def layer_axes(kind: str, cfg, stacked: bool):
    """Logical axes of :func:`layer_init`'s leaves (pure data)."""
    lead = ("layers",) if stacked else ()
    ax: Dict[str, Any] = {"norm1": None if cfg.norm_type == "nonparam_ln"
                          else lead + (None,)}
    if kind in _MIXER_AXES:
        ax["mixer"] = _MIXER_AXES[kind](cfg, stacked)
    if cfg.mlp_type != "none":
        ax["norm2"] = None if cfg.norm_type == "nonparam_ln" \
            else lead + (None,)
        if cfg.num_experts:
            ax["mlp"] = MOE.moe_axes(cfg, stacked)
        else:
            ax["mlp"] = L.mlp_axes(cfg.mlp_type, stacked)
    return ax


def _mlp(params, x, cfg):
    """x + MLP(norm2(x)), and the MoE aux loss (None for a dense MLP)."""
    if cfg.mlp_type == "none":
        return x, None
    h2 = L.norm(x, params["norm2"], cfg.norm_type)
    if cfg.num_experts:
        out, aux = MOE.moe_apply(params["mlp"], h2, cfg)
        return x + settle(out), aux
    return x + settle(L.mlp_apply(params["mlp"], h2, cfg.mlp_type)), None


def layer_forward(params, kind: str, x, positions, cfg):
    """Full-sequence layer (train / prefill).  Returns (x, mixer_cache,
    aux)."""
    mixer = _mixer(kind)
    h = L.norm(x, params["norm1"], cfg.norm_type)
    mix, cache_out = mixer.forward(params["mixer"], h, positions, cfg)
    x, aux = _mlp(params, x + settle(mix), cfg)
    if aux is None:
        aux = torch.zeros((), dtype=F32, device=x.device)
    return x, cache_out, aux


def layer_decode(params, kind: str, x, pos, cache, cfg):
    """One-token layer step; updates ``cache`` in place.  Returns (x,
    cache)."""
    mixer = _mixer(kind)
    h = L.norm(x, params["norm1"], cfg.norm_type)
    mix, cache = mixer.decode(params["mixer"], h, pos, cache, cfg)
    x, _ = _mlp(params, x + mix, cfg)
    return x, cache


def init_layer_cache(kind: str, cfg, batch: int, max_len: int, dtype,
                     device=None):
    return _mixer(kind).cache(cfg, batch, max_len, dtype, device)


def prefill_layer_cache(kind: str, cfg, max_len, mixer_cache, dtype):
    """Convert a layer_forward mixer cache into the decode cache format."""
    return _mixer(kind).fill(cfg, max_len, mixer_cache, dtype)


# --- stages -----------------------------------------------------------------


def stage_init(gen: torch.Generator, cfg, dtype):
    return tuple(layer_init(gen, kind, cfg, dtype)
                 for kind in cfg.block_pattern)


def stage_axes(cfg, stacked: bool):
    return tuple(layer_axes(kind, cfg, stacked)
                 for kind in cfg.block_pattern)


def stage_forward(params, x, positions, cfg):
    caches, aux = [], torch.zeros((), dtype=F32, device=x.device)
    for lp, kind in zip(params, cfg.block_pattern):
        x, cache, a = layer_forward(lp, kind, x, positions, cfg)
        caches.append(cache)
        aux = aux + a
    return x, tuple(caches), aux


def stage_decode(params, x, pos, caches, cfg):
    new = []
    for lp, kind, cache in zip(params, cfg.block_pattern, caches):
        x, c = layer_decode(lp, kind, x, pos, cache, cfg)
        new.append(c)
    return x, tuple(new)
