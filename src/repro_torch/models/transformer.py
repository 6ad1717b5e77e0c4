"""Layer/stage assembly for attention-only dense models.

Port of ``repro/models/transformer.py`` for ``kind == "attn"`` with a
dense MLP.  A *layer* = attention + optional MLP; a *stage* = one
repetition of ``cfg.block_pattern``.  The RG-LRU and SSD mixers and MoE
MLPs are not ported yet and raise :class:`NotImplementedError`.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as ATT
from repro_torch.models import layers as L

F32 = torch.float32


def check_supported(cfg, kind: str) -> None:
    """Raise :class:`NotImplementedError` for a block kind or MLP the port
    does not have yet (the MoE, SSD and RG-LRU families come in a later
    slice of the port)."""
    if kind in ("rglru", "ssd"):
        raise NotImplementedError(
            f"{cfg.name}: {kind!r} blocks are not ported to repro_torch yet "
            f"(the MoE, SSD and RG-LRU slice of the port)")
    if kind != "attn":
        raise ValueError(kind)
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE MLPs (num_experts={cfg.num_experts}) are not "
            f"ported to repro_torch yet (the MoE, SSD and RG-LRU slice of "
            f"the port)")


# --- single layer -----------------------------------------------------------


def layer_init(gen: torch.Generator, kind: str, cfg, dtype):
    check_supported(cfg, kind)
    p: Dict[str, Any] = {"norm1": L.norm_param(cfg.d_model, cfg.norm_type,
                                               gen.device)}
    p["mixer"] = ATT.attn_init(gen, cfg, dtype)
    if cfg.mlp_type != "none":
        p["norm2"] = L.norm_param(cfg.d_model, cfg.norm_type, gen.device)
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                              dtype)
    return p


def layer_forward(params, kind: str, x, positions, cfg):
    """Full-sequence layer (train / prefill).  Returns (x, mixer_cache, aux)."""
    check_supported(cfg, kind)
    h = L.norm(x, params["norm1"], cfg.norm_type)
    aux = torch.zeros((), dtype=F32, device=x.device)
    mix, (k, v) = ATT.attn_forward(params["mixer"], h, positions, cfg)
    x = x + mix
    if cfg.mlp_type != "none":
        h2 = L.norm(x, params["norm2"], cfg.norm_type)
        x = x + L.mlp_apply(params["mlp"], h2, cfg.mlp_type)
    return x, (k, v), aux


# --- stages -----------------------------------------------------------------


def stage_init(gen: torch.Generator, cfg, dtype):
    return tuple(layer_init(gen, kind, cfg, dtype)
                 for kind in cfg.block_pattern)


def stage_forward(params, x, positions, cfg):
    caches, aux = [], torch.zeros((), dtype=F32, device=x.device)
    for lp, kind in zip(params, cfg.block_pattern):
        x, cache, a = layer_forward(lp, kind, x, positions, cfg)
        caches.append(cache)
        aux = aux + a
    return x, tuple(caches), aux
