"""Mixture-of-Experts FFN with capacity-bounded scatter dispatch.

Port of ``repro/models/moe.py``.  Dispatch is a scatter into an
expert-major (E, C + 1, d) buffer and a gather back, not a one-hot
einsum; the expert products are one batched product over (E, C, d).
Tokens over capacity are dropped (standard capacity-factor semantics) and
land on each expert's trash row, which is discarded.  The router is
softmax-then-top-k with renormalized weights.

``index_put_(..., accumulate=True)`` stands in for the reference's
``.at[].add(mode="drop")``: the kept (expert, slot) pairs are unique, so
only the trash row ever accumulates, and the result is deterministic on
the card.  The top-k is a stable descending sort, so ties go to the
lowest expert index, as ``jax.lax.top_k`` breaks them.  Nothing here
reads back to the host.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import hint
from repro_torch.models import layers as L

F32 = torch.float32


def moe_init(gen: torch.Generator, cfg, dtype):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": L.truncated_normal_init(gen, (d, e), 1.0, F32),
        "wi_gate": L.truncated_normal_init(gen, (e, d, ff), 1.0, dtype),
        "wi_up": L.truncated_normal_init(gen, (e, d, ff), 1.0, dtype),
        "wo": L.truncated_normal_init(gen, (e, ff, d), 1.0, dtype),
    }


def moe_axes(cfg, stacked: bool):
    """Logical axes of :func:`moe_init`'s leaves (pure data)."""
    lead = ("layers",) if stacked else ()
    return {
        "router": lead + ("embed", None),
        "wi_gate": lead + ("experts", "embed", "expert_mlp"),
        "wi_up": lead + ("experts", "embed", "expert_mlp"),
        "wo": lead + ("experts", "expert_mlp", "embed"),
    }


def moe_capacity(tokens: int, cfg) -> int:
    c = math.ceil(tokens * cfg.moe_top_k * cfg.capacity_factor
                  / cfg.num_experts)
    return max(8, c + (-c) % 8)


def top_k(x, k: int):
    """(values, indices) of the k largest entries along the last axis,
    largest first, ties to the lowest index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params, x, cfg):
    """x: (b, s, d) -> ((b, s, d), aux loss)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    t = b * s
    cap = moe_capacity(t, cfg)
    xf = x.reshape(t, d)

    logits = xf.to(F32) @ params["router"].to(F32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k(probs, k)  # (t, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_i.reshape(t * k)
    # position of each (token, k) slot within its expert's buffer; the
    # one-hot is a comparison (F.one_hot checks its input on the host)
    onehot = (flat_e[:, None] == torch.arange(e, device=x.device)).to(
        torch.int32)  # (t*k, e)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=1)
    keep = pos < cap
    # dropped slots land on each expert's trash row
    pos_c = torch.where(keep, pos, cap)
    # jnp.repeat(xf, k, axis=0), without a host read of the repeats
    x_rep = xf[:, None].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((flat_e, pos_c), x_rep, accumulate=True)
    buf = hint(buf, "experts", None, None)
    eb = buf[:, :cap]

    g = torch.bmm(eb, params["wi_gate"])
    u = torch.bmm(eb, params["wi_up"])
    h = F.silu(g.to(F32)).to(x.dtype) * u
    h = hint(h, "experts", None, "expert_mlp")
    y = torch.bmm(h, params["wo"])
    y = hint(y, "experts", None, None)

    yf = F.pad(y, (0, 0, 0, 1))  # restore the trash row (zeros)
    out_slots = yf[flat_e, pos_c] * keep[:, None].to(x.dtype)  # (t*k, d)
    w = (top_w.reshape(t * k).to(F32) * keep.to(F32))[:, None]
    out = (out_slots.to(F32) * w).reshape(t, k, d).sum(dim=1)
    return out.reshape(b, s, d).to(x.dtype), _aux_loss(probs, top_i, e)


def _aux_loss(probs, top_i, e):
    """Switch-style load-balancing auxiliary loss."""
    me = probs.mean(dim=0)  # (e,)
    idx = top_i.reshape(-1)
    ce = torch.zeros((e,), dtype=F32, device=probs.device).index_add(
        0, idx, torch.ones(idx.shape, dtype=F32, device=probs.device))
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    return e * torch.sum(me * ce)
