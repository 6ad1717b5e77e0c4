"""Shared layers: norms, rotary embeddings, MLPs, initializers.

Port of ``repro/models/layers.py``.  Norms and RoPE compute in f32 and
cast back to the input's dtype, and the MLP's activation is f32, as in
the reference.  Parameters are plain tensors in nested dicts (the
reference's layout); initializers draw from an explicit
``torch.Generator`` on the device the parameters live on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


class MetaGenerator(torch.Generator):
    """The initializers' abstract mode: a generator whose ``device`` is
    ``meta``.  Handed to :func:`repro_torch.models.init_params` (or a
    train step's ``init_state``), it builds every tensor at its shape and
    dtype on the meta device, holding no data and drawing nothing — the
    counterpart of ``jax.eval_shape`` over the reference's init."""

    @property
    def device(self):
        return torch.device("meta")


def truncated_normal_init(gen: torch.Generator, shape, scale: float,
                          dtype=F32):
    """N(0, 1) truncated to [-2, 2], times scale / sqrt(fan_in) with
    fan_in = shape[-2] (shape[-1] for a vector), drawn in f32 on
    ``gen``'s device and cast to ``dtype``."""
    shape = tuple(shape)
    fan_in = shape[-2] if len(shape) > 1 else shape[-1]
    stddev = scale / max(1.0, fan_in) ** 0.5
    x = torch.empty(shape, dtype=F32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (stddev * x).to(dtype)


def rms_norm(x, scale=None, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(F32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.to(F32))
    return y.to(dt)


def nonparam_ln(x, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm (no scale, no bias)."""
    dt = x.dtype
    x = x.to(F32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def norm(x, params, norm_type: str):
    if norm_type == "nonparam_ln":
        return nonparam_ln(x)
    return rms_norm(x, params)


def norm_param(d: int, norm_type: str, device=None):
    return None if norm_type == "nonparam_ln" else \
        torch.zeros((d,), dtype=F32, device=device)


# --- rotary position embeddings -------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=F32, device=device)
                     / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    ang = positions[..., None].to(F32) * freqs  # (..., seq, hd/2)
    ang = ang[..., None, :]  # broadcast over heads
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- MLPs ------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, ff: int, mlp_type: str, dtype):
    if mlp_type == "swiglu":
        return {
            "wi_gate": truncated_normal_init(gen, (d, ff), 1.0, dtype),
            "wi_up": truncated_normal_init(gen, (d, ff), 1.0, dtype),
            "wo": truncated_normal_init(gen, (ff, d), 1.0, dtype),
        }
    return {
        "wi": truncated_normal_init(gen, (d, ff), 1.0, dtype),
        "wo": truncated_normal_init(gen, (ff, d), 1.0, dtype),
    }


def mlp_axes(mlp_type: str, stacked: bool):
    """Logical axes of :func:`mlp_init`'s leaves (pure data)."""
    lead = ("layers",) if stacked else ()
    if mlp_type == "swiglu":
        return {
            "wi_gate": lead + ("embed", "mlp"),
            "wi_up": lead + ("embed", "mlp"),
            "wo": lead + ("mlp", "embed"),
        }
    return {"wi": lead + ("embed", "mlp"), "wo": lead + ("mlp", "embed")}


def mlp_apply(params, x, mlp_type: str):
    if mlp_type == "swiglu":
        g = x @ params["wi_gate"]
        u = x @ params["wi_up"]
        h = F.silu(g.to(F32)).to(x.dtype) * u
        return h @ params["wo"]
    h = x @ params["wi"]
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(h.to(F32), approximate="tanh").to(x.dtype)
    return h @ params["wo"]
