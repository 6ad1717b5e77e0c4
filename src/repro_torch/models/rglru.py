"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Port of ``repro/models/rglru.py``:

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    a_t = exp(-c * softplus(Lambda) * r_t),  r_t, i_t input-dependent gates.

Train/prefill runs the linear recurrence as a log-depth scan over the
sequence (Hillis-Steele doubling with the reference's ``combine``) in
place of ``jax.lax.associative_scan``, which has no torch counterpart:
ceil(log2 s) full-width steps instead of s sequential ones.  The two
scans sum in different orders, so they agree to f32 rounding, not bit
for bit.  Decode is one fused step on the (b, d_rnn) f32 state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.ssm import _causal_conv, _softplus

F32 = torch.float32
_C = 8.0


def rglru_init(gen: torch.Generator, cfg, dtype):
    d = cfg.d_model
    dr = cfg.rnn_width
    dev = gen.device
    conv_w = torch.empty((cfg.conv_width, dr), dtype=F32, device=dev)
    conv_w.normal_(generator=gen)
    rates = torch.linspace(0.9, 0.999, dr, dtype=F32, device=dev)
    return {
        "in_x": L.truncated_normal_init(gen, (d, dr), 1.0, dtype),
        "in_gate": L.truncated_normal_init(gen, (d, dr), 1.0, dtype),
        "conv_w": (0.1 * conv_w).to(dtype),
        "w_a": L.truncated_normal_init(gen, (dr, dr), 1.0, dtype),
        "w_i": L.truncated_normal_init(gen, (dr, dr), 1.0, dtype),
        # softplus^-1 of rates in (0.9, 0.999)
        "lam": torch.log(torch.expm1(-torch.log(rates) / _C)),
        "out_proj": L.truncated_normal_init(gen, (dr, d), 1.0, dtype),
    }


def rglru_axes(cfg, stacked: bool):
    """Logical axes of :func:`rglru_init`'s leaves (pure data)."""
    lead = ("layers",) if stacked else ()
    return {
        "in_x": lead + ("embed", "state"),
        "in_gate": lead + ("embed", "state"),
        "conv_w": lead + (None, "state"),
        "w_a": lead + ("state", None),
        "w_i": lead + ("state", None),
        "lam": lead + (None,),
        "out_proj": lead + ("state", "embed"),
    }


def _gates(params, xr):
    """a_t and the gated input, both f32.  xr: (b, s, dr)."""
    r = torch.sigmoid((xr @ params["w_a"]).to(F32))
    i = torch.sigmoid((xr @ params["w_i"]).to(F32))
    log_a = -_C * _softplus(params["lam"])[None, None] * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) with a = exp(log_a): expm1 for stability
    mult = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, mult * i * xr.to(F32)


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis
    1, with ``combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)``:
    returns (prod_{u<=t} a_u, h_t).  Hillis-Steele doubling."""
    s = a.shape[1]
    d = 1
    while d < s:
        a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]],
                          dim=1))
        d *= 2
    return a, b


def rglru_forward(params, x, cfg, *, init_state=None, conv_cache=None):
    """x: (b, s, d) -> (b, s, d); returns (out, (state, conv_tail))."""
    xb = x @ params["in_x"]
    gate = x @ params["in_gate"]
    xb, conv_tail = _causal_conv(xb, params["conv_w"], conv_cache)
    a, u = _gates(params, xb)
    av, h = linear_scan(a, u)
    if init_state is not None:
        h = h + av * init_state.to(F32)[:, None, :]
    state = h[:, -1]
    out = h.to(x.dtype) * F.gelu(gate.to(F32), approximate="tanh").to(
        x.dtype)
    return out @ params["out_proj"], (state, conv_tail)


def rglru_decode(params, x, cache, cfg):
    """One-token decode.  x: (b, 1, d); cache = (state (b, dr) f32,
    conv_tail), updated in place and returned."""
    state, conv_tail = cache
    xb = x @ params["in_x"]
    gate = x @ params["in_gate"]
    xb, conv_tail = _causal_conv(xb, params["conv_w"], conv_tail)
    a, u = _gates(params, xb)
    h = a[:, 0] * state.to(F32) + u[:, 0]
    out = h[:, None].to(x.dtype) * F.gelu(gate.to(F32),
                                          approximate="tanh").to(x.dtype)
    cache[0].copy_(h)
    cache[1].copy_(conv_tail)
    return out @ params["out_proj"], cache


def init_rglru_cache(cfg, batch: int, dtype, device=None):
    return (torch.zeros((batch, cfg.rnn_width), dtype=F32, device=device),
            torch.zeros((batch, cfg.conv_width - 1, cfg.rnn_width),
                        dtype=dtype, device=device))
