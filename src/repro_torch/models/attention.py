"""GQA attention, the train/prefill half: chunked online-softmax attention.

Port of ``repro/models/attention.py:27-159``.  The reference's blocked
attention is written in torch ops with the same chunking, so autograd
gives its gradient: the outer loop over query chunks is unrolled with
static causal (and sliding-window) key ranges per chunk, the inner loop
over key chunks carries the running (max, sum, acc).  The score and PV
products run in f32, as the reference's ``preferred_element_type=f32``
einsums do on bf16 operands: the operands are upcast (exact) before the
product.  Decode (the ring-buffer KV cache) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

F32 = torch.float32
NEG = -1e30
INT32_MAX = 2 ** 31 - 1


def attn_init(gen: torch.Generator, cfg, dtype):
    d = cfg.d_model
    p = {
        "wq": L.truncated_normal_init(gen, (d, cfg.q_dim), 1.0, dtype),
        "wk": L.truncated_normal_init(gen, (d, cfg.kv_dim), 1.0, dtype),
        "wv": L.truncated_normal_init(gen, (d, cfg.kv_dim), 1.0, dtype),
        "wo": L.truncated_normal_init(gen, (cfg.q_dim, d), 1.0, dtype),
    }
    if cfg.qk_norm:
        p["q_scale"] = torch.zeros((cfg.head_dim,), dtype=F32,
                                   device=gen.device)
        p["k_scale"] = torch.zeros((cfg.head_dim,), dtype=F32,
                                   device=gen.device)
    return p


def _project_qkv(params, x, positions, cfg):
    b, s, _ = x.shape
    kv, g, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, kv, g, hd)
    k = (x @ params["wk"]).reshape(b, s, kv, hd)
    v = (x @ params["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, params["q_scale"])
        k = L.rms_norm(k, params["k_scale"])
    q = L.apply_rope(q.reshape(b, s, kv * g, hd), positions,
                     cfg.rope_theta).reshape(b, s, kv, g, hd)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _flash_chunk(q, k, v, qpos, kpos, scale, kv_chunk,
                 window: Optional[int] = None):
    """Online-softmax attention of one query chunk against [k, v].

    q: (b, qc, kv, g, d); k/v: (b, sk, kv, d); qpos (qc,), kpos (sk,).
    """
    b, qc, kv, g, hd = q.shape
    sk = k.shape[1]
    nk = max(1, math.ceil(sk / kv_chunk))
    pad = nk * kv_chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = F.pad(kpos, (0, pad), value=INT32_MAX)
    kc = kv_chunk
    kpos = kpos.reshape(nk, kc)

    dev = q.device
    m = torch.full((b, kv, g, qc), NEG, dtype=F32, device=dev)
    l = torch.zeros((b, kv, g, qc), dtype=F32, device=dev)
    acc = torch.zeros((b, kv, g, qc, hd), dtype=F32, device=dev)
    q32 = q.to(F32)
    qp = qpos[None, None, None, :, None]
    for i in range(nk):
        kb = k[:, i * kc:(i + 1) * kc].to(F32)
        vb = v[:, i * kc:(i + 1) * kc].to(F32)
        kp = kpos[i][None, None, None, None, :]
        s = torch.einsum("bqhgd,bkhd->bhgqk", q32, kb) * scale
        mask = kp <= qp
        if window is not None:
            mask = mask & (kp > qp - window)
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4)  # (b, qc, kv, g, hd)


def flash_attention(q, k, v, q_positions, k_positions, *,
                    window: Optional[int] = None, q_chunk: int = 1024,
                    kv_chunk: int = 1024, scale: Optional[float] = None):
    """Causal (optionally sliding-window) attention.

    q: (b, sq, kv, g, hd); k/v: (b, sk, kv, hd).  Positions are absolute.
    Query chunks are unrolled (static causal/window bounds per chunk).
    """
    b, sq, kv, g, hd = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qc = min(q_chunk, sq)
    nq = math.ceil(sq / qc)
    outs = []
    for i in range(nq):
        lo = i * qc
        hi = min(sq, lo + qc)
        # static key range this chunk can see (q/k positions are aligned
        # suffixes: q_positions = k_positions[-sq:])
        k_hi = min(sk, hi + (sk - sq))
        k_lo = 0
        if window is not None:
            k_lo = max(0, lo + (sk - sq) - window + 1)
        outs.append(_flash_chunk(q[:, lo:hi], k[:, k_lo:k_hi],
                                 v[:, k_lo:k_hi], q_positions[lo:hi],
                                 k_positions[k_lo:k_hi], scale, kv_chunk,
                                 window=window))
    return torch.cat(outs, dim=1)


def attn_forward(params, x, positions, cfg, *, q_chunk=1024, kv_chunk=1024):
    """Training/prefill attention over a full sequence (causal)."""
    b, s, d = x.shape
    q, k, v = _project_qkv(params, x, positions, cfg)
    out = flash_attention(q, k, v, positions, positions,
                          window=cfg.window, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)
    out = out.reshape(b, s, cfg.q_dim).to(x.dtype)
    return out @ params["wo"], (k, v)
