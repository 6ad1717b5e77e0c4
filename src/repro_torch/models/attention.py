"""GQA attention: chunked online-softmax train/prefill, ring-buffer decode.

Port of ``repro/models/attention.py``.  The reference's blocked
attention is written in torch ops with the same chunking, so autograd
gives its gradient: the outer loop over query chunks is unrolled with
static causal (and sliding-window) key ranges per chunk, the inner loop
over key chunks carries the running (max, sum, acc).  The score and PV
products run in f32, as the reference's ``preferred_element_type=f32``
einsums do on bf16 operands: the operands are upcast (exact) before the
product.

Decode uses a ring-buffer cache of capacity min(context, window): slot
``j`` at step ``pos`` holds absolute position ``pos - ((pos - j) % w)``,
so position p lives in slot p % w.  RoPE is applied to keys at write
time.  The decode step writes its slot with a device index and reads
nothing back to the host.  Unlike the reference, a prefilled prompt of
s >= w tokens is rolled into place (slot p % w), so the ring agrees with
:func:`cache_positions` for every s, not only for multiples of w.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as S
from repro_torch.models import layers as L

F32 = torch.float32
NEG = -1e30
# ring slots a decode step upcasts to f32 at a time (the reference's
# einsum takes f32 products of the bf16 ring without a copy)
DECODE_CHUNK = 4096
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


def attn_axes(cfg, stacked: bool):
    """Logical axes of :func:`attn_init`'s leaves (pure data)."""
    lead = ("layers",) if stacked else ()
    ax = {
        "wq": lead + ("embed", "qkv"),
        "wk": lead + ("embed", "qkv"),
        "wv": lead + ("embed", "qkv"),
        "wo": lead + ("qkv", "embed"),
    }
    if cfg.qk_norm:
        ax["q_scale"] = lead + (None,)
        ax["k_scale"] = lead + (None,)
    return ax


def _split_heads(t, *shape):
    """``t.reshape(*shape)``, splitting the last dimension into heads.

    A DTensor whose last dimension is sharded over a mesh dimension that
    the new head count does not divide is gathered over it first: DTensor
    cannot shard a split dimension across two new ones (GSPMD tiles it),
    so with fewer KV heads than "model" ranks the heads replicate."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        last, heads = t.ndim - 1, shape[t.ndim - 1]
        sizes = t.device_mesh.shape
        placements = [Replicate() if p.is_shard(last) and heads % sizes[i]
                      else p for i, p in enumerate(t.placements)]
        if placements != list(t.placements):
            t = t.redistribute(t.device_mesh, placements)
    return t.reshape(*shape)


def _rows_like(t, w):
    """A DTensor ``t`` (..., k) with its last dimension re-sharded as
    ``w`` (k, n) shards its rows, where ``t`` has it replicated: the
    product ``t @ w`` is then row-parallel, and in the backward the
    gradient returns to ``t``'s heads as they lie (a gathered head split
    has no sharded form, see :func:`_split_heads`)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not (isinstance(t, DTensor) and isinstance(w, DTensor)):
        return t
    placements = [Shard(t.ndim - 1) if isinstance(p, Replicate)
                  and wp.is_shard(w.ndim - 2) else p
                  for p, wp in zip(t.placements, w.placements)]
    if placements == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def _project_qkv(params, x, positions, cfg):
    b, s, _ = x.shape
    kv, g, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim
    q = _split_heads(x @ params["wq"], b, s, kv, g, hd)
    k = _split_heads(x @ params["wk"], b, s, kv, hd)
    v = _split_heads(x @ params["wv"], b, s, kv, hd)
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


def _heads_placements(t):
    """``t``'s placements kept on the batch (dim 0) and KV-head (dim 2)
    dimensions, replicated elsewhere."""
    from torch.distributed.tensor import Replicate

    return [p if p.is_shard(0) or p.is_shard(2) else Replicate()
            for p in t.placements]


def _on_local_heads(q, k, v, attend):
    """``attend(q, k, v)`` on DTensors run on each rank's local blocks.

    Attention is independent over the batch (dim 0) and the KV heads
    (dim 2) of q (b, s, kv, g, hd) and k/v (b, s, kv, hd): those stay
    sharded as q has them (any other sharding is gathered) and each rank
    attends its own block, with no collective and without DTensor's
    dispatch of every small op (its flattening of a sharded batch into
    ``bmm`` is slow to plan, and it has no rule for some of the ring's
    ops on torch 2.11)."""
    mesh, placements = q.device_mesh, _heads_placements(q)
    out = attend(*(S.local_block(t, mesh, placements) for t in (q, k, v)))
    return S.from_local_block(out, mesh, placements,
                              q.shape[:-1] + (v.shape[-1],))


def flash_attention(q, k, v, q_positions, k_positions, *,
                    window: Optional[int] = None, q_chunk: int = 1024,
                    kv_chunk: int = 1024, scale: Optional[float] = None):
    """Causal (optionally sliding-window) attention.

    q: (b, sq, kv, g, hd); k/v: (b, sk, kv, hd).  Positions are absolute.
    Query chunks are unrolled (static causal/window bounds per chunk).
    DTensor operands attend their local blocks (:func:`_on_local_heads`).
    """
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return _on_local_heads(q, k, v, lambda ql, kl, vl: flash_attention(
            ql, kl, vl, q_positions, k_positions, window=window,
            q_chunk=q_chunk, kv_chunk=kv_chunk, scale=scale))
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
    out = _rows_like(out.reshape(b, s, cfg.q_dim).to(x.dtype), params["wo"])
    return out @ params["wo"], (k, v)


def cache_capacity(cfg, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window else max_len


def init_attn_cache(cfg, batch: int, max_len: int, dtype, device=None):
    w = cache_capacity(cfg, max_len)
    shape = (batch, w, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_positions(pos, w: int):
    """Absolute position stored in each ring slot at step ``pos`` (an
    integer tensor on the cache's device)."""
    slots = torch.arange(w, dtype=pos.dtype, device=pos.device)
    return pos - torch.remainder(pos - slots, w)


def attn_fill_cache(cache, k, v, start_pos: int):
    """Write a prefilled [start, start+s) segment into the ring cache
    (DTensor keys and values: on each rank's local blocks)."""
    from torch.distributed.tensor import DTensor

    if isinstance(k, DTensor):
        mesh, placements = k.device_mesh, _heads_placements(k)
        shape = (k.shape[0], cache["k"].shape[1]) + tuple(k.shape[2:])
        local = attn_fill_cache(
            {n: c.to_local() if isinstance(c, DTensor) else c
             for n, c in cache.items()} if isinstance(cache["k"], DTensor)
            else _local_zeros(cache, k, mesh, placements),
            S.local_block(k, mesh, placements),
            S.local_block(v, mesh, placements), start_pos)
        return {n: S.from_local_block(t, mesh, placements, shape)
                for n, t in local.items()}
    w = cache["k"].shape[1]
    s = k.shape[1]
    if s >= w:
        # position p goes to slot p % w: the last w keys, rolled by s % w
        return {"k": torch.roll(k[:, -w:], s % w, dims=1),
                "v": torch.roll(v[:, -w:], s % w, dims=1)}
    # assumes start_pos == 0 for prefill (suffix write); the start is
    # clamped so the segment fits, as dynamic_update_slice clamps it
    lo = min(start_pos % w, w - s)
    ck, cv = cache["k"].clone(), cache["v"].clone()
    ck[:, lo:lo + s] = k
    cv[:, lo:lo + s] = v
    return {"k": ck, "v": cv}


def _local_zeros(cache, k, mesh, placements):
    """This rank's blocks of a plain ring ``cache`` laid out as ``k``'s
    ``placements`` on ``mesh``."""
    from torch.distributed.tensor import distribute_tensor

    return {n: distribute_tensor(c, mesh, placements,
                                 src_data_rank=None).to_local()
            for n, c in cache.items()}


def attn_decode(params, x, pos, cache, cfg):
    """One-token decode.  x: (b, 1, d); pos: 0-d int32 tensor (the
    current index) on x's device.  Writes the new slot into ``cache`` in
    place; the scores and the PV product take the ring DECODE_CHUNK slots
    at a time, so no f32 copy of the whole ring is made.  DTensor
    operands attend on each rank's local blocks of the cache.

    Returns (out (b, 1, d), cache)."""
    from torch.distributed.tensor import DTensor

    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, pos.reshape(1), cfg)
    if isinstance(q, DTensor):
        ck = cache["k"]
        mesh, placements = ck.device_mesh, _heads_placements(ck)
        o = S.from_local_block(_decode_attend(
            *(S.local_block(t, mesh, placements) for t in (q, k_new, v_new)),
            ck.to_local(), cache["v"].to_local(),
            pos.to_local() if isinstance(pos, DTensor) else pos, cfg), mesh,
            placements, q.shape)
    else:
        o = _decode_attend(q, k_new, v_new, cache["k"], cache["v"], pos, cfg)
    o = o.reshape(b, 1, cfg.q_dim).to(x.dtype)
    return o @ params["wo"], cache


def _decode_attend(q, k_new, v_new, ck, cv, pos, cfg):
    """The new slot written into the ring ``ck``/``cv`` in place, and
    q's attention over the ring: (b, 1, kv, g, hd) f32."""
    hd = cfg.head_dim
    w = ck.shape[1]
    slot = torch.remainder(pos, w).reshape(1).long()
    ck.index_copy_(1, slot, k_new)
    cv.index_copy_(1, slot, v_new)
    kpos = cache_positions(pos, w)  # (w,)
    valid = kpos >= 0
    if cfg.window:
        valid = valid & (kpos > pos - cfg.window)
    q = q.to(F32)
    chunks = range(0, w, DECODE_CHUNK)
    s = torch.cat([torch.einsum("bqhgd,bkhd->bhgqk", q,
                                ck[:, i:i + DECODE_CHUNK].to(F32))
                   for i in chunks], dim=-1) / math.sqrt(hd)
    s = torch.where(valid, s, NEG)
    p = torch.softmax(s, dim=-1)
    return sum(torch.einsum("bhgqk,bkhd->bqhgd", p[..., i:i + DECODE_CHUNK],
                            cv[:, i:i + DECODE_CHUNK].to(F32))
               for i in chunks)
