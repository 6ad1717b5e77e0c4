"""Mamba2 SSD (state-space duality) block — chunked, matmul-rich form.

Port of ``repro/models/ssm.py``.  Intra-chunk terms are (L x L) products,
inter-chunk terms a short recurrence over chunk states: the reference's
``lax.scan`` over chunks is a Python loop here.  A sequence that is not a
whole number of chunks is padded with zeros (zero dt is exact: decay
exp(0) = 1, contribution dt x = 0).

Decode keeps O(1) state: (b, heads, head_dim, n_state) in f32 and the
causal conv's tail.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as S
from repro_torch.models import layers as L

F32 = torch.float32
NEG = -1e30


def ssd_init(gen: torch.Generator, cfg, dtype):
    d = cfg.d_model
    di = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    conv_dim = di + 2 * n
    dev = gen.device
    conv_w = torch.empty((cfg.conv_width, conv_dim), dtype=F32, device=dev)
    conv_w.normal_(generator=gen)
    return {
        # order: [z (di), x (di), B (n), C (n), dt (h)]
        "in_proj": L.truncated_normal_init(
            gen, (d, 2 * di + 2 * n + h), 1.0, dtype),
        "conv_w": (0.1 * conv_w).to(dtype),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=F32,
                                          device=dev)),
        "d_skip": torch.ones((h,), dtype=F32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=F32, device=dev),
        "norm_scale": torch.zeros((di,), dtype=F32, device=dev),
        "out_proj": L.truncated_normal_init(gen, (di, d), 1.0, dtype),
    }


def ssd_axes(cfg, stacked: bool):
    """Logical axes of :func:`ssd_init`'s leaves (pure data)."""
    lead = ("layers",) if stacked else ()
    return {
        "in_proj": lead + ("embed", "ssd_in"),
        "conv_w": lead + (None, "state"),
        "a_log": lead + (None,),
        "d_skip": lead + (None,),
        "dt_bias": lead + (None,),
        "norm_scale": lead + (None,),
        "out_proj": lead + ("state", "embed"),
    }


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv.  x: (b, s, c); w: (width, c).

    With a cache (b, width-1, c) of the previous tail, returns the conv
    output and the new tail."""
    width = w.shape[0]
    pad = cache if cache is not None else torch.zeros(
        (x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :]
              for i in range(width))
    return out, xp[:, -(width - 1):]


def _segsum(dA):
    """out[..., l, s] = sum_{s < t <= l} dA[..., t] (the lower triangle
    is the meaningful part).  dA: (..., L) -> (..., L, L)."""
    cs = torch.cumsum(dA, dim=-1)
    return cs[..., :, None] - cs[..., None, :]


def ssd_scan(x, dt, a, b, c, chunk: int, init_state=None):
    """Chunked SSD.  x: (bt, s, h, p); dt: (bt, s, h); a: (h,) > 0 decay
    rates; b, c: (bt, s, n).  Returns (y (bt, s, h, p) f32, state
    (bt, h, p, n) f32)."""
    bt, s, h, p = x.shape
    n = b.shape[-1]
    ll = min(chunk, s)
    pad = (-s) % ll
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    s_orig, s = s, s + pad
    nc = s // ll

    xc = x.reshape(bt, nc, ll, h, p).to(F32)
    dtc = dt.reshape(bt, nc, ll, h).to(F32)
    bc = b.reshape(bt, nc, ll, n).to(F32)
    cc = c.reshape(bt, nc, ll, n).to(F32)
    da = -a[None, None, None, :] * dtc  # (bt, nc, L, h), negative
    cs = torch.cumsum(da, dim=2)  # inclusive within chunk
    xdt = xc * dtc[..., None]  # (bt, nc, L, h, p)

    # intra-chunk: y[l] += sum_{s<=l} (C_l . B_s) exp(cs_l - cs_s) xdt[s]
    g = torch.einsum("bcln,bcsn->bcls", cc, bc)  # (bt, nc, L, L)
    tri = torch.tril(torch.ones((ll, ll), dtype=torch.bool, device=x.device))
    seg = _segsum(da.movedim(-1, 2))  # (bt, nc, h, L, L)
    # mask BEFORE exp: the upper triangle is positive and overflows, and
    # exp-then-mask leaks NaN through the where in the backward pass
    decay = torch.exp(torch.where(tri, seg, NEG))
    m = g[:, :, None] * decay  # (bt, nc, h, L, L)
    y_intra = torch.einsum("bchls,bcshp->bclhp", m, xdt)

    # chunk states: S_c = sum_s exp(cs_last - cs_s) B_s (x_s dt_s)^T
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)  # (bt, nc, L, h)
    sc = torch.einsum("bcsn,bcsh,bcshp->bchpn", bc, decay_to_end, xdt)

    # inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (bt, nc, h)
    state = torch.zeros((bt, h, p, n), dtype=F32, device=x.device) \
        if init_state is None else init_state.to(F32)
    s_in = []
    for i in range(nc):
        s_in.append(state)  # the state entering chunk i
        state = state * chunk_decay[:, i, :, None, None] + sc[:, i]
    s_in = torch.stack(s_in, dim=1)  # (bt, nc, h, p, n)

    # inter-chunk output: y[l] += exp(cs_l) C_l . S_in
    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", cc, torch.exp(cs),
                           s_in)
    y = (y_intra + y_inter).reshape(bt, s, h, p)
    return y[:, :s_orig], state


def _scan_on_local_blocks(x, dt, a, b, c, chunk: int, init_state=None):
    """:func:`ssd_scan` of DTensors on each rank's local blocks: the scan
    is independent over the batch and the heads, so x (bt, s, h, p) and
    dt keep those shards (any other is gathered), the rates ``a`` follow
    the heads, B and C the batch, and the scan runs on plain tensors.
    Where ``a`` (or B, C) is replicated over a mesh dimension that x is
    split over, each rank's gradient of it is a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    xp = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
          for p in x.placements]
    bp = [p if p.is_shard(0) else Replicate() for p in xp]
    ap = [Shard(0) if p.is_shard(2) else Replicate() for p in xp]
    sp = [Shard(1) if p.is_shard(2) else p for p in xp]  # (bt, h, p, n)

    def share(ps):
        return [Partial() if q.is_shard() and p.is_replicate() else p
                for q, p in zip(xp, ps)]

    st = None if init_state is None else S.local_block(init_state, mesh, sp)
    y, state = ssd_scan(S.local_block(x, mesh, xp),
                        S.local_block(dt, mesh, xp),
                        S.local_block(a, mesh, ap, share(ap)),
                        S.local_block(b, mesh, bp, share(bp)),
                        S.local_block(c, mesh, bp, share(bp)), chunk,
                        init_state=st)
    bt, s, h, p = x.shape
    return (S.from_local_block(y, mesh, xp, x.shape),
            S.from_local_block(state, mesh, sp, (bt, h, p, b.shape[-1])))


def _in_proj(params, x, cfg, conv_cache):
    """z, the conv'd (x, B, C) and dt_raw of the input projection, and
    the conv's new tail."""
    di, n = cfg.d_inner, cfg.ssm_state
    proj = x @ params["in_proj"]
    z, xin, bmat, cmat, dt_raw = torch.split(
        proj, [di, di, n, n, cfg.ssm_heads], dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out, conv_tail = _causal_conv(conv_in, params["conv_w"], conv_cache)
    conv_out = F.silu(conv_out.to(F32)).to(x.dtype)
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)
    return z, xin, bmat, cmat, dt_raw, conv_tail


def _out_proj(params, y, z, x):
    # gated RMSNorm then out-projection (mamba2 ordering)
    y = L.rms_norm(y * F.silu(z.to(F32)).to(x.dtype), params["norm_scale"])
    return y @ params["out_proj"]


def _softplus(x):
    """jax.nn.softplus: log(1 + e^x) without torch's linear threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssd_forward(params, x, cfg, *, init_state=None, conv_cache=None):
    """Full SSD mixer.  x: (b, s, d) -> (b, s, d), plus (state,
    conv_tail)."""
    b, s, d = x.shape
    di, h, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z, xin, bmat, cmat, dt_raw, conv_tail = _in_proj(params, x, cfg,
                                                     conv_cache)
    dt = _softplus(dt_raw.to(F32) + params["dt_bias"][None, None])
    a = torch.exp(params["a_log"])  # (h,) positive rates
    from torch.distributed.tensor import DTensor

    xh = xin.reshape(b, s, h, p)
    scan = _scan_on_local_blocks if isinstance(xh, DTensor) else ssd_scan
    y, state = scan(xh, dt, a, bmat, cmat, cfg.ssm_chunk,
                    init_state=init_state)
    y = y + params["d_skip"][None, None, :, None] * xh.to(F32)
    y = y.reshape(b, s, di).to(x.dtype)
    return _out_proj(params, y, z, x), (state, conv_tail)


def ssd_decode(params, x, cache, cfg):
    """One-token decode.  x: (b, 1, d); cache = (state, conv_tail),
    updated in place and returned."""
    state, conv_tail = cache
    b = x.shape[0]
    di, h, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z, xin, bmat, cmat, dt_raw, conv_tail = _in_proj(params, x, cfg,
                                                     conv_tail)
    dt = _softplus(dt_raw.to(F32) + params["dt_bias"][None, None])[:, 0]
    a = torch.exp(params["a_log"])
    dec = torch.exp(-a[None] * dt)  # (b, h)
    xh = xin[:, 0].reshape(b, h, p).to(F32)
    xdt = xh * dt[..., None]
    state = state * dec[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", bmat[:, 0].to(F32), xdt)
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].to(F32), state)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype)
    cache[0].copy_(state)
    cache[1].copy_(conv_tail)
    return _out_proj(params, y, z, x), cache


def init_ssd_cache(cfg, batch: int, dtype, device=None):
    return (torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=F32, device=device),
            torch.zeros((batch, cfg.conv_width - 1,
                         cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                        device=device))
