"""Carry the reference's solver state and model weights into the port.

An SVD solver has no weights: its state is the plan — the configuration,
the coefficient schedule and the power-iteration start vector of the
prescale, and for a top-k plan its random draws (the sketch's test
matrix, the SRHT's signs and columns, the d&c extraction probe).  These
helpers take that state as plain Python values and numpy arrays (what
``dataclasses.asdict`` of a reference ``SvdConfig`` and ``numpy.asarray``
of its arrays give), so the port and the JAX reference compute the same
thing on the same input.  A model's state is its params pytree:
:func:`model_params_from_numpy` takes the reference's (as numpy arrays)
into the port's nested dict of tensors, name for name, and
:func:`tree_to_numpy` goes back; :func:`caches_from_numpy` and
:func:`caches_to_numpy` do the same for a served model's decode caches.
Nothing of ``repro`` is imported here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.coeffs import ZoloIteration
from repro_torch.solver.config import SvdConfig
from repro_torch.solver.planner import SvdPlan
from repro_torch.spectral.topk import TopKPlan

# reference backend name -> its counterpart in the port
METHOD_NAMES = {"zolo_pallas": "zolo_cuda",
                "zolo_pallas_dynamic": "zolo_cuda_dynamic"}


def svd_config_from_dict(d: dict) -> SvdConfig:
    """An :class:`SvdConfig` from ``dataclasses.asdict`` of a reference
    ``SvdConfig``.  Reference-only method names map through
    :data:`METHOD_NAMES`; an unknown field raises."""
    fields = {f.name for f in dataclasses.fields(SvdConfig)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise ValueError(f"unknown SvdConfig fields {unknown}")
    kw = dict(d)
    kw["method"] = METHOD_NAMES.get(kw.get("method", "auto"),
                                    kw.get("method", "auto"))
    kw["extra"] = tuple(tuple(p) for p in kw.get("extra", ()))
    return SvdConfig(**kw)


def schedule_from_arrays(c, a, mhat, l_before, l_after) -> tuple:
    """A schedule (tuple of :class:`ZoloIteration`) from the reference's
    per-iteration arrays: ``c`` (iters, 2r), ``a`` (iters, r), ``mhat``,
    ``l_before``, ``l_after`` (iters,)."""
    c = np.asarray(c, np.float64)
    a = np.asarray(a, np.float64)
    mhat = np.asarray(mhat, np.float64).reshape(-1)
    l_before = np.asarray(l_before, np.float64).reshape(-1)
    l_after = np.asarray(l_after, np.float64).reshape(-1)
    iters = c.shape[0]
    if c.ndim != 2 or a.shape != (iters, c.shape[1] // 2) or \
            c.shape[1] % 2 or not (mhat.shape == l_before.shape
                                   == l_after.shape == (iters,)):
        raise ValueError(f"schedule arrays disagree: c {c.shape}, a "
                         f"{a.shape}, mhat {mhat.shape}, l_before "
                         f"{l_before.shape}, l_after {l_after.shape}")
    return tuple(ZoloIteration(tuple(float(v) for v in c[i]),
                               tuple(float(v) for v in a[i]),
                               float(mhat[i]), float(l_before[i]),
                               float(l_after[i]))
                 for i in range(iters))


def with_state(p: SvdPlan, *, schedule=None, start_vector=None) -> SvdPlan:
    """An uncached copy of plan ``p`` bound to the given state.

    ``schedule`` replaces the precomputed coefficient schedule (its order
    r must match the plan's); ``start_vector`` (numpy or tensor, length
    min(m, n)) becomes the prescale's power-iteration start vector."""
    kwargs = dict(p._backend_kwargs)
    if schedule is not None:
        schedule = tuple(schedule)
        if "schedule" not in kwargs:
            raise ValueError(f"{p.method!r} binds no schedule")
        if p.r is not None and any(it.r != p.r for it in schedule):
            raise ValueError(f"schedule order differs from the plan's "
                             f"r={p.r}")
        kwargs["schedule"] = schedule
    v0 = p.start_vector
    if start_vector is not None:
        v0 = torch.as_tensor(np.array(start_vector)).to(
            device=p.device, dtype=p.dtype)
        if v0.shape != (min(p.shape),):
            raise ValueError(f"start vector of shape {tuple(v0.shape)}; "
                             f"the plan needs ({min(p.shape)},)")
    return dataclasses.replace(p, _backend_kwargs=kwargs, start_vector=v0)


def with_draws(p: TopKPlan, **arrays) -> TopKPlan:
    """An uncached copy of top-k plan ``p`` bound to the given random
    draws (numpy arrays or tensors), in place of the ones it would draw
    from ``config.seed``.

    The names and shapes are those of ``p.draw()``: ``omega`` (n, l) for
    a Gaussian sketch, ``signs`` (n,) and ``cols`` (l,) for an SRHT one,
    ``probe`` (n, l) for d&c, with n = min(shape) — each in the
    canonical orientation, as the reference draws them.  ``cols`` are
    integer column indices; the rest take the plan dtype."""
    want = {name: tuple(t.shape) for name, t in p.draw().items()}
    if set(arrays) != set(want):
        raise ValueError(f"{p.strategy!r} plan draws {sorted(want)}; got "
                         f"{sorted(arrays)}")
    draws = {}
    for name, value in arrays.items():
        t = torch.as_tensor(np.array(value), device=p.device)
        t = t.long() if name == "cols" else t.to(p.dtype)
        if tuple(t.shape) != want[name]:
            raise ValueError(f"draw {name!r} of shape {tuple(t.shape)}; "
                             f"the plan needs {want[name]}")
        draws[name] = t
    return dataclasses.replace(p, draws=draws)


def _mixer_layout(kind: str, cfg) -> dict:
    """{leaf name: shape} of one mixer's parameters (no stacked axis)."""
    d = cfg.d_model
    if kind == "attn":
        out = {"wq": (d, cfg.q_dim), "wk": (d, cfg.kv_dim),
               "wv": (d, cfg.kv_dim), "wo": (cfg.q_dim, d)}
        if cfg.qk_norm:
            out["q_scale"] = out["k_scale"] = (cfg.head_dim,)
        return out
    if kind == "rglru":
        dr = cfg.rnn_width
        return {"in_x": (d, dr), "in_gate": (d, dr),
                "conv_w": (cfg.conv_width, dr), "w_a": (dr, dr),
                "w_i": (dr, dr), "lam": (dr,), "out_proj": (dr, d)}
    if kind == "ssd":
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        return {"in_proj": (d, 2 * di + 2 * n + h),
                "conv_w": (cfg.conv_width, di + 2 * n), "a_log": (h,),
                "d_skip": (h,), "dt_bias": (h,), "norm_scale": (di,),
                "out_proj": (di, d)}
    raise ValueError(kind)


def _mlp_layout(cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.num_experts:
        e = cfg.num_experts
        return {"router": (d, e), "wi_gate": (e, d, ff),
                "wi_up": (e, d, ff), "wo": (e, ff, d)}
    ins = ("wi_gate", "wi_up") if cfg.mlp_type == "swiglu" else ("wi",)
    return dict({w: (d, ff) for w in ins}, wo=(ff, d))


def _params_layout(cfg) -> dict:
    """{leaf name: shape} of ``repro.models.model.init_params(cfg, ...)``
    (the port's layout is the same)."""
    d, v, ns = cfg.d_model, cfg.vocab_padded, cfg.num_stages
    norms = cfg.norm_type != "nonparam_ln"

    def layer(prefix, kind, lead):
        out = {}
        if norms:
            out["norm1"] = lead + (d,)
        out.update({f"mixer/{k}": lead + sh
                    for k, sh in _mixer_layout(kind, cfg).items()})
        if cfg.mlp_type != "none":
            if norms:
                out["norm2"] = lead + (d,)
            out.update({f"mlp/{k}": lead + sh
                        for k, sh in _mlp_layout(cfg).items()})
        return {f"{prefix}/{k}": s for k, s in out.items()}

    want = {"embed": (v, d)}
    if norms:
        want["final_norm"] = (d,)
    if not cfg.tie_embeddings:
        want["lm_head"] = (d, v)
    for j, kind in enumerate(cfg.block_pattern):
        want.update(layer(f"stages/{j}", kind, (ns,)))
    for i, kind in enumerate(cfg.remainder_blocks):
        want.update(layer(f"rem/{i}", kind, ()))
    return want


def _tensor(x) -> torch.Tensor:
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(arr)


def tree_from_numpy(tree, device="cpu", dtype=None):
    """A tree of numpy arrays (dicts, tuples, lists, None; bf16 as JAX
    hands it out) as the same tree of tensors on ``device`` (cast to
    ``dtype`` when given)."""
    from repro_torch import tree as _tree

    return _tree.map(lambda x: _tensor(x).to(device=device, dtype=dtype),
                     tree)


def tree_to_numpy(tree):
    """A tree of tensors as the same tree of numpy arrays (the form the
    reference's ``jax.tree.map(jnp.asarray, ...)`` takes); bf16 leaves
    come out as f32 (exact), numpy having no bf16."""
    from repro_torch import tree as _tree

    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _tree.map(host, tree)


def model_params_from_numpy(tree, cfg, device="cpu"):
    """The port's parameters from the reference's params pytree of
    ``cfg`` (``jax.tree.map(numpy.asarray, params)``), name for name and
    in the reference's dtypes; raises if a leaf is missing, extra or of
    another shape than the config's layout."""
    from repro_torch import tree as _tree

    params = tree_from_numpy(tree, device=device)
    names, leaves, _ = _tree.flatten_with_names(params)
    got = {n: tuple(t.shape) for n, t in zip(names, leaves)}
    want = _params_layout(cfg)
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"params tree does not match the {cfg.name!r} "
                         f"layout: {diff[:8]}")
    return params


def caches_from_numpy(tree, cfg, batch: int, max_len: int, device="cpu"):
    """The port's decode caches from the reference's (``jax.tree.map(
    numpy.asarray, caches)`` of ``init_caches``/``prefill``/
    ``decode_step``), leaf for leaf, in the layout of
    ``init_caches(cfg, batch, max_len)``; raises on another layout.
    bf16 leaves may come as bf16 or f32 (:func:`caches_to_numpy`'s
    form): each leaf takes the dtype ``init_caches`` gives it."""
    from repro_torch import tree as _tree
    from repro_torch.models import model as _model

    want = _model.init_caches(cfg, batch, max_len, device="meta")
    names, leaves, tdef = _tree.flatten_with_names(tree_from_numpy(tree))
    w_names, w_leaves, w_def = _tree.flatten_with_names(want)
    got = [(n, tuple(t.shape)) for n, t in zip(names, leaves)]
    need = [(n, tuple(t.shape)) for n, t in zip(w_names, w_leaves)]
    if got != need:
        diff = sorted(set(got) ^ set(need))
        raise ValueError(f"caches tree does not match the {cfg.name!r} "
                         f"layout at batch {batch}, max_len {max_len}: "
                         f"{diff[:8]}")
    return _tree.unflatten(w_def, [t.to(device=device, dtype=w.dtype)
                                   for t, w in zip(leaves, w_leaves)])


# the port's decode caches as the reference's tree of numpy arrays
caches_to_numpy = tree_to_numpy
