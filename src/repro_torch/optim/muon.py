"""ZoloMuon: Muon-style orthogonalized momentum with Zolo-PD msign.

Port of ``repro/optim/muon.py``.  Muon replaces the elementwise Adam
update for 2-D weights with the orthogonal (polar) factor of the
momentum matrix:

    M_t = beta M_{t-1} + G_t
    W  -= lr * 0.2 sqrt(max(m, n)) * polar_factor(M_t)

The polar factor is the paper's Zolo-PD with a static plan-time schedule
(r = 2, shifted-CholeskyQR2 first iteration, shared-Gram Cholesky after),
through one cached :class:`repro_torch.solver.SvdPlan` per parameter
*kind* (shape, dtype, config, device).  ``method`` selects {"zolo",
"qdwh", "ns5"} so the paper's baselines also run inside the training
loop.

The Zolo backend is ``zolo_cuda`` — the same static schedule with the
iteration's Gram products on K1 and its r-term combine on K2 — when the
polar dtype's itemsize is <= 4, and ``zolo_static`` (torch ops) for f64,
which the kernels (f32 accumulation) do not take.  The reference names
``zolo_static`` (plain ``jnp``); on a CPU iterate ``zolo_cuda`` runs the
kernels' plain versions, and on the card the kernels, never the plain
version.

Muon applies to leaves with trailing 2-D blocks of min dim >= 64 that are
not embeddings / vocab projections (path rule); everything else (norms,
biases, embed, lm_head) gets AdamW.  Stacked leading axes (layers) are
batched: one ``polar_batched`` per parameter kind per step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch

from repro_torch import tree as _tree
from repro_torch.dist.sharding import hint

F32 = torch.float32


class MuonConfig(NamedTuple):
    lr: float = 0.02
    beta: float = 0.95
    weight_decay: float = 0.0
    method: str = "zolo"  # zolo | qdwh | ns5
    r: int = 2
    l0: float = 1e-3
    max_iters: int = 4
    # dtype the momentum moves through the factorization in (the
    # factorization itself computes in f32)
    polar_dtype: str = "float32"
    # AdamW for non-matrix leaves
    adam_lr: float = 3e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    min_matrix_dim: int = 64


_NS5_COEFFS = (3.4445, -4.7750, 2.0315)


def _ns5(x, steps: int = 5):
    """Standard Muon Newton-Schulz quintic iteration (baseline)."""
    a, b, c = _NS5_COEFFS
    x = x / (torch.linalg.matrix_norm(x, keepdim=True) + 1e-7)
    transpose = x.shape[-2] > x.shape[-1]
    if transpose:
        x = x.mT
    for _ in range(steps):
        g = x @ x.mT
        bx = b * x + c * (g @ x)
        x = a * x + g @ bx
    if transpose:
        x = x.mT
    return x


def polar_method(method: str, polar_dtype: str, device=None) -> str:
    """The solver backend of ``method`` at ``polar_dtype``: the kernel
    form of the static Zolo schedule for itemsize <= 4, the torch-op form
    for f64 and on the meta device (an abstract run, whose shapes are the
    kernels'); ``qdwh_static`` for "qdwh"."""
    if method == "qdwh":
        return "qdwh_static"
    if method != "zolo":
        raise ValueError(f"no polar plan for method {method!r}")
    itemsize = getattr(torch, polar_dtype).itemsize
    meta = device is not None and torch.device(device).type == "meta"
    return "zolo_cuda" if itemsize <= 4 and not meta else "zolo_static"


@functools.lru_cache(maxsize=None)
def _polar_plan(method: str, rows: int, cols: int, r: int, l0: float,
                max_iters: int, polar_dtype: str, device: str):
    """One cached SvdPlan per parameter *kind* (shape, dtype, config,
    device).

    ``scale="power"`` is the sharp 1.05x power-iteration normalization
    that keeps the spectrum inside [l0, 1] so the static schedule's
    iteration count is honest; ``compute_dtype="float32"`` factorizes in
    f32 and casts back to ``polar_dtype``.  The cache pins the plan per
    kind whatever the pressure on the solver's own LRU, so every step
    after the first reuses one schedule."""
    from repro_torch import solver as _solver

    backend = polar_method(method, polar_dtype, device)
    if method == "zolo":
        cfg = _solver.SvdConfig(method=backend, r=r, l0=l0,
                                max_iters=max_iters, qr_mode="cholqr2",
                                qr_iters=1, scale="power",
                                compute_dtype="float32")
    else:
        cfg = _solver.SvdConfig(method=backend, l0=l0,
                                max_iters=max_iters + 2, scale="power",
                                compute_dtype="float32")
    return _solver.plan(cfg, (rows, cols), getattr(torch, polar_dtype),
                        device=device)


def _polar_sharded(plan, m2):
    """Q of a DTensor stack (s, rows, cols), solved on this rank's local
    blocks, since the engine takes plain tensors.  Q comes back a DTensor
    on the placements it was solved on.

    The stack keeps its sharding (each rank solves its slice: no
    collective), and so does the long dimension over "data" (the
    ("opt_stack", "opt_rows") placement of the hints) for a static Zolo
    plan; any other sharding is gathered first.  Where the long dimension
    is split over "data",
    every rank holds a block of it and the plan's row-split path reduces
    the prescale and each Gram over the "data" group (K1 on the block,
    one all-reduce of the (n, n) Gram, K2 row-local).  Where it is not (a
    one-rank "data" axis), the block is the whole matrix and the solve is
    the unsharded one."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = m2.device_mesh
    names = list(mesh.mesh_dim_names)
    long_dim = 1 if m2.shape[1] >= m2.shape[2] else 2
    rows_ok = plan.method in ("zolo_static", "zolo_cuda")
    target = [p if p.is_shard(0) or (rows_ok and p.is_shard(long_dim)
                                     and n == "data")
              else Replicate() for n, p in zip(names, m2.placements)]
    if target != list(m2.placements):
        m2 = m2.redistribute(mesh, target)
    local = m2.to_local()
    data_dim = names.index("data") if "data" in names else None
    split = data_dim is not None and target[data_dim].is_shard(long_dim)
    if local.shape[0] == 0:
        q = local.clone()
    elif split:
        q = plan._polar_rows_batched(local, group=mesh.get_group(data_dim),
                                     index=mesh.get_local_rank(data_dim))
    else:
        q, _, _ = plan.polar_batched(local, want_h=False)
    return DTensor.from_local(q, mesh, m2.placements, run_check=False,
                              shape=m2.shape, stride=m2.stride())


def orthogonalize(m, method: str = "zolo", r: int = 2, l0: float = 1e-3,
                  max_iters: int = 4, polar_dtype: str = "float32"):
    """Batched msign/polar factor of m (..., rows, cols), on m's device.

    Under :func:`repro_torch.dist.activation_hints` the stack is placed
    as the reference places it (``repro/optim/muon.py:125-140``): stack
    over "opt_stack", the long dimension over "opt_rows", and the factor
    comes back a DTensor on those placements."""
    from torch.distributed.tensor import DTensor

    if method == "ns5":
        return _ns5(m)
    lead = m.shape[:-2]
    rows, cols = m.shape[-2:]
    m2 = m.reshape((-1, rows, cols)).to(getattr(torch, polar_dtype))
    # stack over "model" (expert/layer-major), long dim over "data": the
    # Gram contracts over the sharded rows (one all-reduce of (n, n)),
    # the triangular solves are row-local, only the small Cholesky
    # replicates
    axes = ("opt_stack", "opt_rows", None) if rows >= cols else \
        ("opt_stack", None, "opt_rows")
    m2 = hint(m2, *axes)
    plan = _polar_plan(method, rows, cols, r, l0, max_iters, polar_dtype,
                       str(m2.device))
    if isinstance(m2, DTensor):
        q = _polar_sharded(plan, m2)
    else:
        q, _, _ = plan.polar_batched(m2, want_h=False)
    q = hint(q, *axes)
    return q.reshape(lead + (rows, cols)).to(m.dtype)


def muon_labels(params, min_dim: int = 64):
    """True -> Muon, False -> AdamW; mirrors params exactly."""

    def f(name, leaf):
        keys = name.split("/")
        if "embed" in keys or "lm_head" in keys:
            return False
        return leaf.ndim >= 2 and min(leaf.shape[-2:]) >= min_dim

    return _tree.map_with_names(f, params)


def _scalar_zero(like, dtype=F32):
    """A 0-d zero on ``like``'s device, replicated on its mesh when
    ``like`` is a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor import zeros as dt_zeros

    if isinstance(like, DTensor):
        mesh = like.device_mesh
        return dt_zeros((), dtype=dtype, device_mesh=mesh,
                        placements=[Replicate()] * mesh.ndim)
    return torch.zeros((), dtype=dtype, device=like.device)


def _on_placements(o, p):
    """``o`` moved onto ``p``'s placements when both are DTensors (the
    factor comes back on the optimizer's reshard)."""
    from torch.distributed.tensor import DTensor

    if isinstance(o, DTensor) and isinstance(p, DTensor) and \
            tuple(o.placements) != tuple(p.placements):
        return o.redistribute(p.device_mesh, p.placements)
    return o


@dataclasses.dataclass
class ZoloMuon:
    """Optimizer over a params tree: Muon (Zolo-PD) for matrices, AdamW
    for the rest.  Functional, as the reference: ``update`` returns new
    tensors and leaves its inputs untouched."""

    cfg: MuonConfig
    labels: Any  # bool tree matching params (muon_labels)

    def init(self, params):
        """Zeroed state on the parameters' devices; a DTensor parameter's
        moments carry its placements, and a Muon leaf's scalar
        placeholder is replicated on its mesh (``state_axes_for_params``
        gives it "REPLICATED")."""
        flags = _tree.leaves(self.labels)
        p_leaves, tdef = _tree.flatten(params)
        mu = _tree.unflatten(tdef, [torch.zeros_like(p, dtype=F32)
                                    for p in p_leaves])
        # second moment only for Adam leaves (Muon leaves keep a scalar
        # placeholder to avoid doubling optimizer memory)
        nu = _tree.unflatten(tdef, [
            _scalar_zero(p) if is_muon else torch.zeros_like(p, dtype=F32)
            for p, is_muon in zip(p_leaves, flags)])
        return {"mu": mu, "nu": nu, "count": _scalar_zero(p_leaves[0],
                                                          torch.int32)}

    @torch.no_grad()
    def update(self, grads, state, params, lr_scale=1.0):
        c = self.cfg
        count = state["count"] + 1
        bc1 = 1.0 - c.adam_b1 ** count.to(F32)
        bc2 = 1.0 - c.adam_b2 ** count.to(F32)

        p_leaves, tdef = _tree.flatten(params)
        g_leaves = _tree.leaves(grads)
        mu_leaves = _tree.leaves(state["mu"])
        nu_leaves = _tree.leaves(state["nu"])
        flags = _tree.leaves(self.labels)
        if not (len(p_leaves) == len(g_leaves) == len(flags)):
            raise ValueError(
                f"params/grads/labels trees disagree: "
                f"{len(p_leaves)} params, {len(g_leaves)} grads, "
                f"{len(flags)} labels — was the optimizer built for a "
                f"different model structure?")

        new_p, new_mu, new_nu = [], [], []
        for is_muon, p, g, mu, nu in zip(flags, p_leaves, g_leaves,
                                         mu_leaves, nu_leaves):
            g32 = g.to(F32)
            if is_muon:
                mu_n = c.beta * mu + g32
                o = _on_placements(
                    orthogonalize(mu_n, c.method, c.r, c.l0, c.max_iters,
                                  polar_dtype=c.polar_dtype), p)
                rows, cols = p.shape[-2:]
                scale = 0.2 * (max(rows, cols) ** 0.5)
                step = (c.lr * lr_scale) * scale * o
                if c.weight_decay:
                    step = step + (c.lr * lr_scale) * c.weight_decay \
                        * p.to(F32)
                nu_n = nu
            else:
                mu_n = c.adam_b1 * mu + (1 - c.adam_b1) * g32
                nu_n = c.adam_b2 * nu + (1 - c.adam_b2) * g32 * g32
                step = (c.adam_lr * lr_scale) * (mu_n / bc1) / (
                    torch.sqrt(nu_n / bc2) + c.adam_eps)
            new_p.append((p.to(F32) - step).to(p.dtype))
            new_mu.append(mu_n)
            new_nu.append(nu_n)

        return (_tree.unflatten(tdef, new_p),
                {"mu": _tree.unflatten(tdef, new_mu),
                 "nu": _tree.unflatten(tdef, new_nu),
                 "count": count})
