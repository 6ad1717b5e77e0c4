"""Symmetric eigensolvers for the H-factor stage (paper Alg. 2 step 2).

Port of ``repro/core/eig.py``.  The paper uses ELPA; the role is filled
by:

* :func:`eigh`              — ``torch.linalg.eigh`` (LAPACK / cuSOLVER),
                              NaN out for a non-finite input.
* :func:`block_jacobi_eigh` — two-sided block-Jacobi with a round-robin
                              (tournament) ordering: every round applies
                              b/2 *disjoint* block rotations, the
                              matmul-rich, loosely coupled member of the
                              family (ELPA's scalability role).

Differences from the reference, each deliberate:

* Its ``lax.while_loop`` over sweeps and ``lax.scan`` over rounds are
  host loops (one residual read per sweep), and the b/2 subproblems of
  a round are one batched ``torch.linalg.eigh``, as the reference's
  batched ``jnp.linalg.eigh``.
* Each round's rotations — the subproblems' ``eigh`` and the products
  with them — are computed in float64 whatever ``h``'s dtype; the
  updated rows, columns and vectors are stored back in it.  The
  reference computes them in ``h``'s dtype.  In f32 the rotations'
  orthogonality error accumulates over the rounds: on the linverse
  spectrum at n = 2,048 (``chip_smoke.py`` phase 13, an H100) f32
  rotations left the singular values 1.45e-3 off, beyond the f32
  limit of 1e-4.  For f64 input the arithmetic is the reference's.
  The plan audit's ``wide_ok("block-jacobi rotations")`` scope marks
  them (:mod:`repro_torch.analysis.plan_audit`).
* One sweep cap, :data:`MAX_SWEEPS` = 40, for the eigensolver and for
  :func:`repro_torch.core.svd.jacobi_svd`.  The reference's 12 and 16
  leave the linverse spectrum unconverged at n = 2,048 and return it
  without a signal (``chip_smoke.py`` phase 13 counts the sweeps each
  solver needs there).  The sweeps stop at the tolerance, so the cap
  adds sweeps only where the reference's would have returned
  unconverged.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.plan_audit import wide_ok

# the block-Jacobi sweep cap (module docstring)
MAX_SWEEPS = 40


def eigh(h: torch.Tensor):
    """(w ascending, v) with h v = v diag(w), like ``jnp.linalg.eigh``,
    and with its failure mode: a batch entry holding a non-finite value
    comes out all-NaN (``torch.linalg.eigh`` raises on it), so a broken
    solve returns NaN factors for its health check to catch.  No host
    sync: the entry is swapped for I before the solve and masked after."""
    bad = ~torch.isfinite(h).all(dim=-1).all(dim=-1)
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    w, v = torch.linalg.eigh(torch.where(bad[..., None, None], eye, h))
    return (w.masked_fill(bad[..., None], float("nan")),
            v.masked_fill(bad[..., None, None], float("nan")))


def round_robin_schedule(b: int) -> np.ndarray:
    """Tournament schedule: (b-1) rounds x (b/2) disjoint pairs covering
    all unordered pairs of {0..b-1}.  b must be even."""
    if b % 2 != 0:
        raise ValueError(f"tournament schedule needs an even block "
                         f"count; got b={b}")
    players = list(range(b))
    rounds = []
    for _ in range(b - 1):
        pairs = [(players[i], players[b - 1 - i]) for i in range(b // 2)]
        rounds.append([(min(p, q), max(p, q)) for p, q in pairs])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds)  # (b-1, b/2, 2)


def _offdiag_norm(h, nb: int):
    n = h.shape[-1]
    b = n // nb
    hb = h.reshape(b, nb, b, nb)
    mask = 1.0 - torch.eye(b, dtype=h.dtype, device=h.device)[:, None, :,
                                                             None]
    return torch.sqrt(torch.sum((hb * mask) ** 2))


def _pair_columns(b: int, nb: int, device) -> torch.Tensor:
    """(rounds, b/2, 2 nb) column ids of each round's block pairs: block
    p's nb columns, then block q's."""
    sched = torch.as_tensor(round_robin_schedule(b), device=device)
    ar = torch.arange(nb, device=device)
    return torch.cat([sched[..., 0:1] * nb + ar,
                      sched[..., 1:2] * nb + ar], dim=-1)


def block_jacobi_eigh(h, nb: int = 32, max_sweeps: int = MAX_SWEEPS,
                      tol=None):
    """Two-sided block-Jacobi eigendecomposition of symmetric ``h``.

    Returns (w, v) with ``h @ v = v * w`` (ascending), like
    ``torch.linalg.eigh``.  ``n`` must be divisible by ``nb`` and
    ``n // nb`` must be even (:func:`padded_block_jacobi_eigh` pads).
    Sweeps stop when the off-block-diagonal norm, relative to ||h||_F,
    is at most ``tol`` (default 30 eps) or after ``max_sweeps``."""
    n = h.shape[-1]
    dtype = h.dtype
    if n % nb != 0 or (n // nb) % 2 != 0:
        raise ValueError(
            f"block_jacobi_eigh needs n divisible by nb with an even "
            f"block count; got n={n}, nb={nb} — use "
            f"padded_block_jacobi_eigh for arbitrary n")
    ids = _pair_columns(n // nb, nb, h.device)
    tol = tol if tol is not None else 30 * torch.finfo(dtype).eps
    hi = torch.float64  # the rotations' precision (module docstring)
    tiny = torch.finfo(dtype).tiny
    h = h.clone()
    v = torch.eye(n, dtype=dtype, device=h.device)
    sweeps, off = 0, 1.0
    while sweeps < max_sweeps and off > tol:  # NaN stops
        for row_ids in ids:
            flat = row_ids.reshape(-1)
            rows = h[flat].reshape(-1, 2 * nb, n)
            # subproblem S_i = rows_i[:, row_ids_i]
            sub = torch.take_along_dim(
                rows, row_ids[:, None, :].expand(-1, 2 * nb, -1), dim=2)
            sub = 0.5 * (sub + sub.mT)
            with wide_ok("block-jacobi rotations"):
                _, j = torch.linalg.eigh(sub.to(hi))  # (npairs, 2nb, 2nb)
                # row phase: rows <- J^T rows
                h[flat] = (j.mT @ rows.to(hi)).to(dtype).reshape(-1, n)
                # column phase: cols <- cols J
                cols = h[:, flat].reshape(n, -1, 2 * nb).transpose(0, 1)
                h[:, flat] = (cols.to(hi) @ j).to(dtype).transpose(
                    0, 1).reshape(n, -1)
                # accumulate eigenvectors: V <- V J
                vcols = v[:, flat].reshape(n, -1, 2 * nb).transpose(0, 1)
                v[:, flat] = (vcols.to(hi) @ j).to(dtype).transpose(
                    0, 1).reshape(n, -1)
        sweeps += 1
        off = float(_offdiag_norm(h, nb) / torch.clamp(
            torch.sqrt(torch.sum(h * h)), min=tiny))
    w = torch.diagonal(h)
    order = torch.argsort(w, stable=True)
    return w[order], v[:, order]


def padded_block_jacobi_eigh(h, nb: int = 32,
                             max_sweeps: int = MAX_SWEEPS):
    """:func:`block_jacobi_eigh` with automatic padding to an even
    multiple of ``nb``."""
    n = h.shape[-1]
    b = -(-n // nb)
    if b % 2:
        b += 1
    npad = b * nb - n
    if npad:
        # pad with an identity corner scaled beyond the spectrum so the
        # padding eigenpairs separate cleanly and are dropped afterwards
        big = 2.0 * torch.amax(torch.abs(h)) * n + 1.0
        hp = h.new_zeros((n + npad, n + npad))
        hp[:n, :n] = h
        idx = torch.arange(n, n + npad, device=h.device)
        hp[idx, idx] = big
        w, v = block_jacobi_eigh(hp, nb=nb, max_sweeps=max_sweeps)
        return w[:n], v[:n, :n]
    return block_jacobi_eigh(h, nb=nb, max_sweeps=max_sweeps)
