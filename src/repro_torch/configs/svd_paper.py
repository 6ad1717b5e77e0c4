"""The paper's own experimental matrices (Tables 3 and 8), synthesized.

Port of ``repro/configs/svd_paper.py``.  Each UF-collection matrix is
matched by a dense synthetic one with the same dimension and 2-norm
condition number: a geometric singular-value spectrum and Haar-random
singular vectors (QR of Gaussian matrices).

Two deliberate differences from the reference:

* The seed is derived stably, ``seed + zlib.crc32(name) % 2**16``.  The
  reference uses ``hash(name)``, which Python salts per process
  (``PYTHONHASHSEED``), so its paper matrices differ from run to run.
* The matrix is built with torch on a given device from a
  ``torch.Generator`` (host numpy QR of two 12k x 12k matrices takes
  minutes), and the exact singular values are returned beside it, so a
  check needs no oracle SVD.  Generators on different devices draw
  different numbers: the matrix is reproducible per device type.
"""

from __future__ import annotations

import dataclasses
import math
import zlib

import torch

from repro_torch.solver.planner import resolve_device


@dataclasses.dataclass(frozen=True)
class SvdMatrixConfig:
    name: str
    n: int
    cond: float
    cpu_n: int  # reduced size for CPU runs
    r_paper: int  # the paper's r choice (Table 3) or 2 (Tables 8/9)


# Table 3 (Example 1) + Table 8 (Example 3).
MATRICES = {
    "nemeth03": SvdMatrixConfig("nemeth03", 9_506, 1.29e0, 768, 2),
    "fv1": SvdMatrixConfig("fv1", 9_604, 1.40e1, 768, 3),
    "linverse": SvdMatrixConfig("linverse", 11_999, 9.06e3, 768, 4),
    "bcsstk18": SvdMatrixConfig("bcsstk18", 11_948, 3.46e11, 768, 2),
    "c-47": SvdMatrixConfig("c-47", 15_343, 3.16e8, 768, 2),
    "c-49": SvdMatrixConfig("c-49", 21_132, 6.02e8, 768, 2),
    "cvxbqp1": SvdMatrixConfig("cvxbqp1", 50_000, 1.09e11, 768, 2),
    "rand1": SvdMatrixConfig("rand1", 10_000, 3.97e7, 768, 2),
    "rand2": SvdMatrixConfig("rand2", 30_000, 1.24e7, 768, 2),
}


# Structured-QR benchmark shapes (paper Table 2).
QR_SHAPES = [(10_000, 5_000), (20_000, 10_000)]
QR_CPU_SHAPES = [(1_536, 768), (3_072, 1_536)]


def matrix_seed(name: str, seed: int = 0) -> int:
    """Process-independent generator seed for a paper matrix."""
    return seed + zlib.crc32(name.encode()) % (2 ** 16)


def synthesize(name: str, *, cpu_size: bool = True, n=None,
               dtype: torch.dtype = torch.float64, seed: int = 0,
               device=None, cond=None):
    """Dense synthetic stand-in with matched n (or cpu_n) and kappa_2.

    Returns ``(a, s)``: ``a`` (n, n) in ``dtype`` on ``device`` (the CUDA
    card when None) and its exact singular values ``s`` (float64,
    descending).  The matrix is formed in float64 and then cast.  ``n``
    overrides the size (the condition number stays the paper's);
    ``cond`` overrides the condition number (the same singular vectors,
    a geometric spectrum from 1 down to 1/cond)."""
    if name not in MATRICES:
        raise ValueError(f"unknown paper matrix {name!r}; known: "
                         f"{sorted(MATRICES)}")
    cfg = MATRICES[name]
    if n is None:
        n = cfg.cpu_n if cpu_size else cfg.n
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(matrix_seed(name, seed))
    f64 = torch.float64
    cond = cfg.cond if cond is None else float(cond)
    s = torch.logspace(0.0, -math.log10(cond), n, dtype=f64,
                       device=dev)
    u, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=f64,
                                       device=dev))
    v, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=f64,
                                       device=dev))
    a = (u * s) @ v.mT
    return a.to(dtype), s
