"""K5's blocked Cholesky on the CPU, and the route that picks it.

The plain version (``kernels.ref.cholesky_ref``) is K5's algorithm step
for step: for each outer step of ``depth`` columns, the strip updates of
its diagonal blocks, their unblocked factors, the panels' forward
substitutions, then the trailing update.  It is held against
``torch.linalg.cholesky`` in f64 at ragged n around a small block (8), so
every edge of the blocking is reached in a few milliseconds; tolerance
1e-12 of max|L| (f64, another summation order).  ``core.linalg.cholesky``
takes the route by shape (``kernels.cholesky.cholesky_route``) and names
it in its span; an indefinite entry comes out all-NaN on either route.
K5's route is the card's only: a CPU tensor keeps ``cholesky_ex``, and
the tests that drive the K5 route here let the CPU take it
(``K5_DEVICES``), where ``ops.cholesky`` runs the plain version.  The
kernel itself runs on the card only (``tests/test_torch_kernels.py``,
``-m gpu``)."""

import pytest
import torch

from repro_torch import obs
from repro_torch.core import linalg
from repro_torch.kernels import cholesky as kchol
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

NB = 8  # a small block: ragged n stays tiny


def _spd(b, n, dtype=torch.float64, seed=0):
    """b symmetric positive definite matrices, junk above the diagonal
    (only the lower triangle may be read)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, n, n), generator=g, dtype=torch.float64)
    z = x @ x.mT / max(n, 1) + 0.5 * torch.eye(n, dtype=torch.float64)
    return (torch.tril(z) + 7.0 * torch.triu(torch.ones_like(z), 1)).to(
        dtype)


@pytest.mark.parametrize("depth", [NB, 2 * NB, 3 * NB])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("n", [1, NB - 1, NB, NB + 1, 3 * NB + 5])
def test_plain_blocked_matches_cholesky(n, b, depth):
    z = _spd(b, n, seed=n)
    got, info = ref.cholesky_ref(z, block=NB, depth=depth)
    want = torch.linalg.cholesky(torch.tril(z) + torch.tril(z, -1).mT)
    assert info.shape == (b,) and info.dtype == torch.int32
    assert not info.any()
    assert got.shape == want.shape and got.stride() == want.stride()
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    err = (got - want).abs().max().item()
    assert err <= 1e-12 * want.abs().max().item()


@pytest.mark.parametrize("shape", [(5,), (2, 3), ()])
def test_plain_blocked_keeps_batch_shape_and_strides(shape):
    z = _spd(max(1, torch.Size(shape).numel()), 2 * NB + 3).reshape(
        shape + (2 * NB + 3,) * 2)
    got, info = ref.cholesky_ref(z, block=NB)
    want, winfo = torch.linalg.cholesky_ex(z)
    assert got.shape == want.shape and got.stride() == want.stride()
    assert info.shape == winfo.shape and info.dtype == winfo.dtype


@pytest.mark.parametrize("where", [0, NB - 1, NB, 2 * NB + 2])
def test_plain_blocked_info_names_the_first_bad_pivot(where):
    n = 3 * NB + 5
    z = _spd(4, n)
    z[2, where, where] = -1.0  # the leading minor of order where + 1
    _, info = ref.cholesky_ref(z, block=NB, depth=2 * NB)
    _, winfo = torch.linalg.cholesky_ex(torch.tril(z) +
                                        torch.tril(z, -1).mT)
    assert info.tolist() == [0, 0, where + 1, 0] == winfo.tolist()


@pytest.mark.parametrize("route", ["k5", "cusolver"])
def test_indefinite_entry_is_all_nan_and_others_intact(route, monkeypatch):
    # K5's route at a small n: the threshold lowered below it
    n = 3 * ref.CHOLESKY_BLOCK // 4
    if route == "k5":
        monkeypatch.setattr(kchol, "CHOLESKY_MIN_N", n)
        monkeypatch.setattr(kchol, "K5_DEVICES", ("cuda", "cpu"))
    z = _spd(4, n, dtype=torch.float32)
    z = torch.tril(z) + torch.tril(z, -1).mT
    z[1, 5, 5] = -3.0
    assert kchol.cholesky_route(z) == route
    got = linalg.cholesky(z.clone())
    want = torch.linalg.cholesky_ex(z.double())[0]
    assert torch.isnan(got[1]).all()
    ok = [0, 2, 3]
    assert torch.isfinite(got[ok]).all()
    err = (got[ok].double() - want[ok]).abs().max().item()
    assert err <= 1e-5 * want[ok].abs().max().item()


def test_route_by_shape(monkeypatch):
    n0 = kchol.CHOLESKY_MIN_N
    route = kchol.cholesky_route
    # the card's tensors only: a CPU stack of K5's shape keeps cholesky_ex
    assert kchol.K5_DEVICES == ("cuda",)
    assert route(torch.empty((2, n0, n0))) == "cusolver"
    assert route(torch.empty((4, n0, n0), device="meta")) == "cusolver"
    # the shape rules, with the CPU standing in for the card
    monkeypatch.setattr(kchol, "K5_DEVICES", ("cuda", "cpu"))
    assert route(torch.empty((4, n0, n0), device="meta")) == "cusolver"
    assert route(torch.empty((2, n0 - 1, n0 - 1))) == "cusolver"
    assert route(torch.empty((2, n0, n0))) == "k5"
    assert route(torch.empty((2, 3, n0 + 1, n0 + 1))) == "k5"
    # one matrix stays on cholesky_ex (cuSOLVER's single-matrix potrf)
    assert route(torch.empty((n0, n0))) == "cusolver"
    assert route(torch.empty((1, 1, n0, n0))) == "cusolver"
    assert route(torch.empty((0, n0, n0))) == "cusolver"
    assert route(torch.empty((2, n0, n0), dtype=torch.float64)) == "cusolver"
    assert route(torch.empty((2, n0, n0),
                             dtype=torch.bfloat16)) == "cusolver"
    # N0 keeps the top-k cell's 877-wide factorizations on cholesky_ex
    assert n0 > 877


@pytest.mark.parametrize("n,b,route", [("below", 2, "cusolver"),
                                        ("at", 2, "k5"),
                                        ("at", 1, "cusolver")])
def test_span_names_the_route(n, b, route, monkeypatch):
    # the CPU stands in for the card, so that the K5 route runs its plain
    # version
    monkeypatch.setattr(kchol, "K5_DEVICES", ("cuda", "cpu"))
    size = kchol.CHOLESKY_MIN_N - (1 if n == "below" else 0)
    z = torch.eye(size).expand(b, size, size) * 2.0
    before = kchol.launches
    obs.enable()
    try:
        got = linalg.cholesky(z)
    finally:
        obs.disable()
    rec = obs.take()
    assert [(name, w) for name, _, w in rec] == [
        ("linalg.cholesky", {"batch": b, "n": size, "route": route})]
    # the CPU runs K5's plain version: no launch
    assert kchol.launches == before
    assert torch.equal(got, torch.eye(size).expand(b, size, size)
                       * 2.0 ** 0.5)


def test_ops_and_wrapper_refuse_what_they_do_not_take():
    with pytest.raises(ValueError, match="device"):
        ops.cholesky(torch.empty((4, 4), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        kchol.cholesky_kernel_call(torch.eye(4))
    assert kchol.cholesky_plain is ref.cholesky_ref
    assert kchol.CHOLESKY_DEPTH % ref.CHOLESKY_BLOCK == 0


def test_cpu_keeps_cholesky_ex():
    # a CPU stack of the dense solve's kind (f32, batch 4, n >= N0) is
    # factored by LAPACK, bit for bit what cholesky_ex gives, and so named
    size = kchol.CHOLESKY_MIN_N
    z = _spd(4, size, dtype=torch.float32)
    z = torch.tril(z) + torch.tril(z, -1).mT
    obs.enable()
    try:
        got = linalg.cholesky(z)
    finally:
        obs.disable()
    assert [w["route"] for _, _, w in obs.take()] == ["cusolver"]
    assert torch.equal(got, torch.linalg.cholesky_ex(z)[0])


def test_kernel_source_constants_match_the_wrapper():
    # the wrapper sizes the panel workspace (batch x CHOLESKY_DEPTH x ldw)
    # for the kernel's kDepth; the plain version blocks by its kNB
    import re

    from repro_torch.kernels import build

    text = (build.CSRC / "cholesky.cu").read_text()
    nb = int(re.search(r"constexpr int kNB = (\d+);", text).group(1))
    mult = int(re.search(r"constexpr int kDepth = (\d+) \* kNB;",
                         text).group(1))
    assert nb == ref.CHOLESKY_BLOCK
    assert mult * nb == ref.CHOLESKY_DEPTH == kchol.CHOLESKY_DEPTH
