"""The plain references against plain float64 answers at small sizes."""

from __future__ import annotations

import math
import pathlib
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import manifest as M  # noqa: E402
from harness.traffic import ring_order, ring_scale, row_signs  # noqa: E402

LIN = M.load_module("reference", "linverse-f32")
F64 = torch.float64


def test_synthesized_spectrum_is_exact():
    a, s, u, v = LIN.synthesize(96, 9.06e3, seed=7, dtype=F64, k=5)
    assert s[0] == 1.0 and s[-1] == pytest.approx(1 / 9.06e3, rel=1e-12)
    got = torch.linalg.svdvals(a)
    assert float((got - s).abs().max()) < 1e-13
    # the exact leading vectors: A v_i = s_i u_i
    assert u.shape == v.shape == (96, 5)
    assert float((a @ v - u * s[:5]).abs().max()) < 1e-13


def test_ring_members_share_the_spectrum_up_to_their_scale():
    mats = [LIN.synthesize(64, 9.06e3, seed=100 + j, scale=ring_scale(j),
                           dtype=F64)[:2]
            for j in range(3)]
    for j, (a, s) in enumerate(mats):
        assert torch.allclose(s, 2.0 ** j * mats[0][1], rtol=0, atol=0)
        assert float((torch.linalg.svdvals(a) - s).abs().max()) < 1e-12 * 2 ** j
    assert not torch.allclose(mats[0][0] * 2, mats[1][0])
    # every pass over the ring uses each member once, in a seeded order
    order = ring_order(2 ** 31 + 5, 3)
    passes = [sorted(next(order) for _ in range(3)) for _ in range(4)]
    assert passes == [[0, 1, 2]] * 4


def test_row_signs_keep_the_spectrum_and_turn_u():
    """Re-signing the rows, D A, is exact: same singular values, U turned
    into D U; every draw is a new vector of signs."""
    draws = row_signs(torch, 2 ** 33 + 1, 48, "cpu")
    d1, d2 = next(draws), next(draws)
    assert set(d1.tolist()) <= {-1.0, 1.0} and not d1.equal(d2)
    again = row_signs(torch, 2 ** 33 + 1, 48, "cpu")
    assert next(again).equal(d1)
    a, s_true, _, _ = LIN.synthesize(48, 9.06e3, seed=5)
    da = a * d1[:, None]
    assert (da * d1[:, None]).equal(a)
    u, s, vh = torch.linalg.svd(da.to(F64))
    nums = LIN.dense_numbers(a, s_true, u * d1[:, None].to(F64), s, vh)
    assert nums["residual"] < 1e-7 and nums["s_err"] < 1e-7
    assert LIN.dense_numbers(a, s_true, u, s, vh)["residual"] > 0.1


def test_dense_numbers_of_a_float64_svd():
    a, s_true, _, _ = LIN.synthesize(80, 9.06e3, seed=3)
    u, s, vh = torch.linalg.svd(a.to(F64))
    nums = LIN.dense_numbers(a, s_true, u, s, vh)
    assert nums["s_err"] < 1e-7 and nums["residual"] < 1e-12
    assert nums["orth_u"] < 1e-14 and nums["orth_v"] < 1e-14
    bad = LIN.dense_numbers(a, s_true, u, s.flip(0), vh)
    assert all(math.isinf(v) for v in bad.values())


def test_topk_numbers_of_a_float64_svd():
    a, s_true, ut, vt = LIN.synthesize(80, 9.06e3, seed=4, scale=2.0, k=8)
    u, s, vh = torch.linalg.svd(a.to(F64))
    nums = LIN.topk_numbers(a, s_true, ut, vt, u[:, :8], s[:8], vh[:8])
    assert nums["s_err"] < 1e-7 and nums["residual"] < 1e-7
    assert nums["orth"] < 1e-14
    assert nums["sin_u"] < 1e-7 and nums["sin_v"] < 1e-7


def test_topk_numbers_see_wrong_vectors():
    """Right values with a vector of the wrong triplet: the residual and
    the subspace angle see it; with V_k's last column swapped for the
    next one outside the leading k, the angle is 1."""
    a, s_true, ut, vt = LIN.synthesize(80, 9.06e3, seed=6, k=9)
    u, s, vh = (x.to(torch.float32) for x in torch.linalg.svd(a.to(F64)))
    swapped = vh[:8].clone()
    swapped[[0, 7]] = swapped[[7, 0]]
    nums = LIN.topk_numbers(a, s_true, ut, vt, u[:, :8], s[:8], swapped)
    assert nums["residual"] > 1e-3 and nums["sin_v"] < 1e-5
    outside = vh[:8].clone()
    outside[7] = vh[8]
    nums = LIN.topk_numbers(a, s_true, ut, vt, u[:, :8], s[:8], outside)
    assert nums["sin_v"] == pytest.approx(1.0, abs=1e-5)


def test_control_is_the_exact_answer_in_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0e-5])
    r = LIN.round_tf32(x)
    assert r.tolist()[:3] == [1.0, 1.0, 1.0 + 4 * 2 ** -11]
    assert abs(r[3] - x[3]) <= 2 ** -11 * abs(x[3])
    a, s_true, _, _ = LIN.synthesize(64, 9.06e3, seed=9)
    nums = LIN.dense_numbers(a, s_true, *LIN.control_answer(64, 9.06e3, 9))
    assert nums["s_err"] > 1e-4 and nums["residual"] > 1e-4
