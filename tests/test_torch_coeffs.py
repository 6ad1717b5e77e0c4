"""repro_torch.core.coeffs against repro.core.coeffs: the same f64
numpy/scipy operations, so every schedule must agree exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.core import coeffs as ref  # noqa: E402
from repro_torch.core import coeffs as port  # noqa: E402

LS = [1e-12, 1e-8, 1e-4, 1e-2, 0.5, 0.9]
RS = list(range(1, 9))
KAPPAS = [1.5, 1e2, 9.06e3, 1e6, 1e10, 1e14]


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("l", LS)
def test_zolo_coeffs_np_exact(l, r):
    c0, a0, m0 = ref.zolo_coeffs_np(l, r)
    c1, a1, m1 = port.zolo_coeffs_np(l, r)
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_array_equal(a1, a0)
    assert m1 == m0
    assert port.zolo_l_update_np(l, c1, m1) == \
        ref.zolo_l_update_np(l, c0, m0)


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("l", LS)
def test_zolo_schedule_np_exact(l, r):
    s0 = ref.zolo_schedule_np(l, r)
    s1 = port.zolo_schedule_np(l, r)
    assert len(s1) == len(s0)
    for it0, it1 in zip(s0, s1):
        # ZoloIteration fields are python floats/tuples: == is bitwise
        assert (it1.c, it1.a, it1.mhat, it1.l_before, it1.l_after) == \
            (it0.c, it0.a, it0.mhat, it0.l_before, it0.l_after)
        assert it1.r == it0.r == r


@pytest.mark.parametrize("kappa", KAPPAS)
def test_iter_count_and_choose_r_exact(kappa):
    for r in RS:
        assert port.zolo_iter_count(kappa, r) == ref.zolo_iter_count(kappa, r)
    assert port.choose_r(kappa) == ref.choose_r(kappa)
    assert port.choose_r(kappa, max_groups=8) == \
        ref.choose_r(kappa, max_groups=8)
