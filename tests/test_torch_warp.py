"""The port's ``ops/warp.py`` (warped motion: av1_warp_affine_c, the shear
parameters and the least-squares model fit) against the golden cases of
the reference's ``tests/test_warp.py`` and against the reference module on
the same inputs.
Tolerance: exact equality."""
import os

import numpy as np
import pytest

from aom_av1_psy_tpu.normative import mvref as RMR
from aom_av1_psy_tpu.ops import warp as RW
from aom_av1_psy_tpu_torch.normative import mvref as MR
from aom_av1_psy_tpu_torch.ops import warp as W

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_warp.npz")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def test_warp_affine_all(golden):
    n = 0
    while f"w{n}_out" in golden:
        mat = golden[f"w{n}_mat"].astype(np.int64)
        alpha, beta, gamma, delta, p_col, p_row, ss, round0 = \
            (int(v) for v in golden[f"w{n}_misc"])
        ref = golden[f"w{n}_ref"].astype(np.int64)
        want = golden[f"w{n}_out"].astype(np.int64)
        ph, pw = want.shape
        args = (mat, ref, p_col, p_row, pw, ph, ss, ss, alpha, beta, gamma,
                delta)
        got = W.warp_affine(*args, round0=round0)
        np.testing.assert_array_equal(got, want, err_msg=f"case {n}")
        np.testing.assert_array_equal(
            got, RW.warp_affine(*args, round0=round0), err_msg=f"case {n}")
        n += 1
    assert n == 24


def _models(seed, n):
    """Affine models near the identity (most warpable, some not)."""
    rng = np.random.default_rng(seed)
    one = 1 << W.WARPEDMODEL_PREC_BITS
    for _ in range(n):
        d = rng.integers(-one // 6, one // 6, 4)
        yield [int(v) for v in rng.integers(-1 << 20, 1 << 20, 2)] + \
            [one + int(d[0]), int(d[1]), int(d[2]), one + int(d[3])]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shear_params_equal_the_reference(seed):
    outcomes = set()
    for mat in _models(seed, 300):
        a, b = MR.WarpModel(), RMR.WarpModel()
        a.wmmat, b.wmmat = list(mat), list(mat)
        ok = W.get_shear_params(a)
        assert ok == RW.get_shear_params(b), mat
        assert (a.alpha, a.beta, a.gamma, a.delta) == \
            (b.alpha, b.beta, b.gamma, b.delta), mat
        outcomes.add(ok)
    assert outcomes == {True, False}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_projection_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        bw, bh = (int(v) for v in rng.choice([8, 16, 32, 64], 2))
        ns = int(rng.integers(1, 9))
        pts = [[int(v) for v in rng.integers(-64, 64 + 8 * bw, 2)]
               for _ in range(ns)]
        mv = [int(v) for v in rng.integers(-64, 64, 2)]
        pts_inref = [[p[0] + mv[1] + int(rng.integers(-12, 13)),
                      p[1] + mv[0] + int(rng.integers(-12, 13))]
                     for p in pts]
        mi_row, mi_col = (int(v) for v in rng.integers(0, 64, 2))
        a, b = MR.WarpModel(), RMR.WarpModel()
        got = W.find_projection(ns, pts, pts_inref, bw, bh, mv, a, mi_row,
                                mi_col)
        want = RW.find_projection(ns, pts, pts_inref, bw, bh, mv, b, mi_row,
                                  mi_col)
        assert got == want
        assert a.wmmat == b.wmmat
        m = MR.select_samples(mv, pts, pts_inref, 4)
        assert m == RMR.select_samples(mv, pts, pts_inref, 4)
