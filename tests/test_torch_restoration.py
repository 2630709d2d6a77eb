"""The port's ``ops/restoration.py`` (av1_wiener_convolve_add_src_c and the
self-guided filter, the two loop-restoration filters) against the
reference module on the same seeded inputs; the golden LR streams of
``tests/test_torch_decoder.py`` hold them against aomdec.
Tolerance: exact equality."""
import numpy as np
import pytest

from aom_av1_psy_tpu.ops import restoration as RR
from aom_av1_psy_tpu_torch.ops import restoration as R


@pytest.mark.parametrize("bd", [8, 10])
def test_wiener_equals_the_reference(bd):
    rng = np.random.default_rng(bd)
    for h, w in [(4, 16), (16, 32), (7, 13)]:
        src = rng.integers(0, 1 << bd, (h + 6, w + 6))
        for _ in range(4):
            t = [int(v) for v in rng.integers(-20, 40, 3)]
            f = t + [-2 * sum(t)] + t[::-1] + [0]
            g = [0] + [int(v) for v in rng.integers(-20, 40, 2)]
            g = g + [-2 * sum(g)] + g[::-1] + [0]
            np.testing.assert_array_equal(
                R.wiener_convolve(src, f, g, bd),
                RR.wiener_convolve(src, f, g, bd))


@pytest.mark.parametrize("eps", range(16))
def test_sgr_equals_the_reference(eps):
    rng = np.random.default_rng(eps)
    src = rng.integers(0, 256, (16 + 6, 24 + 6))
    xqd = [int(rng.integers(-96, 32)), int(rng.integers(-32, 96))]
    got = R.apply_sgr(src, eps, xqd)
    np.testing.assert_array_equal(got, RR.apply_sgr(src, eps, xqd))
    assert R.decode_xq(xqd, eps) == RR.decode_xq(xqd, eps)
