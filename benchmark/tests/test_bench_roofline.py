"""The yardstick's arithmetic equals ``chip_smoke.py``'s at the smoke's
shapes, and counts the launches of an untiled KEY frame."""
import sys

import pytest

from _tiny import ROOT

sys.path.insert(0, ROOT)


@pytest.mark.parametrize("B,bs,npl,K", [(34, 32, 1, 61), (34, 16, 1, 61),
                                        (34, 16, 2, 7), (135, 4, 2, 7)])
def test_pick_matches_the_smoke(B, bs, npl, K):
    import chip_smoke as S
    from benchmark.harness import roofline as R
    assert R.pick_bytes(B, bs, npl, K) == S._pick_bytes(B, bs, npl, K)
    ops = 7 * K * npl * B * bs * bs
    assert R.pick_ops(B, bs, npl, K) == ops
    assert R.bound(R.pick_bytes(B, bs, npl, K), ops) == \
        S.bound(S._pick_bytes(B, bs, npl, K), ops)


@pytest.mark.parametrize("B,bs,npl,w", [(34, 32, 1, 0), (270, 4, 2, 0),
                                        (34, 16, 1, 18)])
def test_step_matches_the_smoke(B, bs, npl, w):
    import chip_smoke as S
    from benchmark.harness import roofline as R
    assert R.step_bytes(B, bs, npl, w) == S._step_bytes(B, bs, npl, w)
    assert R.txq_ops(B, bs) == S._txq_ops(B, bs)
    assert R.bound(1e9, 1e12, 1e10) == S.bound(1e9, 1e12, 1e10)


@pytest.mark.parametrize("w,h,steps,total", [(1920, 1080, 186, 1863),
                                             (3840, 2160, 374, 3743),
                                             (1280, 720, 124, 1243)])
def test_key_launches(w, h, steps, total):
    from benchmark.harness import roofline as R
    n = R.key_launches(w, h)
    assert n["steps"] == steps and n["total"] == total
    assert n["KA"] == n["KB"] == 5 * steps


def test_ka_frame_bound():
    """The sum over both wavefronts' picks of the smoke's bound: luma one
    32 and four 16 quads at K = 61, chroma (U and V) one 16 and four 8
    quads at K = 7, on every diagonal of the 34 x 60 cells of 1080p."""
    import chip_smoke as S
    from benchmark.harness import roofline as R
    assert R.plan_grid(1920, 1080) == (34, 60)
    want = 0.0
    for d in range(34 + 60 - 1):
        B = len(range(max(0, d - 59), min(33, d) + 1))
        for bs, npl, K, calls in ((32, 1, 61, 1), (16, 1, 61, 4),
                                  (16, 2, 7, 1), (8, 2, 7, 4)):
            want += calls * S.bound(S._pick_bytes(B, bs, npl, K),
                                    7 * K * npl * B * bs * bs)["bound_ms"]
    assert R.ka_frame_bound_s(1920, 1080) == pytest.approx(want / 1e3,
                                                           rel=1e-12)
