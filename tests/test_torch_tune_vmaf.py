"""Port parity of ``encoder/tune_vmaf.py``'s pieces: the plain versions of
KG (``gaussian_blur``, with its int64 moments), KH (``unsharp``) and KI
(``vif_scale_sums``, ``down2``) against the JAX reference.

Tolerances: the blur, the moments, ``down2``, the sharpened planes, the
motion q model: exact. ``frame_preprocessing``'s amount: |port - reference|
<= 1e-5 (the port's hf is exact, the reference's a float32 ratio of two
float32 variances). ``motion_score``: relative 1e-6 (the reference's mean
is a float32 reduction, the port's exact). ``vif_lite``: relative 1e-4
(float32 sums in another order, and another ``log2``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from aom_av1_psy_tpu.encoder import tune_vmaf as JT
from aom_av1_psy_tpu_torch.encoder import tune_vmaf as TT
from test_tune_vmaf import _src
from tune_vmaf_cases import fma_cases
from torch_threads import one_torch_thread  # noqa: F401

VIF_RTOL = 1e-4


def _jblur(y):
    return np.asarray(JT.gaussian_blur(jnp.asarray(y, jnp.int32)))


def _servo_frames():
    """The three frames of test_tune_vmaf.py's servo test (sharp, blurry,
    textured) and bench's CIF KEY frame and a GOP frame."""
    y = _src()
    blurry = _jblur(y).astype(np.uint8)
    textured = np.random.default_rng(0).integers(0, 256, y.shape) \
        .astype(np.uint8)
    return {"sharp": y, "blurry": blurry, "textured": textured,
            "bench_cif_key": bench.make_frame(352, 288).planes()[0],
            "bench_cif_gop1": bench.make_gop(352, 288, 2)[1].planes()[0]}


SERVO = _servo_frames()


@pytest.mark.parametrize("h,w,kind", [(37, 53, "random"), (37, 53, "flat0"),
                                      (37, 53, "flat255"), (1, 5, "random"),
                                      (64, 96, "random"), (9, 40, "edges")])
def test_blur_matches_jax(h, w, kind):
    rng = np.random.default_rng(h * w)
    y = {"random": rng.integers(0, 256, (h, w)),
         "flat0": np.zeros((h, w)), "flat255": np.full((h, w), 255),
         "edges": np.where(np.arange(w)[None, :] % 7 < 3, 255,
                           0) + np.zeros((h, 1))}[kind].astype(np.uint8)
    want = _jblur(y)
    for t in (torch.as_tensor(y), torch.as_tensor(y.astype(np.int32))):
        got, mom = TT.gaussian_blur(t, moments=True)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        s = y.astype(np.int64)
        d = s - want
        assert mom.tolist() == [s.sum(), (s * s).sum(), d.sum(),
                                (d * d).sum()]


@pytest.mark.parametrize("name", sorted(SERVO))
def test_frame_preprocessing_matches_jax(name):
    y = SERVO[name]
    ja, js = JT.frame_preprocessing(y)
    ta, ts = TT.frame_preprocessing(y, device="cpu")
    assert abs(ta - ja) <= 1e-5, (ta, ja)
    assert (ta > 0) == (ja > 0)
    assert ts.dtype == np.uint8
    np.testing.assert_array_equal(ts, js)
    if name == "textured":
        assert ta == 0.0 and np.array_equal(ts, y)
    else:
        assert ta > 0 and (ts != y).any()


def test_unsharp_rounds_product_and_sum_separately():
    """On inputs where one rounding and two roundings of ``s + a*d`` floor
    differently, the reference's eager ``_unsharp`` takes the two, and so
    does the plain version of KH."""
    hits = fma_cases()
    assert len(hits) >= 32
    a = np.array([h[0] for h in hits], np.float32)
    src = np.array([[h[1] for h in hits]], np.int32)
    blur = src - np.array([[h[2] for h in hits]], np.int32)
    sep = [h[3] for h in hits]
    assert sep != [h[4] for h in hits]
    for i, ai in enumerate(a):
        want = np.asarray(JT._unsharp(jnp.asarray(src[:, i:i + 1]),
                                      jnp.asarray(blur[:, i:i + 1]),
                                      float(ai)))
        got = TT.unsharp_plain(torch.as_tensor(src[:, i:i + 1]
                                               .astype(np.uint8)),
                               torch.as_tensor(blur[:, i:i + 1]), float(ai))
        assert int(got[0, 0]) == int(want[0, 0]) == sep[i] != hits[i][4], \
            hits[i]


def test_unsharp_matches_jax_on_a_frame():
    y = SERVO["bench_cif_key"]
    b = _jblur(y)
    for a in (0.04742, 0.15279, 0.3):
        want = np.asarray(JT._unsharp(jnp.asarray(y, jnp.int32),
                                      jnp.asarray(b), a)).astype(np.uint8)
        got = TT.unsharp(torch.as_tensor(y), torch.as_tensor(b), a)
        np.testing.assert_array_equal(got.numpy(), want)


def test_motion_score_and_q_model_match_jax():
    frames = bench.make_gop(96, 64, 3)
    for a, b in ((0, 1), (1, 2), (0, 2), (1, 1)):
        cur, last = frames[a].planes()[0], frames[b].planes()[0]
        want = JT.motion_score(cur, last)
        got = TT.motion_score(cur, last, device="cpu")
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9)
    for motion in (0.0, 0.5, 3.0, 20.0):
        for q in (1, 60, 200, 255):
            for sse, dv in ((10.0, 1.0), (5e5, 2.0), (5e5, 0.001)):
                assert TT.vmaf_motion_dq(motion, q, sse, dv, 96 * 64) == \
                    JT.vmaf_motion_dq(motion, q, sse, dv, 96 * 64)


@pytest.mark.parametrize("name", ["sharp", "bench_cif_key"])
def test_vif_lite_within_tolerance(name):
    y = SERVO[name].astype(np.float32)
    b = _jblur(y).astype(np.float32)
    b2 = _jblur(b).astype(np.float32)
    got = []
    for d in (y, b, b2):
        want = float(JT.vif_lite(y, d))
        got.append(TT.vif_lite(y, d, device="cpu"))
        assert got[-1] == pytest.approx(want, rel=VIF_RTOL)
    assert got[0] == pytest.approx(1.0, abs=1e-6)
    assert got[0] > got[1] > got[2]


@pytest.mark.parametrize("h,w", [(37, 53), (144, 176), (8, 9)])
def test_down2_is_exact(h, w):
    x = np.random.default_rng(w).integers(0, 256, (h, w)).astype(np.float32)
    for _ in range(3):
        want = np.asarray(JT._down2(jnp.asarray(x)))
        got = TT.down2(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, want)
        x = want


def test_entry_points_default_to_the_card():
    """Numpy planes go to the card unless the caller asks for the CPU: with
    no CUDA device the default raises, as the encoders' does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    y = SERVO["sharp"]
    with pytest.raises(RuntimeError, match="cuda"):
        TT.frame_preprocessing(y)
    with pytest.raises(RuntimeError, match="cuda"):
        TT.motion_score(y, y)
    with pytest.raises(RuntimeError, match="cuda"):
        TT.vif_lite(y, y)
    t = torch.as_tensor(y.astype(np.float32))
    assert TT.vif_lite(t, t) == pytest.approx(1.0, abs=1e-6)
