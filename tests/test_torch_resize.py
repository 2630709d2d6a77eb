"""The port's ``ops/resize.py`` (superres upscale_normative_rect,
av1_resize_plane) against the golden cases of the reference's
``tests/test_resize.py`` and against the reference module on the same
inputs.
Tolerance: exact equality."""
import os

import numpy as np
import pytest

from aom_av1_psy_tpu.ops import resize as RRZ
from aom_av1_psy_tpu_torch.ops import resize as RZ

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "golden_resize.npz")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def test_superres_upscale_all(golden):
    n = 0
    for key in sorted(golden):
        if not (key.startswith("sr_") and key.endswith("_out")):
            continue
        _, uw, denom, _ = key.split("_")
        uw = int(uw)
        src = golden[key[:-4] + "_src"].astype(np.int64)
        got = RZ.upscale_normative_plane(src, uw)
        np.testing.assert_array_equal(got, golden[key].astype(np.int64),
                                      err_msg=key)
        np.testing.assert_array_equal(
            got, RRZ.upscale_normative_plane(src, uw), err_msg=key)
        n += 1
    assert n == 24


def test_resize_plane_all(golden):
    n = 0
    for key in sorted(golden):
        if not (key.startswith("rz_") and key.endswith("_out")):
            continue
        out_h, out_w = golden[key].shape
        src = golden[key[:-4] + "_src"].astype(np.int64)
        got = RZ.resize_plane(src, out_h, out_w)
        np.testing.assert_array_equal(got, golden[key].astype(np.int64),
                                      err_msg=key)
        np.testing.assert_array_equal(
            got, RRZ.resize_plane(src, out_h, out_w), err_msg=key)
        n += 1
    assert n == 4


def test_scaled_size():
    # denominator range 9..16, numerator 8 (spec 5.9.8)
    assert RZ.superres_scaled_size(128, 16) == 64
    assert RZ.superres_scaled_size(1920, 12) == 1280
    for uw in range(16, 400, 7):
        for d in range(9, 17):
            assert RZ.superres_scaled_size(uw, d) == \
                RRZ.superres_scaled_size(uw, d)


@pytest.mark.parametrize("out_w", [67, 100, 190])
def test_upscale_equals_the_reference_on_random_planes(out_w):
    rng = np.random.default_rng(out_w)
    for d in range(9, 17):
        src = rng.integers(0, 256, (6, RZ.superres_scaled_size(out_w, d)))
        np.testing.assert_array_equal(
            RZ.upscale_normative_plane(src, out_w),
            RRZ.upscale_normative_plane(src, out_w), err_msg=f"denom {d}")
