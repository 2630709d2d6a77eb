"""Port parity of the full-pel search: the plain version of kernel KE
(``aom_av1_psy_tpu_torch/ops/fullpel.py``, integer SSD) against the
reference's ``tpu_inter._fullpel_search`` (two float32 grouped
convolutions). Tolerance: exact equality of the picked offsets, including
flat blocks where every offset ties (lowest flat index wins) and a
255-valued block on a zero window, the largest score."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.encoder import tpu_inter as JI
from aom_av1_psy_tpu_torch.ops import fullpel as FP
from torch_threads import one_torch_thread  # noqa: F401

H, W = 112, 160
CROP_H, CROP_W = 106, 150


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _case(bw, seed):
    rng = np.random.default_rng(seed)
    plane = rng.integers(0, 256, (H, W)).astype(np.int32)
    plane[:48, :64] = 90                        # flat region: all ties
    plane[64:, 96:] = 0                         # zero region
    ny, nx = H // bw, W // bw
    B = ny * nx
    by = (bw * (np.arange(B) // nx)).astype(np.int32)
    bx = (bw * (np.arange(B) % nx)).astype(np.int32)
    src = np.stack([plane[y:y + bw, x:x + bw] for y, x in zip(by, bx)])
    # a shifted copy of the plane, so most blocks have a true match
    src = np.clip(np.roll(src, 1, axis=1) + rng.integers(-3, 4, src.shape),
                  0, 255).astype(np.int32)
    flat = np.flatnonzero((by < 48 - bw) & (bx < 64 - bw))
    src[flat] = 90
    zero = np.flatnonzero((by >= 64) & (bx >= 96))
    src[zero] = 255                             # the largest score
    return plane, src, by, bx, rng


def test_fullpel_bw8_static_origins_matches_jax():
    plane, src, by, bx, _ = _case(8, 1)
    want = JI._fullpel_search(jnp.asarray(src), jnp.asarray(plane), by, bx,
                              CROP_H, CROP_W, bw=8)
    got = FP.fullpel_search_plain(_t(src), _t(plane), _t(by), _t(bx),
                                  CROP_H, CROP_W, bw=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # flat blocks tie on every offset: the first one (dy = dx = -16) wins
    # unless the clamp at the frame edge repeats a better window
    assert (got[0].numpy() == -16).any()


@pytest.mark.parametrize("seed", [2, 3])
def test_fullpel_bw16_with_centres_matches_jax(seed):
    plane, src, by, bx, rng = _case(16, seed)
    cy = rng.integers(-32, 33, len(by)).astype(np.int32)
    cx = rng.integers(-32, 33, len(by)).astype(np.int32)
    want = JI._fullpel_search(jnp.asarray(src), jnp.asarray(plane),
                              jnp.asarray(by), jnp.asarray(bx), CROP_H,
                              CROP_W, bw=16, cy=jnp.asarray(cy),
                              cx=jnp.asarray(cx))
    got = FP.fullpel_search(_t(src), _t(plane), _t(by), _t(bx), CROP_H,
                            CROP_W, bw=16, cy=_t(cy), cx=_t(cx))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
