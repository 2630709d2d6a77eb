"""Port parity of the inter plan and the GOP at 160x112 q120 (the second
panning case of test_tpu_inter.py): ``plan_inter_frame`` of
``aom_av1_psy_tpu_torch`` is key-for-key equal to the reference's
(split32, mv8, levels, eobs, interp_filter, recon), both started from the
same JAX KEY frame (the port's through ``convert.chain_from_jax``); the
GOP's packets are byte-identical and decode to the port's chain.
Tolerance: exact equality. The fast-pan case is in
test_torch_inter_plan_cells.py."""
import numpy as np
import pytest

from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from test_torch_gop import (assert_decodes_to_chain, assert_same_frames,
                            assert_same_plan, encode_both,
                            plans_from_jax_key)
from test_tpu_inter import panning
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def frames():
    return panning(160, 112, 3, seed=160)


def test_plan_160x112_matches_jax_from_jax_key(frames):
    want, got = plans_from_jax_key(frames, 120)
    assert_same_plan(want, got)
    assert got["mv8"].shape == (2 * 4, 2 * 5, 2)
    assert np.abs(got["mv8"]).max() > 0          # the pan was found


def test_gop_160x112_matches_jax(frames):
    pj, ej, pt, et = encode_both(frames, EncoderConfig(base_q_idx=120))
    assert pt == pj
    assert_same_frames(ej, et)
    assert_decodes_to_chain(pt, et)
