"""Port parity end to end (see test_torch_encoder.py) on the other
part-path cases of test_tpu_encoder.py: 128x128 with BLOCK_32X32 at q100,
and 176x144 at q200 (mostly skipped blocks, decoder-forced edge splits).
Tolerance: byte-identical streams, exact planes."""
import numpy as np
import pytest

from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from test_torch_encoder import assert_decodes_to_recon, encode_both
from test_tpu_encoder import make_frame
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("w,h,q,bsz", [(128, 128, 100, 9),
                                       (176, 144, 200, 6)])
def test_stream_matches_jax(w, h, q, bsz):
    ref, want, enc, got = encode_both(
        make_frame(w, h, seed=w + q),
        EncoderConfig(base_q_idx=q, block_size=bsz))
    assert got == want
    assert (enc.fh.lf.filter_level, enc.fh.lf.filter_level_u,
            enc.fh.lf.filter_level_v) == (ref.fh.lf.filter_level,
                                          ref.fh.lf.filter_level_u,
                                          ref.fh.lf.filter_level_v)
    assert_decodes_to_recon(got, enc)
    for a, b in zip(enc.ref_planes_dev, ref.ref_planes_dev):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(enc.mi_skip, ref.mi_skip)
