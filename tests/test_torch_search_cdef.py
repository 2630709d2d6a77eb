"""Port parity of the KEY-frame CDEF strength search (``search_cdef``):
``GpuFrameEncoder(device="cpu")`` picks the reference's strengths and
gives its byte-identical stream on a partition-path frame (search on the
post-LPF recon, then the reference chain made post-CDEF on the device,
ungated) and on a uniform-grid frame (the host loop-filter ladder first).
The partition-path stream decodes to the port's post-LPF, post-CDEF
planes. Tolerance: exact equality."""
import numpy as np

from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from test_torch_encoder import assert_decodes_to_recon, encode_both
from test_torch_gop import edges
from test_tpu_encoder import make_frame
from torch_threads import one_torch_thread  # noqa: F401


def strengths(enc):
    c = enc.fh.cdef
    return c.y_pri, c.y_sec, c.uv_pri, c.uv_sec, c.damping


def test_search_cdef_partition_path_matches_jax():
    ref, want, enc, got = encode_both(
        edges(96, 64, 1, seed=3)[0], EncoderConfig(base_q_idx=160,
                                                   search_cdef=True))
    assert enc.use_part and enc.seq.enable_cdef
    assert got == want
    assert strengths(enc) == strengths(ref)
    assert enc.fh.cdef.y_pri[0] + enc.fh.cdef.y_sec[0] > 0
    for a, b in zip(enc.ref_planes_dev, ref.ref_planes_dev):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert_decodes_to_recon(got, enc)


def test_search_cdef_uniform_grid_matches_jax():
    ref, want, enc, got = encode_both(
        make_frame(178, 130, seed=21), EncoderConfig(base_q_idx=180,
                                                     search_cdef=True))
    assert not enc.use_part and enc.seq.enable_cdef
    assert got == want
    assert strengths(enc) == strengths(ref)
    assert (enc.fh.lf.filter_level, enc.fh.lf.filter_level_u,
            enc.fh.lf.filter_level_v) == (ref.fh.lf.filter_level,
                                          ref.fh.lf.filter_level_u,
                                          ref.fh.lf.filter_level_v)
