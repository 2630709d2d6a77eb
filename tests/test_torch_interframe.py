"""Port parity of the host inter encoder: ``encode_video`` of
``aom_av1_psy_tpu_torch.encoder.interframe`` (its motion search on CPU
tensors: the plain versions of kernels KJ and KL) against
``aom_av1_psy_tpu.encoder.interframe.encode_video`` on the reference's own
panning content (``tests/test_inter_encode.py``) at 64x64, q100: equal
packets and recons, and the port's decoder decodes the stream to the
recons; ``tpu_frame.encode_ivf`` against the reference's
``encode_ivf_tpu`` (the file's bytes) at 64x64.
Tolerance: exact equality (bytes and int32 planes)."""
import numpy as np
import pytest

from aom_av1_psy_tpu.encoder.frame import EncoderConfig as RefConfig
from aom_av1_psy_tpu.encoder.interframe import encode_video as ref_encode
from aom_av1_psy_tpu.encoder.tpu_frame import encode_ivf_tpu
from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.decoder.obu import Av1Decoder
from aom_av1_psy_tpu_torch.encoder import interframe as IF
from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder.tpu_frame import encode_ivf
from aom_av1_psy_tpu_torch.ops import convolve as C
from aom_av1_psy_tpu_torch.ops import mvsearch as MV
from aom_av1_psy_tpu_torch.utils import testframes
from test_inter_encode import panning_frames
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def gop():
    """(port packets, port recons, reference packets, reference recons)."""
    frames = panning_frames(64, 64, 2)
    cfg = RefConfig(base_q_idx=100)
    ref = ref_encode(frames, cfg)
    port = IF.encode_video([convert.from_jax(f) for f in frames],
                           convert.from_jax(cfg), device="cpu")
    return (*port, *ref)


def test_panning_frames_equal_the_reference_tests():
    for got, want in zip(testframes.panning_frames(96, 72, 3),
                         panning_frames(96, 72, 3)):
        for a, b in zip(got.planes(), want.planes(), strict=True):
            np.testing.assert_array_equal(a, b)


def test_packets_equal_reference(gop):
    pk, _, ref_pk, _ = gop
    assert len(pk) == 2 and pk == ref_pk


def test_recons_equal_reference(gop):
    _, rec, _, ref_rec = gop
    for a, b in zip(rec, ref_rec, strict=True):
        for p, q in zip(a, b, strict=True):
            np.testing.assert_array_equal(p, q)


def test_port_decoder_decodes_to_the_recons(gop):
    pk, rec, _, _ = gop
    dec = Av1Decoder()
    out = [f for p in pk for f in dec.decode_packet(p)]
    assert len(out) == len(rec)
    for f, r in zip(out, rec):
        for pi, name in enumerate("yuv"):
            got = getattr(f, name)
            np.testing.assert_array_equal(got, r[pi][:got.shape[0],
                                                     :got.shape[1]])


def test_cpu_run_launches_nothing():
    """``device="cpu"``: the motion search runs the plain versions, and no
    kernel is launched (a CUDA device would take KJ + 3 KL per block)."""
    n0 = (MV.KJ.launches, C.KL.launches)
    IF.encode_video(testframes.panning_frames(32, 32, 2),
                    EncoderConfig(base_q_idx=120), device="cpu")
    assert (MV.KJ.launches, C.KL.launches) == n0


def test_encode_ivf_equals_reference(tmp_path):
    frames = testframes.make_gop(64, 64, 2)
    encode_ivf(frames, EncoderConfig(base_q_idx=100),
               str(tmp_path / "port.ivf"), device="cpu")
    encode_ivf_tpu([Frame(*f.planes()) for f in frames],
                   RefConfig(base_q_idx=100), str(tmp_path / "ref.ivf"))
    assert (tmp_path / "port.ivf").read_bytes() == \
        (tmp_path / "ref.ivf").read_bytes()
