"""The port's inspection API (``decoder/inspect.py``,
``Av1Decoder.inspect()``, av1/decoder/inspection.h's role): the checks of
the reference's ``tests/test_inspect.py``, and every field equal to the
reference decoder's snapshot of the same packets.
Tolerance: exact equality."""
import dataclasses
import os

import numpy as np

from aom_av1_psy_tpu.decoder.obu import Av1Decoder as RefDecoder
from aom_av1_psy_tpu_torch.bitstream.containers import read_ivf
from aom_av1_psy_tpu_torch.decoder.obu import Av1Decoder

HERE = os.path.join(os.path.dirname(__file__), "golden", "streams")


def test_inspect_inter_stream():
    dec, ref = Av1Decoder(), RefDecoder()
    pkts = list(read_ivf(os.path.join(HERE, "resize_d12.ivf")))
    snaps = []
    for p in pkts[:2]:
        dec.decode_packet(p)
        ref.decode_packet(p)
        snaps.append(dec.inspect())
        want = dataclasses.asdict(ref.inspect())
        for k, v in dataclasses.asdict(snaps[-1]).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    insp0, insp1 = snaps
    assert insp0.frame_type == 0 and not insp0.is_inter.any()
    assert insp0.mode.shape == (insp0.mi_rows, insp0.mi_cols)
    assert insp1.frame_type == 1
    assert insp1.is_inter.any()
    # inter blocks carry their ref + mv; intra blocks carry modes
    inter_mask = insp1.is_inter.astype(bool)
    assert (insp1.ref_frame0[inter_mask] >= 1).all()
    assert np.abs(insp1.mv[inter_mask]).max() > 0
    assert insp1.base_q_idx > 0
    assert insp1.width == 107 and insp1.height == 80
