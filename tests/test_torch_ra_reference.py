"""The psy random-access deployment's path (``encode_video_arf`` with the
encoder settings and GOP of ``benchmark/configs/ra-psy-q110.json``) held
to the benchmark's plain references on the CPU: a 128x96 scene of the
deployment's traffic, a KEY and two star groups of 4, at two seeds and
q 110 / 60.

- The KEY's and each ARF's temporally filtered source equal libaom's
  filter in float64 PyTorch (``benchmark/reference/temporal_filter``:
  ``filter_key``, ``filter_arf``).
- Every packet decodes with the frozen reference decoder
  (``benchmark/reference/av1``) to the program's in-loop reconstruction:
  the KEY, each middle and each show-existing header (the ARF it shows)
  to what they display, each ARF to the slot its header refreshes.

Tolerance: 0 px everywhere; the stream is integer and normative. The
file imports nothing of jax."""
import numpy as np
import pytest

from ra_chunk import config, gop, scene
from torch_threads import one_torch_thread  # noqa: F401

W, H, T, GROUP = 128, 96, 9, 4


def _planes(p) -> list:
    return [np.asarray(x, np.int64) for x in p]


def _recon(e, w: int, h: int) -> list:
    from benchmark.harness import check as C
    planes = getattr(e, "ref_planes_out", None)
    return C.crop(e.ref_planes_dev if planes is None else planes, w, h)


def _mismatch(a, b) -> int:
    from benchmark.harness import check as C
    return C.mismatch(_planes(a), _planes(b))


@pytest.mark.parametrize("q", [110, 60])
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_ra_chunk_equals_the_references(seed, q):
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import encode_video_arf
    from benchmark.reference import temporal_filter as RTF
    from benchmark.reference.av1.decoder.obu import Av1Decoder
    frames = scene(W, H, T, seed)
    kw = gop(group=GROUP)
    packets, encs = encode_video_arf(frames, config(q), **kw)
    src = [list(f.planes()) for f in frames]

    # the filtered sources: the KEY's span, then each group's ARF span
    key_q = max(8, q - kw["kf_q_offset"])
    assert _mismatch(encs[0].src.planes(),
                     RTF.filter_key(src, key_q, "cpu")) == 0
    arfs = [i for i, e in enumerate(encs)
            if e is not None and getattr(e, "show", True) is False]
    assert len(arfs) == 2
    for j, pos in enumerate(arfs):
        s_idx = 1 + GROUP * j
        centre = min(s_idx + GROUP, T) - 1
        lo, hi = max(s_idx, centre - 2), min(T, centre + 3)
        want = RTF.filter_arf(src[lo:hi], centre - lo, q, kw["tf_strength"],
                              "cpu")
        assert _mismatch(encs[pos].src.planes(), want) == 0, (j, lo, hi)

    # every packet through the reference decoder
    dec = Av1Decoder()
    shown, last_arf = 0, None
    for pos, (pkt, e) in enumerate(zip(packets, encs)):
        out = dec.decode_packet(pkt)
        if e is not None and getattr(e, "show", True) is False:
            assert not out
            slot = dec.fh.refresh_frame_flags.bit_length() - 1
            got = dec.ref_slots[slot]["frame"].planes()
            last_arf = _recon(e, W, H)
            assert _mismatch(got, last_arf) == 0, pos
            continue
        assert len(out) == 1, pos
        want = last_arf if e is None else _recon(e, W, H)
        assert _mismatch(out[0].planes(), want) == 0, pos
        shown += 1
    assert shown == T
