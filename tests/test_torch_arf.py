"""Port parity of the ARF star-group GOP: ``encode_video_arf(device="cpu")``
of ``aom_av1_psy_tpu_torch`` gives the byte-identical packets of the JAX
``encode_video_tpu_arf`` (the KEY and every ARF temporally filtered by the
port's device filter, here through its plain versions), ``None`` in
``encs`` exactly where the reference has it, and a stream that decodes to
one display frame per source frame, each equal to the port's chain planes
in display order (the non-shown ARF shows nothing; its show_existing
packet shows the ARF's planes). The content is the reference's own
(``tests/test_tpu_inter.py:205-259``), 112x80.
Tolerance: exact equality (bytes, planes)."""
import numpy as np
import pytest

from aom_av1_psy_tpu.decoder.obu import Av1Decoder
from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.encoder.tpu_interframe import encode_video_tpu_arf
from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.encoder.tpu_interframe import (
    _ref_chain_planes, displayed_encoders, encode_video_arf)
from torch_threads import one_torch_thread  # noqa: F401


def noisy_still(n, seed, fx, fy, sigma, w=112, h=80):
    """A static sinusoid with fresh noise per frame (the reference tests'
    ARF content)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 100 + 50 * np.sin(xx / fx) * np.cos(yy / fy)
    frames = []
    for _ in range(n):
        y = np.clip(base + rng.normal(0, sigma, (h, w)), 0, 255) \
            .astype(np.uint8)
        frames.append(Frame(y, np.full((h // 2, w // 2), 118, np.uint8),
                            np.full((h // 2, w // 2), 132, np.uint8)))
    return frames


def assert_decodes_in_display_order(packets, encs, n_frames):
    dec = Av1Decoder()
    out = []
    for p in packets:
        out.extend(dec.decode_packet(p))
    shown = displayed_encoders(encs)
    assert len(out) == len(shown) == n_frames
    for i, (f, enc) in enumerate(zip(out, shown)):
        for name, d, r in zip("yuv", f.planes(), _ref_chain_planes(enc)):
            np.testing.assert_array_equal(
                r.numpy()[: d.shape[0], : d.shape[1]], d.astype(np.int32),
                err_msg=f"display frame {i} {name}")


def encode_both(frames, cfg, **kw):
    pj, ej = encode_video_tpu_arf(frames, cfg, **kw)
    pt, et = encode_video_arf([convert.from_jax(f) for f in frames],
                              convert.from_jax(cfg), device="cpu", **kw)
    return pj, ej, pt, et


@pytest.fixture(scope="module")
def star6():
    """6 frames, group 5: KEY, ARF, 4 middles, show_existing."""
    return encode_both(noisy_still(6, 31, 17.0, 13.0, 4),
                       EncoderConfig(base_q_idx=100), group=5)


@pytest.fixture(scope="module")
def tf_pair():
    """5 frames, group 4, q96, the ARF filtered at strength 2 and 0."""
    frames = noisy_still(5, 17, 19.0, 23.0, 5)
    cfg = EncoderConfig(base_q_idx=96)
    return {s: encode_both(frames, cfg, group=4, tf_strength=s)
            for s in (2, 0)}


def test_star_gop_matches_jax(star6):
    pj, ej, pt, et = star6
    assert len(pt) == 7
    assert pt == pj
    assert [e is None for e in et] == [e is None for e in ej]
    assert et[-1] is None and not et[1].show
    assert [e.fh.refresh_frame_flags for e in et[1:-1]] == \
        [e.fh.refresh_frame_flags for e in ej[1:-1]] == [2, 0, 0, 0, 0]
    for a, b in zip(_ref_chain_planes(et[1]), _ref_chain_planes(ej[1])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_star_gop_decodes_in_display_order(star6):
    pj, ej, pt, et = star6
    assert_decodes_in_display_order(pt, et, 6)


def test_star_gop_times_its_filters(star6):
    et = star6[3]
    assert et[0].tf_s > 0 and et[1].tf_s > 0
    assert all(getattr(e, "tf_s", None) is None for e in et[2:-1])


@pytest.mark.parametrize("strength", [2, 0])
def test_tf_strength_gop_matches_jax(tf_pair, strength):
    pj, ej, pt, et = tf_pair[strength]
    assert len(pt) == 6
    assert pt == pj
    assert [e is None for e in et] == [e is None for e in ej]
    assert_decodes_in_display_order(pt, et, 5)


def test_filter_shrinks_the_arf_as_the_reference_does(tf_pair):
    """The strength-2 filter makes a smaller ARF than strength 0, in both
    packages (the reference's test_temporal_filter_consumed_by_arf)."""
    assert len(tf_pair[2][2][1]) < len(tf_pair[0][2][1])
    assert len(tf_pair[2][0][1]) < len(tf_pair[0][0][1])
