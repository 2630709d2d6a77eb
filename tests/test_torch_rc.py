"""Port parity of the rate-controlled GOP encodes: ``encode_video_cbr`` and
``encode_video_rc`` (``device="cpu"``) of ``aom_av1_psy_tpu_torch`` give
the byte-identical packets, the same per-frame ``qs`` and (CBR) the same
buffer trace as the JAX ``encode_video_tpu_cbr`` / ``encode_video_tpu_rc``,
and their streams decode to the port's reference chain. The content is the
reference's own (``tests/test_tpu_inter.py:149-289``) at 176x144, cut to 6
frames. Tolerance: exact equality (bytes, q, trace floats, planes)."""
import numpy as np
import pytest

from aom_av1_psy_tpu.encoder import tpu_interframe as JIF
from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.encoder import tpu_interframe as TIF
from test_torch_gop import assert_decodes_to_chain
from torch_threads import one_torch_thread  # noqa: F401

W, H, N = 176, 144, 6


def moving_object(n=N, w=W, h=H):
    """Structured moving content (test_rate_control_hits_target's)."""
    frames = []
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        y = (110 + 45 * np.sin((xx + 3 * i) / 37.0) * np.cos(yy / 29.0)
             + 30 * (((xx // 24) + (yy // 24) + i) % 2)).clip(0, 255)
        bx, by = 20 + 5 * i, 30 + 3 * i
        y[by : by + 40, bx : bx + 40] = 210 - 4 * i
        frames.append(Frame(y.astype(np.uint8),
                            np.full((h // 2, w // 2), 120, np.uint8),
                            np.full((h // 2, w // 2), 135, np.uint8)))
    return frames


def noisy_pan(n=N, w=W, h=H):
    """A noisy global pan (test_cbr_buffer_model's)."""
    rng = np.random.default_rng(8)
    pad = 80
    bg = (110 + 45 * np.sin(np.arange(w + pad) / 37.0)[None, :]
          * np.cos(np.arange(h + pad) / 29.0)[:, None]
          + rng.normal(0, 5, (h + pad, w + pad))).astype(np.float32)
    return [Frame(np.clip(bg[2 * i : 2 * i + h, 3 * i : 3 * i + w], 0,
                          255).astype(np.uint8),
                  np.full((h // 2, w // 2), 120, np.uint8),
                  np.full((h // 2, w // 2), 135, np.uint8))
            for i in range(n)]


def _port(frames):
    return [convert.from_jax(f) for f in frames]


@pytest.fixture(scope="module")
def rc():
    frames = moving_object()
    return (JIF.encode_video_tpu_rc(frames, 400_000, fps=30),
            TIF.encode_video_rc(_port(frames), 400_000, fps=30,
                                device="cpu"))


@pytest.fixture(scope="module")
def cbr():
    frames = noisy_pan()
    return (JIF.encode_video_tpu_cbr(frames, 220_000.0, fps=30.0),
            TIF.encode_video_cbr(_port(frames), 220_000.0, fps=30.0,
                                 device="cpu"))


def test_rc_gop_matches_jax(rc):
    (pj, ej, qj), (pt, et, qt) = rc
    assert pt == pj
    assert qt == qj
    assert len(set(qt)) > 1, qt
    assert [e is None for e in et] == [e is None for e in ej] == [False] * N


def test_rc_gop_decodes_to_port_chain(rc):
    _, (pt, et, _) = rc
    assert_decodes_to_chain(pt, et)


def test_cbr_gop_matches_jax(cbr):
    (pj, ej, qj, tj), (pt, et, qt, tt) = cbr
    assert pt == pj
    assert qt == qj
    assert tt == tj
    assert len(set(qt)) > 1, qt
    assert [e is None for e in et] == [e is None for e in ej] == [False] * N


def test_cbr_gop_decodes_to_port_chain(cbr):
    _, (pt, et, _, _) = cbr
    assert_decodes_to_chain(pt, et)


@pytest.mark.parametrize("qstep", [1.0, 4.0, 4.5, 100.0, 1000.0, 1828.0,
                                   1829.0, 1e6])
def test_qindex_for_qstep_matches_jax(qstep):
    assert TIF._qindex_for_qstep(qstep) == JIF._qindex_for_qstep(qstep)
