"""Port parity: the device loop filter of ``aom_av1_psy_tpu_torch``
(``deblock_plane_fused``, ``lpf_pick_and_filter``, ``lpf_apply`` and the
plain version of kernel KC) against ``deblock_jax``. The ladder runs on the
recon planes and split maps of the part-path plans of test_tpu_encoder.py
(the port's plans, which test_torch_wavefront*.py prove equal to the JAX
ones). Tolerance: exact equality of planes and picked levels; the port sums
each level's error exactly in int64 where the reference sums in float32."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aom_av1_psy_tpu.ops import deblock_jax as DJ
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
from aom_av1_psy_tpu_torch.ops import deblock_torch as DT
from test_tpu_encoder import make_frame
from torch_threads import one_torch_thread  # noqa: F401

CASES = [(96, 64, 60, 6), (128, 128, 100, 9), (176, 144, 200, 6)]


@functools.cache
def _plan(w, h, q, bsz):
    enc = GpuFrameEncoder(convert.from_jax(make_frame(w, h, seed=w + q)),
                          EncoderConfig(base_q_idx=q, block_size=bsz),
                          device="cpu")
    enc.encode()
    return enc


def _ladder(g):
    return np.array([0, g // 2, max(g - 2, 0), g, min(g + 2, 63),
                     min(g * 2, 63)], np.int32)


@pytest.mark.parametrize("w,h,q,bsz", CASES)
@pytest.mark.parametrize("guess", [None, 40])
def test_lpf_pick_and_filter_matches_jax(w, h, q, bsz, guess):
    enc = _plan(w, h, q, bsz)
    seq, fh = enc.make_headers()
    cands = _ladder(fh.lf.filter_level[0] if guess is None else guess)
    split16 = enc._split16_frame()
    recs = [r.numpy() for r in enc.plan["recon_dev"]]
    pw, ph = enc.mi_cols * 4, enc.mi_rows * 4
    lv_j, out_j = DJ.lpf_pick_and_filter(
        tuple(jnp.asarray(r) for r in recs),
        tuple(jnp.asarray(s) for s in enc.srcp), jnp.asarray(split16),
        cands, w=pw, h=ph, nplanes=3)
    lv_t, out_t = DT.lpf_pick_and_filter(
        tuple(torch.as_tensor(r) for r in recs),
        tuple(convert.plane(s, "cpu") for s in enc.srcp),
        torch.as_tensor(split16), torch.as_tensor(cands), w=pw, h=ph,
        nplanes=3)
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the encoder's own pick went through the same path
    if guess is None:
        assert [fh_l for fh_l in (enc.fh.lf.filter_level[0],
                                  enc.fh.lf.filter_level_u,
                                  enc.fh.lf.filter_level_v)] == \
            [int(x) for x in np.asarray(lv_j)]


@pytest.mark.parametrize("w,h,q,bsz", CASES)
def test_lpf_apply_matches_jax(w, h, q, bsz):
    enc = _plan(w, h, q, bsz)
    split16 = enc._split16_frame()
    recs = [r.numpy() for r in enc.plan["recon_dev"]]
    pw, ph = enc.mi_cols * 4, enc.mi_rows * 4
    levels = np.array([20, 9, 33], np.int32)
    want = DJ.lpf_apply(tuple(jnp.asarray(r) for r in recs),
                        jnp.asarray(split16), jnp.asarray(levels), w=pw,
                        h=ph, nplanes=3)
    got = DT.lpf_apply(tuple(torch.as_tensor(r) for r in recs),
                       torch.as_tensor(split16), torch.as_tensor(levels),
                       w=pw, h=ph, nplanes=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("w,h,lvl,luma,seed", [
    (352, 288, 14, True, 0), (176, 144, 63, True, 1), (192, 160, 7, True, 2),
    (352, 288, 20, False, 3), (176, 144, 44, False, 4)])
def test_deblock_plane_fused_matches_jax(w, h, lvl, luma, seed):
    rng = np.random.default_rng(seed)
    pw, ph = (w + 31) // 32 * 32, (h + 31) // 32 * 32
    split32 = rng.integers(0, 2, (ph // 32, pw // 32)).astype(bool)
    split16 = np.repeat(np.repeat(split32, 2, 0), 2, 1)
    cell = 16 if luma else 8
    if not luma:
        pw, ph, w, h = pw // 2, ph // 2, w // 2, h // 2
    buf = rng.integers(0, 256, (ph, pw)).astype(np.int32)
    buf[:, ::cell] = buf[:, 1::cell] = 128     # flat runs: long filters fire
    want = DJ.deblock_plane_fused(jnp.asarray(buf), jnp.asarray(split16),
                                  lvl, lvl, cell=cell, w=w, h=h, luma=luma)
    got = DT.deblock_plane_fused(torch.as_tensor(buf),
                                 torch.as_tensor(split16), lvl, lvl,
                                 cell=cell, w=w, h=h, luma=luma)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ladder_sse_is_exact_int64():
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 256, (64, 96)).astype(np.int32)
    src = rng.integers(0, 256, (64, 96)).astype(np.int32)
    split16 = rng.random((4, 6)) < .5
    cands = torch.tensor([0, 5, 30], dtype=torch.int32)
    outs, sse = DT.lpf_ladder(torch.as_tensor(buf), torch.as_tensor(split16),
                              cands, torch.as_tensor(src), 90, 60, 16, True)
    assert sse.dtype == torch.int64
    d = outs.numpy()[:, :60, :90].astype(np.int64) - src[:60, :90]
    np.testing.assert_array_equal(sse.numpy(), (d * d).sum((1, 2)))
    np.testing.assert_array_equal(outs.numpy()[0], buf)     # level 0

